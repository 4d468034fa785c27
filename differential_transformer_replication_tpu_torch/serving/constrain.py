"""Constraint compiler for structured decoding (a copy of the JAX
package's serving/constrain.py, which imports no JAX; only the fault
module is the port's).

A request's ``json_schema``, ``regex`` or ``choices`` is compiled ONCE
into a token-level finite-state machine (Willard & Louf 2023,
"Efficient Guided Generation for Large Language Models"):

- ``masks``:  (S, V) bool — ``masks[s, t]`` = emitting token ``t`` in
  state ``s`` keeps the output a prefix of the constrained language;
- ``trans``:  (S, V) int32 — the state after emitting ``t`` in ``s``
  (-1 where disallowed);
- ``accepting``: (S,) bool — states where the constraint is satisfied
  (the request's EOS token, when configured, is allowed exactly here).

The engine (serving/engine.py) reads one mask row per constrained slot
per step and applies it in the logit pipeline
(models/decode.py:``apply_logit_pipeline``), and advances the cursor
with one ``trans[s, t]`` read per emitted token.

Three constraint families compile to the same FSM: a small
dependency-free **regex** engine (literals, classes with ranges and
negation, ``.``, ``* + ?``, bounded repeats, alternation, groups, the
``\\d \\w \\s`` escapes; Thompson NFA, then subset construction), a
**JSON Schema** subset lowered to a regex over the canonical compact
serialization, and **choices** (an escaped-literal alternation). Dead
states are pruned, so a well-formed constraint never dead-ends
naturally: an all-zero mask row only comes from the
``constrain_dead_end`` fault, and the engine retires it typed.

:class:`ConstraintCache` refcounts compiled FSMs across concurrent
requests as the radix prefix cache refcounts KV pages — same spec and
same EOS share one table set, byte-accounted, LRU-evicted only at
refcount 0 — and owns a lock (the engine thread acquires and releases
while /health readers call :meth:`ConstraintCache.stats`).
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from differential_transformer_replication_tpu_torch.utils import faults


class ConstraintCompileError(ValueError):
    """The constraint spec cannot be compiled (malformed regex,
    unsupported schema construct, empty language, vocabulary that
    cannot spell the constraint). A ValueError so every submit-path
    funnel (HTTP 400, engine submit) treats it as caller error; typed
    so serving/server.py can attach the machine-readable
    ``constraint_compile_failed`` code. The engine is untouched: a
    failed compile happens before the scheduler ever sees the
    request."""


class ConstraintDeadEndError(RuntimeError):
    """A constrained request reached an FSM state with an all-zero
    token mask mid-generation: nothing it could emit would keep the
    output inside the constrained language. RETRIABLE (a fresh seed or
    a fixed constraint may complete); ``output`` carries the partial
    :class:`~.request.RequestOutput` (``finish_reason ==
    "constraint_dead_end"``). The engine retires the slot — pages and
    KV rows reclaimed through the standard retire path — and the
    server maps this to HTTP 400 ``constraint_dead_end`` with the
    partial tokens, never a hang or a garbage token."""

    retriable = True

    def __init__(self, message: str, output=None):
        super().__init__(message)
        self.output = output


# ---------------------------------------------------------------------
# regex -> char-level NFA (Thompson construction) -> DFA (subset)
# ---------------------------------------------------------------------

_EPS = None  # epsilon edge label


class _Nfa:
    """Fragment with one start state and one accept state. States are
    integers into ``edges``: state -> list of (label, target) where
    label is a frozenset of chars or _EPS."""

    def __init__(self):
        self.edges: List[List[Tuple[Optional[frozenset], int]]] = []

    def state(self) -> int:
        self.edges.append([])
        return len(self.edges) - 1

    def edge(self, src: int, label, dst: int) -> None:
        self.edges[src].append((label, dst))


_CLASS_ESCAPES = {
    "d": frozenset("0123456789"),
    "w": frozenset(
        "abcdefghijklmnopqrstuvwxyz"
        "ABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_"
    ),
    "s": frozenset(" \t\n\r\f\v"),
}

# "." and negated classes need a concrete universe; printable ASCII +
# whitespace covers every tokenizer this repo ships (byte-level BPE
# over TinyStories) and every JSON/regex constraint a test can pose
_UNIVERSE = frozenset(chr(c) for c in range(32, 127)) | frozenset("\t\n\r")


class _RegexParser:
    """Recursive-descent parser producing an NFA fragment. Grammar:

    alt     := concat ('|' concat)*
    concat  := repeat*
    repeat  := atom ('*' | '+' | '?' | '{m}' | '{m,n}')?
    atom    := literal | escape | '.' | class | '(' alt ')'
    """

    def __init__(self, pattern: str):
        self.p = pattern
        self.i = 0
        self.nfa = _Nfa()

    def parse(self) -> Tuple[_Nfa, int, int]:
        start, end = self._alt()
        if self.i != len(self.p):
            raise ConstraintCompileError(
                f"regex parse error at position {self.i} in {self.p!r}"
            )
        return self.nfa, start, end

    # -- helpers ------------------------------------------------------

    def _peek(self) -> Optional[str]:
        return self.p[self.i] if self.i < len(self.p) else None

    def _take(self) -> str:
        ch = self._peek()
        if ch is None:
            raise ConstraintCompileError(
                f"unexpected end of regex {self.p!r}"
            )
        self.i += 1
        return ch

    # -- productions --------------------------------------------------

    def _alt(self) -> Tuple[int, int]:
        frags = [self._concat()]
        while self._peek() == "|":
            self._take()
            frags.append(self._concat())
        if len(frags) == 1:
            return frags[0]
        s, e = self.nfa.state(), self.nfa.state()
        for fs, fe in frags:
            self.nfa.edge(s, _EPS, fs)
            self.nfa.edge(fe, _EPS, e)
        return s, e

    def _concat(self) -> Tuple[int, int]:
        start = prev_end = None
        while self._peek() is not None and self._peek() not in "|)":
            fs, fe = self._repeat()
            if start is None:
                start, prev_end = fs, fe
            else:
                self.nfa.edge(prev_end, _EPS, fs)
                prev_end = fe
        if start is None:  # empty branch: epsilon fragment
            s = self.nfa.state()
            return s, s
        return start, prev_end

    def _repeat(self) -> Tuple[int, int]:
        frag_start = self.i
        fs, fe = self._atom()
        op = self._peek()
        if op == "*" or op == "+":
            self._take()
            s, e = self.nfa.state(), self.nfa.state()
            self.nfa.edge(s, _EPS, fs)
            self.nfa.edge(fe, _EPS, fs)
            self.nfa.edge(fe, _EPS, e)
            if op == "*":
                self.nfa.edge(s, _EPS, e)
            return s, e
        if op == "?":
            self._take()
            s, e = self.nfa.state(), self.nfa.state()
            self.nfa.edge(s, _EPS, fs)
            self.nfa.edge(fe, _EPS, e)
            self.nfa.edge(s, _EPS, e)
            return s, e
        if op == "{":
            atom_src = self.p[frag_start:self.i]
            self._take()
            spec = ""
            while self._peek() not in ("}", None):
                spec += self._take()
            if self._peek() is None:
                raise ConstraintCompileError(
                    f"unterminated {{m,n}} in {self.p!r}"
                )
            self._take()
            lo, _, hi = spec.partition(",")
            try:
                m = int(lo)
                n = m if not _ else (int(hi) if hi else None)
            except ValueError:
                raise ConstraintCompileError(
                    f"bad repeat spec {{{spec}}} in {self.p!r}"
                ) from None
            if n is None:  # {m,} == atom{m} atom*
                expanded = atom_src * m + atom_src + "*"
            else:
                if n < m:
                    raise ConstraintCompileError(
                        f"bad repeat bounds {{{spec}}} in {self.p!r}"
                    )
                expanded = atom_src * m + (atom_src + "?") * (n - m)
            sub = _RegexParser(expanded)
            sub.nfa = self.nfa
            sub_s, sub_e = sub._alt()
            if sub.i != len(expanded):
                raise ConstraintCompileError(
                    f"regex parse error expanding {{{spec}}} in "
                    f"{self.p!r}"
                )
            return sub_s, sub_e
        return fs, fe

    def _atom(self) -> Tuple[int, int]:
        ch = self._take()
        if ch == "(":
            fs, fe = self._alt()
            if self._peek() != ")":
                raise ConstraintCompileError(
                    f"unbalanced '(' in {self.p!r}"
                )
            self._take()
            return fs, fe
        if ch == "[":
            return self._char_class()
        if ch == ".":
            return self._label(_UNIVERSE)
        if ch == "\\":
            return self._label(self._escape_set(self._take()))
        if ch in "*+?{":
            raise ConstraintCompileError(
                f"dangling quantifier {ch!r} in {self.p!r}"
            )
        if ch in ")|":
            raise ConstraintCompileError(
                f"unexpected {ch!r} in {self.p!r}"
            )
        return self._label(frozenset(ch))

    def _escape_set(self, ch: str) -> frozenset:
        if ch in _CLASS_ESCAPES:
            return _CLASS_ESCAPES[ch]
        if ch == "n":
            return frozenset("\n")
        if ch == "t":
            return frozenset("\t")
        if ch == "r":
            return frozenset("\r")
        return frozenset(ch)  # \. \\ \[ \{ \" ...

    def _char_class(self) -> Tuple[int, int]:
        negate = self._peek() == "^"
        if negate:
            self._take()
        chars: set = set()
        first = True
        while True:
            ch = self._peek()
            if ch is None:
                raise ConstraintCompileError(
                    f"unterminated '[' in {self.p!r}"
                )
            if ch == "]" and not first:
                self._take()
                break
            first = False
            self._take()
            if ch == "\\":
                chars |= self._escape_set(self._take())
                continue
            if self._peek() == "-" and self.i + 1 < len(self.p) \
                    and self.p[self.i + 1] != "]":
                self._take()
                hi = self._take()
                if hi == "\\":
                    hi = self._take()
                if ord(hi) < ord(ch):
                    raise ConstraintCompileError(
                        f"bad range {ch}-{hi} in {self.p!r}"
                    )
                chars |= {chr(c) for c in range(ord(ch), ord(hi) + 1)}
            else:
                chars.add(ch)
        label = (
            _UNIVERSE - frozenset(chars) if negate else frozenset(chars)
        )
        return self._label(label)

    def _label(self, chars: frozenset) -> Tuple[int, int]:
        s, e = self.nfa.state(), self.nfa.state()
        self.nfa.edge(s, chars, e)
        return s, e


class CharDfa:
    """Char-level DFA: ``step[state].get(ch)`` -> next state;
    ``accepting`` is a set of state indices; state 0 is the start."""

    def __init__(self, step: List[Dict[str, int]], accepting: set):
        self.step = step
        self.accepting = accepting

    def matches(self, text: str) -> bool:
        s = 0
        for ch in text:
            s = self.step[s].get(ch, -1)
            if s < 0:
                return False
        return s in self.accepting


def compile_regex(pattern: str) -> CharDfa:
    """Regex -> char DFA via Thompson NFA + subset construction, with
    unreachable/dead states never materialized (subset construction
    only visits reachable sets; dead-state trimming happens at the
    token-FSM level where acceptance-reachability is decided)."""
    nfa, start, end = _RegexParser(pattern).parse()

    def _closure(states: frozenset) -> frozenset:
        stack, seen = list(states), set(states)
        while stack:
            s = stack.pop()
            for label, dst in nfa.edges[s]:
                if label is _EPS and dst not in seen:
                    seen.add(dst)
                    stack.append(dst)
        return frozenset(seen)

    start_set = _closure(frozenset([start]))
    index = {start_set: 0}
    worklist = [start_set]
    step: List[Dict[str, int]] = [{}]
    accepting: set = set()
    if end in start_set:
        accepting.add(0)
    while worklist:
        cur = worklist.pop()
        ci = index[cur]
        by_char: Dict[str, set] = {}
        for s in cur:
            for label, dst in nfa.edges[s]:
                if label is _EPS:
                    continue
                for ch in label:
                    by_char.setdefault(ch, set()).add(dst)
        for ch, dsts in by_char.items():
            nxt = _closure(frozenset(dsts))
            ni = index.get(nxt)
            if ni is None:
                ni = len(step)
                index[nxt] = ni
                step.append({})
                worklist.append(nxt)
                if end in nxt:
                    accepting.add(ni)
            step[ci][ch] = ni
    return CharDfa(step, accepting)


# ---------------------------------------------------------------------
# JSON Schema (subset) -> regex over the canonical compact serialization
# ---------------------------------------------------------------------

_REGEX_SPECIALS = set(".^$*+?{}[]()|\\/")


def _lit(text: str) -> str:
    """Escape a literal string for the regex engine above."""
    return "".join(
        ("\\" + ch) if ch in _REGEX_SPECIALS else ch for ch in text
    )

# escape-free JSON string body: any printable char except '"' and '\'
_STR_BODY = '[^"\\\\]*'
_INT = "-?(0|[1-9]\\d*)"
_NUMBER = _INT + "(\\.\\d+)?([eE][-+]?\\d+)?"


def schema_to_regex(schema) -> str:
    """Lower a JSON-Schema subset to a regex over canonical compact
    JSON (no whitespace; object properties in declared order, all
    treated as required). Unsupported constructs fail typed — a
    constraint that silently under-constrains would defeat the whole
    guarantee."""
    if not isinstance(schema, dict):
        raise ConstraintCompileError(
            f"json_schema must be an object, got {type(schema).__name__}"
        )
    if "const" in schema:
        return _lit(json.dumps(schema["const"], separators=(",", ":")))
    if "enum" in schema:
        vals = schema["enum"]
        if not isinstance(vals, list) or not vals:
            raise ConstraintCompileError("enum must be a non-empty list")
        return (
            "("
            + "|".join(
                _lit(json.dumps(v, separators=(",", ":"))) for v in vals
            )
            + ")"
        )
    t = schema.get("type")
    if t == "string":
        return '"' + schema_string_body(schema) + '"'
    if t == "integer":
        return _INT
    if t == "number":
        return _NUMBER
    if t == "boolean":
        return "(true|false)"
    if t == "null":
        return "null"
    if t == "object":
        props = schema.get("properties", {})
        if not isinstance(props, dict):
            raise ConstraintCompileError("properties must be an object")
        if not props:
            return "\\{\\}"
        parts = [
            '"' + _lit(name) + '":' + schema_to_regex(sub)
            for name, sub in props.items()
        ]
        return "\\{" + ",".join(parts) + "\\}"
    if t == "array":
        items = schema.get("items")
        if items is None:
            raise ConstraintCompileError(
                "array schemas need 'items' (unbounded heterogeneous "
                "arrays are not supported)"
            )
        item = schema_to_regex(items)
        return "\\[((" + item + ")(,(" + item + "))*)?\\]"
    raise ConstraintCompileError(
        f"unsupported json_schema construct: {schema!r} (supported: "
        "const, enum, string, integer, number, boolean, null, object "
        "with properties, array with items)"
    )


def schema_string_body(schema: dict) -> str:
    """The regex for a JSON string's BODY (between the quotes):
    escape-free printable chars, optionally bounded by
    min/maxLength."""
    lo = schema.get("minLength", 0)
    hi = schema.get("maxLength")
    if hi is None and lo == 0:
        return _STR_BODY
    if hi is None:
        return '[^"\\\\]{%d,}' % lo
    return '[^"\\\\]{%d,%d}' % (lo, hi)


# ---------------------------------------------------------------------
# char DFA -> token-level FSM over a concrete vocabulary
# ---------------------------------------------------------------------


class TokenFsm:
    """The per-constraint tables the engine's hot path reads.

    ``masks[s]`` is the (V,) bool row of tokens allowed in state ``s``
    (the EOS column is set exactly on accepting states when an EOS id
    was compiled in); ``trans[s, t]`` the successor state (-1 where
    disallowed; EOS has no successor — the engine finishes on EOS
    before advancing). ``start`` is always 0. ``nbytes`` feeds the
    cache's byte accounting."""

    def __init__(self, masks: np.ndarray, trans: np.ndarray,
                 accepting: np.ndarray, eos_token_id: Optional[int]):
        self.masks = masks
        self.trans = trans
        self.accepting = accepting
        self.eos_token_id = eos_token_id
        self.start = 0
        self.n_states = int(masks.shape[0])
        self.nbytes = masks.nbytes + trans.nbytes + accepting.nbytes

    def allowed_row(self, state: int) -> np.ndarray:
        """Mask row for ``state``; all-zero for the dead-end sentinel
        (state < 0 — only the ``constrain_dead_end`` fault plants
        it)."""
        if state < 0:
            return np.zeros((self.masks.shape[1],), bool)
        return self.masks[state]

    def advance(self, state: int, token: int) -> int:
        """Successor state after emitting ``token`` (-1 when the
        token was not allowed — unreachable when the mask was applied,
        kept defensive)."""
        if state < 0:
            return -1
        return int(self.trans[state, token])

    def is_accepting(self, state: int) -> bool:
        return state >= 0 and bool(self.accepting[state])

    def walk(self, tokens: Sequence[int]) -> int:
        """Host-side multi-token advance (drafter filtering, output
        validation): returns the state after consuming ``tokens``, or
        -1 at the first disallowed one."""
        s = self.start
        for t in tokens:
            if s < 0:
                return -1
            s = int(self.trans[s, t])
        return s

    def prefix_len(self, tokens: Sequence[int],
                   state: Optional[int] = None) -> int:
        """How many leading ``tokens`` stay inside the language —
        the drafter-proposal truncation point. ``state`` starts the
        walk mid-stream (a slot's current FSM cursor); default the
        start state."""
        s = self.start if state is None else state
        for i, t in enumerate(tokens):
            nxt = int(self.trans[s, t]) if s >= 0 else -1
            if nxt < 0:
                return i
            s = nxt
        return len(tokens)

    def matches(self, tokens: Sequence[int]) -> bool:
        """Whether ``tokens`` (EOS stripped by the caller) lands on an
        accepting state — the bench's schema-validity oracle."""
        s = self.walk(tokens)
        return self.is_accepting(s)


def build_token_fsm(dfa: CharDfa, vocab: Sequence[str],
                    eos_token_id: Optional[int]) -> TokenFsm:
    """Char DFA -> token FSM (Willard & Louf 2023, their Algorithms
    3/4 in spirit): from every LIVE char state, walk each vocabulary
    token's string; tokens whose every char transition exists are
    allowed and map to the end state. Dead char states (no path to an
    accepting state) are pruned first so the token FSM cannot
    dead-end naturally; the empty language fails typed here."""
    n = len(dfa.step)
    # liveness: reverse-reachability from accepting states
    rev: List[set] = [set() for _ in range(n)]
    for s, edges in enumerate(dfa.step):
        for dst in edges.values():
            rev[dst].add(s)
    live = set(dfa.accepting)
    stack = list(live)
    while stack:
        s = stack.pop()
        for p in rev[s]:
            if p not in live:
                live.add(p)
                stack.append(p)
    if 0 not in live:
        raise ConstraintCompileError(
            "constraint matches nothing (empty language)"
        )
    # renumber live states; char start becomes token-FSM state 0
    order = [0] + sorted(s for s in live if s != 0)
    renum = {s: i for i, s in enumerate(order)}
    S, V = len(order), len(vocab)
    masks = np.zeros((S, V), bool)
    trans = np.full((S, V), -1, np.int32)
    accepting = np.zeros((S,), bool)
    for old, new in renum.items():
        if old in dfa.accepting:
            accepting[new] = True
    # token walks, memoized per (state, token) via per-state char walk
    for old, new in renum.items():
        for tid, text in enumerate(vocab):
            if not text:
                continue  # empty-string tokens can never advance
            s = old
            ok = True
            for ch in text:
                s = dfa.step[s].get(ch, -1)
                if s < 0 or s not in live:
                    ok = False
                    break
            if ok:
                masks[new, tid] = True
                trans[new, tid] = renum[s]
    if eos_token_id is not None:
        if not 0 <= eos_token_id < V:
            raise ConstraintCompileError(
                f"eos_token_id {eos_token_id} outside vocab ({V})"
            )
        masks[accepting, eos_token_id] = True
        trans[accepting, eos_token_id] = -1  # EOS ends the request
    if not masks[0].any():
        raise ConstraintCompileError(
            "vocabulary cannot spell the constraint (no token is "
            "allowed in the start state)"
        )
    return TokenFsm(masks, trans, accepting, eos_token_id)


# ---------------------------------------------------------------------
# the per-request entry point + the refcounted compile cache
# ---------------------------------------------------------------------


def spec_key(params, eos_token_id: Optional[int]) -> Optional[tuple]:
    """Canonical cache key for a request's constraint, or None when it
    is unconstrained. Exactly one of json_schema/regex/choices may be
    set (SamplingParams validates); the EOS id is part of the key
    because it lands in the masks."""
    if params.json_schema is not None:
        return ("json_schema", params.json_schema, eos_token_id)
    if params.regex is not None:
        return ("regex", params.regex, eos_token_id)
    if params.choices is not None:
        return ("choices", params.choices, eos_token_id)
    return None


def compile_constraint(key: tuple, vocab: Sequence[str]) -> TokenFsm:
    """Compile one canonical constraint key against a vocabulary.
    The ``constrain_compile_fail`` fault point fires here (call-
    counted, utils/faults.py) as a typed compile error — the injected
    stand-in for a malformed schema reaching a production submit."""
    try:
        faults.check("constrain_compile_fail")
    except faults.FaultInjected as e:
        raise ConstraintCompileError(
            f"injected constraint compile failure: {e}"
        ) from e
    kind, spec, eos = key
    if kind == "json_schema":
        try:
            schema = json.loads(spec)
        except json.JSONDecodeError as e:
            raise ConstraintCompileError(
                f"json_schema is not valid JSON: {e}"
            ) from e
        pattern = schema_to_regex(schema)
    elif kind == "regex":
        pattern = spec
    elif kind == "choices":
        pattern = "(" + "|".join(_lit(c) for c in spec) + ")"
    else:  # pragma: no cover - spec_key is the only producer
        raise ConstraintCompileError(f"unknown constraint kind {kind!r}")
    return build_token_fsm(compile_regex(pattern), vocab, eos)


class _Entry:
    __slots__ = ("fsm", "refs", "last_use")

    def __init__(self, fsm: TokenFsm, clock: int):
        self.fsm = fsm
        self.refs = 0
        self.last_use = clock


class ConstraintCache:
    """Refcounted, LRU-evicting, byte-accounted compile cache.

    The radix prefix cache's discipline applied to FSM tables: N
    concurrent requests with the same schema share ONE compile
    (refs = N); entries at refcount 0 survive as LRU cache until
    ``max_entries`` forces eviction, so a burst of identical
    tool-calling requests compiles once ever. All mutable state is
    guarded by ``self._lock`` (GL301): the engine thread acquires/
    releases while /health and /metrics readers call :meth:`stats`.
    """

    def __init__(self, max_entries: int = 32):
        if max_entries < 1:
            raise ValueError(
                f"max_entries must be >= 1, got {max_entries}"
            )
        self.max_entries = max_entries
        self._lock = threading.Lock()
        self._entries: Dict[tuple, _Entry] = {}
        self._clock = 0
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def acquire(self, key: tuple, vocab: Sequence[str]) -> TokenFsm:
        """Return the compiled FSM for ``key``, compiling on miss;
        the caller owns one reference until :meth:`release`. The
        compile itself runs OUTSIDE the lock (GL602: nothing blocking
        under it) — a racing double-compile of the same key is
        harmless and the second result wins the slot."""
        with self._lock:
            self._clock += 1
            ent = self._entries.get(key)
            if ent is not None:
                ent.refs += 1
                ent.last_use = self._clock
                self._hits += 1
                return ent.fsm
            self._misses += 1
        fsm = compile_constraint(key, vocab)
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = _Entry(fsm, self._clock)
                self._entries[key] = ent
                self._evict_locked()
            ent.refs += 1
            ent.last_use = self._clock
            return ent.fsm

    def release(self, key: tuple) -> None:
        """Drop one reference; entries stay cached at refcount 0
        until LRU eviction needs the slot."""
        with self._lock:
            ent = self._entries.get(key)
            if ent is not None and ent.refs > 0:
                ent.refs -= 1

    def _evict_locked(self) -> None:
        # evict oldest refcount-0 entries until within capacity;
        # referenced entries are never evicted (a slot mid-decode
        # reads its masks every step)
        while len(self._entries) > self.max_entries:
            victims = [
                (e.last_use, k) for k, e in self._entries.items()
                if e.refs == 0
            ]
            if not victims:
                return  # every entry referenced: soft cap
            _, key = min(victims)
            del self._entries[key]
            self._evictions += 1  # graftlint: threadsafe (_locked helper: every caller holds self._lock)

    def stats(self) -> dict:
        """Locked snapshot for /health and the /metrics gauges."""
        with self._lock:
            return {
                "entries": len(self._entries),
                "bytes": sum(
                    e.fsm.nbytes for e in self._entries.values()
                ),
                "referenced": sum(
                    1 for e in self._entries.values() if e.refs > 0
                ),
                "hits_total": self._hits,
                "misses_total": self._misses,
                "evictions_total": self._evictions,
            }
