"""Byte-level BPE tokenizer training and corpus encoding, in pure Python.

Counterpart of ``differential_transformer_replication_tpu/data/tokenizer.py``
with the same functions, signatures and messages. The JAX package uses
``tokenizers.ByteLevelBPETokenizer``; the port carries its own
:class:`ByteLevelBPE` (stdlib only) with the subset of that interface the
functions call, and trains, saves, loads, encodes and decodes exactly as
it does:

- pre-tokenizer: the GPT-2 pattern ``'s|'t|'re|'ve|'m|'ll|'d| ?\\p{L}+|
  ?\\p{N}+| ?[^\\s\\p{L}\\p{N}]+|\\s+(?!\\S)|\\s+`` (no prefix space), its
  classes built once from ``unicodedata``: letters are the L* general
  categories, numbers N* (``\\d`` would miss ``½`` and ``²``) and
  whitespace is Unicode White_Space (``str.isspace`` would add
  U+001C-U+001F); each piece's UTF-8 bytes map through the GPT-2
  bytes-to-unicode table;
- trainer: the special tokens, then the 256 byte characters by code
  point, then one id per merge; each merge takes the pair with the
  highest count, a tie going to the smaller (left id, right id), until
  the vocabulary reaches ``vocab_size`` or the best count falls below
  ``min_frequency``. Pair counts are kept incrementally (a pair -> words
  index, updated by each merge, and a heap whose stale entries are
  re-pushed at their current count), as the Rust trainer keeps them;
- files: ``vocab.json`` compact, ordered by id, UTF-8 unescaped, and
  ``merges.txt`` under ``#version: 0.2``, byte for byte the Rust
  library's;
- encode: special tokens found in the text become their ids (only on a
  trained tokenizer: one loaded from files has no special tokens
  registered, as with the Rust library), every other piece is merged by
  rank, lowest first, through a word cache;
- decode: special tokens of a trained tokenizer are skipped, unknown ids
  dropped, the rest mapped back to bytes and decoded as UTF-8 with
  ``errors="replace"``.
"""

from __future__ import annotations

import functools
import heapq
import itertools
import json
import os
import re
import unicodedata
from array import array
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

EOT = "<|endoftext|>"
PAD = "<|pad|>"

# Unicode White_Space: the regex engine's \s (U+001C-U+001F excluded)
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0),
                (0x1680, 0x1680), (0x2000, 0x200A), (0x2028, 0x2029),
                (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))


def bytes_to_unicode() -> Dict[int, str]:
    """The GPT-2 byte -> printable character table: printable Latin-1
    bytes map to themselves, the other 68 to U+0100 onwards in byte
    order."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


BYTE_ENCODER = bytes_to_unicode()
BYTE_DECODER = {c: b for b, c in BYTE_ENCODER.items()}


def _char_class(ranges) -> str:
    return "".join(f"\\U{a:08x}" if a == b else f"\\U{a:08x}-\\U{b:08x}"
                   for a, b in ranges)


def _category_ranges(prefix: str) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for cp in range(0x110000):
        if unicodedata.category(chr(cp))[0] == prefix:
            if out and out[-1][1] == cp - 1:
                out[-1] = (out[-1][0], cp)
            else:
                out.append((cp, cp))
    return out


@functools.lru_cache(maxsize=None)
def pretokenizer() -> "re.Pattern":
    """The GPT-2 pre-tokenizer pattern over explicit Unicode classes
    (built on first use, about a quarter of a second)."""
    L = _char_class(_category_ranges("L"))
    N = _char_class(_category_ranges("N"))
    S = _char_class(_WHITE_SPACE)
    return re.compile(
        f"'s|'t|'re|'ve|'m|'ll|'d| ?[{L}]+| ?[{N}]+| ?[^{S}{L}{N}]+"
        f"|[{S}]+(?![^{S}])|[{S}]+")


class Encoding:
    """The piece of an encoding the callers read: ``ids``."""

    __slots__ = ("ids",)

    def __init__(self, ids: List[int]):
        self.ids = ids


def _merge_word(word: List[int], a: int, b: int, new: int) -> list:
    """Merge every (a, b) of ``word`` left to right, in place; returns the
    pair-count changes ((pair, +-1), ...) of the Rust trainer's
    ``Word::merge``: the neighbours' old pairs lose one, their pairs with
    the new symbol gain one (the merged pair itself is not counted)."""
    changes = []
    i = 0
    while i < len(word):
        if word[i] == a and i + 1 < len(word) and word[i + 1] == b:
            if i > 0:
                changes.append(((word[i - 1], a), -1))
                changes.append(((word[i - 1], new), 1))
            word[i:i + 2] = [new]
            if i < len(word) - 1:
                changes.append(((b, word[i + 1]), -1))
                changes.append(((new, word[i + 1]), 1))
        i += 1
    return changes


class ByteLevelBPE:
    """A byte-level BPE tokenizer: ``ByteLevelBPE()`` then
    :meth:`train_from_iterator`, or ``ByteLevelBPE(vocab_path,
    merges_path)`` to load the files :meth:`save_model` (or the Rust
    library) wrote."""

    def __init__(self, vocab: Optional[str] = None, merges: Optional[str] = None):
        self._vocab: Dict[str, int] = {}
        self._merges: List[Tuple[int, int]] = []  # rank order
        self._specials: Tuple[str, ...] = ()
        if vocab is not None:
            with open(vocab, encoding="utf-8") as f:
                self._vocab = {str(k): int(v) for k, v in json.load(f).items()}
        if merges is not None:
            pairs = []
            with open(merges, encoding="utf-8") as f:
                for n, line in enumerate(f.read().split("\n")):
                    if not line or line.startswith("#version"):
                        continue
                    parts = line.split(" ")
                    if len(parts) != 2:
                        raise ValueError(f"{merges}: bad merge on line {n + 1}")
                    pairs.append(tuple(parts))
            self._merges = [(self._vocab[a], self._vocab[b]) for a, b in pairs]
            self._merge_ids = [self._vocab[a + b] for a, b in pairs]
        else:
            self._merge_ids = []
        self._reindex()

    def _reindex(self) -> None:
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        # (left, right) -> (rank, new id); a repeated pair keeps its last rank
        self._ranks = {p: (r, n) for r, (p, n) in
                       enumerate(zip(self._merges, self._merge_ids))}
        self._cache: Dict[str, Tuple[int, ...]] = {}
        self._special_re = (re.compile("|".join(
            re.escape(s) for s in sorted(self._specials, key=len, reverse=True)))
            if self._specials else None)

    # -- training -------------------------------------------------------
    def train_from_iterator(self, iterator: Iterable[str], vocab_size: int = 30000,
                            min_frequency: int = 2,
                            special_tokens: Sequence[str] = ()) -> None:
        """Train on the texts of ``iterator`` (the Rust BpeTrainer's
        algorithm)."""
        pat = pretokenizer()
        pieces: Counter = Counter()
        for text in iterator:
            pieces.update(pat.findall(text))
        word_counts = Counter()
        for piece, n in pieces.items():
            word_counts["".join(BYTE_ENCODER[b] for b in piece.encode("utf-8"))] += n
        w2id: Dict[str, int] = {}
        id2w: List[str] = []

        def add(tok: str) -> int:
            if tok not in w2id:
                w2id[tok] = len(id2w)
                id2w.append(tok)
            return w2id[tok]

        for tok in special_tokens:
            add(tok)
        alphabet = set(BYTE_ENCODER.values())
        for w in word_counts:
            alphabet.update(w)
        for c in sorted(alphabet):
            add(c)
        words = [[w2id[c] for c in w] for w in word_counts]
        counts = list(word_counts.values())
        pair_counts: Dict[Tuple[int, int], int] = defaultdict(int)
        where: Dict[Tuple[int, int], set] = defaultdict(set)
        for i, w in enumerate(words):
            for pair in zip(w, w[1:]):
                pair_counts[pair] += counts[i]
                where[pair].add(i)
        seq = itertools.count()
        # a max-heap on (count, then the smaller pair) through negated counts
        heap = [(-pair_counts[p], p, next(seq), pos) for p, pos in where.items()
                if pair_counts[p] > 0]
        heapq.heapify(heap)
        merges: List[Tuple[int, int]] = []
        merge_ids: List[int] = []
        while len(w2id) < vocab_size and heap:
            neg, pair, _, pos = heapq.heappop(heap)
            count = pair_counts[pair]
            if -neg != count:  # stale: back in at its current count
                heapq.heappush(heap, (-count, pair, next(seq), pos))
                continue
            if count < 1 or min_frequency > count:
                break
            new_id = add(id2w[pair[0]] + id2w[pair[1]])
            merges.append(pair)
            merge_ids.append(new_id)
            where = defaultdict(set)
            for i in pos:
                for p, change in _merge_word(words[i], pair[0], pair[1], new_id):
                    pair_counts[p] += change * counts[i]
                    if change > 0:
                        where[p].add(i)
            for p, pos_p in where.items():
                if pair_counts[p] > 0:
                    heapq.heappush(heap, (-pair_counts[p], p, next(seq), pos_p))
        self._vocab = w2id
        self._merges, self._merge_ids = merges, merge_ids
        self._specials = tuple(special_tokens)
        self._reindex()

    def save_model(self, directory: str) -> List[str]:
        """Write ``vocab.json`` and ``merges.txt`` into ``directory``;
        returns their paths."""
        vocab_path = os.path.join(directory, "vocab.json")
        merges_path = os.path.join(directory, "merges.txt")
        ordered = {self._id_to_token[i]: i for i in sorted(self._id_to_token)}
        with open(vocab_path, "wb") as f:
            f.write(json.dumps(ordered, ensure_ascii=False,
                               separators=(",", ":")).encode("utf-8"))
        lines = ["#version: 0.2\n"]
        for pair, _ in sorted(self._ranks.items(), key=lambda kv: kv[1][0]):
            lines.append(f"{self._id_to_token[pair[0]]} {self._id_to_token[pair[1]]}\n")
        with open(merges_path, "wb") as f:
            f.write("".join(lines).encode("utf-8"))
        return [vocab_path, merges_path]

    # -- encode / decode ------------------------------------------------
    def _word_ids(self, piece: str) -> Tuple[int, ...]:
        """One pre-token's ids: its byte characters merged by rank, the
        lowest rank (then the leftmost position) first."""
        got = self._cache.get(piece)
        if got is not None:
            return got
        vocab, ranks = self._vocab, self._ranks
        sym = [vocab[c] for c in (BYTE_ENCODER[b] for b in piece.encode("utf-8"))
               if c in vocab]
        n = len(sym)
        nxt = list(range(1, n + 1))
        prev = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = ranks.get((sym[i], sym[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = ranks.get((sym[pos], sym[right]))
            if m is None or m[1] != new_id:
                continue  # an expired entry
            sym[pos] = new_id
            alive[right] = False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prev[nxt[pos]] = pos
            if prev[pos] >= 0:
                m = ranks.get((sym[prev[pos]], new_id))
                if m is not None:
                    heapq.heappush(heap, (m[0], prev[pos], m[1]))
            if nxt[pos] < n:
                m = ranks.get((new_id, sym[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        got = tuple(s for s, a in zip(sym, alive) if a)
        self._cache[piece] = got
        return got

    def encode_ids(self, text: str) -> List[int]:
        pat = pretokenizer()
        ids: List[int] = []
        segments = [(text, False)]
        if self._special_re is not None and self._special_re.search(text):
            segments, at = [], 0
            for m in self._special_re.finditer(text):
                segments += [(text[at:m.start()], False), (m.group(), True)]
                at = m.end()
            segments.append((text[at:], False))
        for seg, special in segments:
            if special:
                ids.append(self._vocab[seg])
                continue
            for piece in pat.findall(seg):
                ids.extend(self._word_ids(piece))
        return ids

    def encode(self, text: str) -> Encoding:
        return Encoding(self.encode_ids(text))

    def encode_batch(self, texts: Sequence[str]) -> List[Encoding]:
        return [self.encode(t) for t in texts]

    def decode(self, ids: Iterable[int]) -> str:
        out = bytearray()
        for i in ids:
            tok = self._id_to_token.get(int(i))
            if tok is None or tok in self._specials:
                continue
            try:
                out += bytes(BYTE_DECODER[c] for c in tok)
            except KeyError:  # not a byte-level token: its own UTF-8
                out += tok.encode("utf-8")
        return out.decode("utf-8", errors="replace")

    # -- vocabulary -----------------------------------------------------
    def token_to_id(self, token: str) -> Optional[int]:
        return self._vocab.get(token)

    def get_vocab(self) -> Dict[str, int]:
        """token -> id, the special tokens included."""
        return dict(self._vocab)

    def get_vocab_size(self) -> int:
        return len(self._vocab)


def train_bpe_tokenizer(
    texts: Sequence[str],
    vocab_size: int = 12000,
    min_frequency: int = 2,
    save_dir: str | None = "tokenizer",
):
    """Train a byte-level BPE on the given texts (special tokens EOT and
    PAD) and optionally persist vocab+merges to ``save_dir``."""
    tok = ByteLevelBPE()
    tok.train_from_iterator(iter(texts), vocab_size=vocab_size,
                            min_frequency=min_frequency,
                            special_tokens=[EOT, PAD])
    if save_dir:
        os.makedirs(save_dir, exist_ok=True)
        tok.save_model(save_dir)
    return tok


def load_tokenizer(save_dir: str) -> ByteLevelBPE:
    return ByteLevelBPE(os.path.join(save_dir, "vocab.json"),
                        os.path.join(save_dir, "merges.txt"))


def vocab_strings(tok, vocab_size: int) -> List[str]:
    """The id -> decoded-text table: entry i is exactly the text token i
    contributes to decoded output. Empty string for ids outside the
    tokenizer's range (a padded model vocab) and for special tokens."""
    n = tok.get_vocab_size()
    specials = {tok.token_to_id(EOT), tok.token_to_id(PAD)}
    return [
        "" if (i >= n or i in specials) else tok.decode([i])
        for i in range(vocab_size)
    ]


def encode_corpus(tokenizer, texts: Sequence[str]) -> np.ndarray:
    """Encode all texts, appending one EOT id after each document.
    Returns a flat int32 token array (built in a 4-byte array, so a
    million documents never sit as Python int lists)."""
    eot_id = tokenizer.token_to_id(EOT)
    buf = array("i")
    for text in texts:
        buf.extend(tokenizer.encode(text).ids)
        buf.append(eot_id)
    return np.frombuffer(buf, dtype=np.int32).copy() if buf else np.zeros((0,), np.int32)


def tokenizer_fingerprint(tok) -> str:
    """Content hash of the tokenizer's vocab (16 hex chars). Recorded in
    checkpoint meta at save time so downstream tools can verify they were
    handed the SAME tokenizer the model was trained with — equal vocab
    SIZE is not enough (every run targets 12000, so a shared tokenizer
    dir clobbered by a different corpus's run passes a size check with
    entirely different token ids)."""
    import hashlib

    blob = json.dumps(sorted(tok.get_vocab().items()), ensure_ascii=False).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def check_tokenizer_matches(
    tok, model_vocab_size: int, expected_fingerprint: str | None = None,
    context: str = "",
) -> None:
    """Fail loud when a tokenizer cannot belong to the checkpointed
    model: vocab-size mismatch always; content-fingerprint mismatch when
    the checkpoint meta recorded one (older checkpoints did not)."""
    where = f" for {context}" if context else ""
    if tok.get_vocab_size() != model_vocab_size:
        raise SystemExit(
            f"tokenizer vocab {tok.get_vocab_size()} != model vocab "
            f"{model_vocab_size}{where} — pass the tokenizer the "
            "checkpoint was trained with (usually "
            "<tokenizer_dir>/cache-<key>/ from its training run)"
        )
    if expected_fingerprint:
        fp = tokenizer_fingerprint(tok)
        if fp != expected_fingerprint:
            raise SystemExit(
                f"tokenizer content fingerprint {fp} != the checkpoint's "
                f"recorded {expected_fingerprint}{where}: same vocab "
                "size, different tokenizer (a shared tokenizer dir was "
                "likely overwritten by another run) — use the "
                "<tokenizer_dir>/cache-<key>/ copy from this "
                "checkpoint's training run"
            )
