"""Speculative-decoding drafters for the serving engine (a copy of the
JAX package's serving/spec.py on torch tensors).

A drafter proposes up to k tokens per slot per iteration; the target
verifies all of them in ONE multi-row pool step
(models/decode.py:``forward_decode_spec``, serving/engine.py
``_decode_spec``) instead of k sequential decode steps. Every proposal
is verified, so a bad drafter costs throughput, never correctness:
greedy requests accept a draft token iff it equals the target's argmax
(bit-identical to non-spec greedy decoding in the exact verify mode),
sampled requests run the acceptance-ratio test (Leviathan et al. 2023).

- :class:`NGramDrafter` — the drafter-free prompt-lookup fallback: a
  host-side suffix map over each request's prompt + emitted tokens
  proposes the continuation that followed the most recent occurrence of
  the current n-gram suffix. Zero device cost.
- :class:`ModelDrafter` — a small checkpoint (the paper's pairing: a
  control model beside a diff target; any family sharing the tokenizer
  works) run greedily on its OWN contiguous slot pool, which mirrors the
  target's slot assignment 1:1. Per-slot validity cursors track how far
  each slot's drafter cache holds the slot's real history: catch-up
  feeds the missing tokens in power-of-two chunks (plain prefill
  attention), then the k greedy rounds run ``forward_decode_pool``
  (the decode-attention kernel) with the current tokens and positions
  kept on the device, so the rounds never wait on the host; the (B, k)
  proposals and the finite flags come back in one copy at the end. A
  rejected suffix only leaves the cursor behind (:meth:`ModelDrafter.commit`);
  the next catch-up overwrites it, as the target's ring does. A poisoned
  pool (the ``spec_drafter_crash`` fault) trips the finite-logits check:
  the drafter counts a crash, rebuilds its pool and proposes nothing, so
  the engine falls back to the plain decode step that iteration.

:func:`constrain_proposals` truncates drafts at the first token a
slot's constraint FSM refuses (serving/constrain.py).

Thread-safety: each drafter owns a lock — the engine thread mutates its
state while /health handlers read ``stats()``.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from differential_transformer_replication_tpu_torch.models import (
    check_card_envelope,
    common,
)
from differential_transformer_replication_tpu_torch.models.decode import (
    KV_CACHE_BATCH_AXIS,
    compute_dtype,
    forward_chunk,
    forward_decode_pool,
    init_cache,
)
from differential_transformer_replication_tpu_torch.serving.scheduler import (
    _pow2_chunk,
)


class DraftSlot:
    """One slot's proposal context, passed by the engine each
    iteration: the slot index, the FULL token history (cropped prompt
    + generated so far), the target position P of the last emitted
    token (history[P] is that token), and the per-slot draft cap the
    engine already clamped against max_new_tokens / the ring window /
    the request's own ``draft_len``."""

    __slots__ = ("index", "tokens", "pos", "cap")

    def __init__(self, index: int, tokens: Sequence[int], pos: int,
                 cap: int):
        self.index = index
        self.tokens = tokens
        self.pos = pos
        self.cap = cap


class NGramDrafter:
    """Prompt-lookup speculative decoding (drafter-free fallback).

    Per slot, a suffix map from every n-gram (n = ``max_n`` down to
    ``min_n``) of the request's token history to the position right
    after its most recent occurrence; a proposal is the continuation
    that followed the longest matching suffix of the current history.
    The map is built incrementally (each token indexes ``max_n`` keys),
    so per-iteration cost is O(new tokens), not O(history).
    """

    kind = "ngram"

    def __init__(self, max_n: int = 3, min_n: int = 1):
        if not (1 <= min_n <= max_n):
            raise ValueError(
                f"need 1 <= min_n <= max_n, got {min_n}..{max_n}"
            )
        self._lock = threading.Lock()
        self._proposed = 0
        self.max_n = max_n
        self.min_n = min_n
        # slot -> ({ngram tuple: (previous end, last end)},
        #          tokens indexed so far). Two ends per key because
        #          the history TAIL always matches itself at
        #          end == len(history) — the useful occurrence is the
        #          one before it.
        self._maps: Dict[int, Tuple[dict, int]] = {}

    def stats(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "proposed_total": self._proposed,
                    "drafter_crashes_total": 0}

    def _index_locked(self, index: int, tokens: Sequence[int]):
        entry = self._maps.get(index)
        if entry is None or entry[1] > len(tokens):
            entry = ({}, 0)  # new occupant (slot reuse): fresh map
        smap, done = entry
        first = self.min_n if done == 0 else done + 1
        for end in range(first, len(tokens) + 1):
            for n in range(self.min_n, self.max_n + 1):
                if end - n >= 0:
                    key = tuple(tokens[end - n:end])
                    old = smap.get(key)
                    smap[key] = (old[1] if old else None, end)
        self._maps[index] = (smap, len(tokens))
        return smap

    def propose_all(self, slots: List[DraftSlot]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        with self._lock:
            for s in slots:
                if s.cap <= 0:
                    continue
                # the engine passes history ending exactly at pos (the
                # common case) — avoid a per-iteration copy then
                hist = (
                    s.tokens if len(s.tokens) == s.pos + 1
                    else list(s.tokens[:s.pos + 1])
                )
                smap = self._index_locked(s.index, hist)
                prop: List[int] = []
                for n in range(min(self.max_n, len(hist)), self.min_n - 1,
                               -1):
                    ends = smap.get(tuple(hist[-n:]))
                    if ends is None:
                        continue
                    # the match ending AT the history tail proposes
                    # nothing (its continuation is the future); fall
                    # back to the occurrence before it
                    at = ends[1] if ends[1] < len(hist) else ends[0]
                    if at is not None:
                        prop = hist[at:at + s.cap]
                        break
                if prop:
                    out[s.index] = prop
                    self._proposed += len(prop)
        return out

    def commit(self, index: int, new_pos: int) -> None:
        """The verify step emitted tokens for this slot (its last now at
        ``new_pos``): nothing to do, the maps re-read the history."""

    def release(self, index: int) -> None:
        """The slot retired (finish, deadline or cancel)."""
        with self._lock:
            self._maps.pop(index, None)

    def reset(self) -> None:
        """Engine crash recovery: drop every suffix map."""
        with self._lock:
            self._maps.clear()


class ModelDrafter:
    """A small checkpoint proposing greedily on its own slot pool.

    ``_next[i]`` is the first position of slot i whose drafter-cache
    entry does NOT yet hold the slot's real history; catch-up feeds
    ``tokens[_next..P-1]`` before the pooled propose rounds feed
    ``tokens[P]`` and then each argmax. ``params`` is a JAX-layout tree
    (params.py), kept on ``device`` with the matmul weights cast once to
    the drafter's compute dtype. ``rounds_total`` counts the pooled
    propose rounds run (each one ``forward_decode_pool`` call, so one
    decode-attention launch per drafter layer on the card) and
    ``catchup_chunks`` the catch-up chunks."""

    kind = "model"

    def __init__(self, params: dict, cfg, num_slots: int, rope_len: int,
                 prefill_chunk: int = 128, draft_len: int = 4,
                 device="cpu"):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            check_card_envelope(cfg, "serve")
        self._lock = threading.Lock()
        self._proposed = 0
        self._crashes = 0
        self.rounds_total = 0
        self.catchup_chunks = 0
        self.params = common.inference_params(params, compute_dtype(cfg),
                                              self.device)
        self.cfg = cfg
        self.num_slots = num_slots
        self.rope_len = max(rope_len, cfg.block_size)
        self.prefill_chunk = prefill_chunk
        self.draft_len = draft_len
        with self._lock:
            self._rebuild_locked()

    def stats(self) -> dict:
        with self._lock:
            return {"kind": self.kind, "proposed_total": self._proposed,
                    "drafter_crashes_total": self._crashes}

    def window(self) -> int:
        """Proposals must stay inside the drafter's own ring too."""
        return self.cfg.block_size

    def bytes_total(self) -> int:
        """Device bytes of the drafter pool, held beside the target's."""
        with self._lock:
            return sum(t.numel() * t.element_size() for layer in self.cache
                       for t in layer.values())

    def poison(self) -> None:
        """The ``spec_drafter_crash@N`` fault: NaN-fill the whole pool
        (int8 values go to 0), so the next propose round's finite check
        trips."""
        with self._lock:
            for layer in self.cache:
                for t in layer.values():
                    t.fill_(float("nan") if t.is_floating_point() else 0)

    def _rebuild_locked(self) -> None:
        self.cache = init_cache(self.cfg, self.num_slots, self.device)
        self._next = [0] * self.num_slots

    def _catch_up_locked(self, s: DraftSlot) -> None:
        """Feed the slot's history tokens its cache does not hold yet, in
        the engine's power-of-two prefill chunks, in place in its row."""
        i = s.index
        start = self._next[i]
        if start < s.pos:
            row = [{key: (t[:, i:i + 1] if KV_CACHE_BATCH_AXIS[key]
                          else t[i:i + 1]) for key, t in c.items()}
                   for c in self.cache]
        while start < s.pos:
            size = _pow2_chunk(s.pos - start, self.prefill_chunk)
            tokens = torch.as_tensor(list(s.tokens[start:start + size]),
                                     dtype=torch.int64,
                                     device=self.device)[None]
            forward_chunk(self.params, tokens, start, row, self.cfg,
                          rope_len=self.rope_len)
            self.catchup_chunks += 1
            start += size
        self._next[i] = start

    def propose_all(self, slots: List[DraftSlot]) -> Dict[int, List[int]]:
        out: Dict[int, List[int]] = {}
        with self._lock:
            for s in slots:
                self._catch_up_locked(s)
            B = self.num_slots
            tok0 = np.zeros((B,), np.int64)
            pos0 = np.zeros((B,), np.int64)
            caps = np.zeros((B,), np.int64)
            proposing = []
            for s in slots:
                cap = min(s.cap, self.draft_len, self.window() - s.pos - 1)
                if cap <= 0:
                    continue
                tok0[s.index] = s.tokens[s.pos]
                pos0[s.index] = s.pos
                caps[s.index] = cap
                proposing.append(s)
            if not proposing:
                return {}
            k = int(caps.max())
            # every round's active rows are known here: one upload of the
            # (k, B) activity mask, the row indices of all rounds and the
            # start tokens and positions; nothing reads the device until
            # the last round
            act = np.arange(k)[:, None] < caps[None, :]
            rows = [np.flatnonzero(a) for a in act]
            offs = np.cumsum([0] + [len(r) for r in rows])
            ops = torch.as_tensor(np.concatenate(
                [tok0, pos0, act.reshape(-1).astype(np.int64)]
                + rows), device=self.device)
            cur_tok, cur_pos = ops[:B], ops[B:2 * B].to(torch.int32)
            act_t = ops[2 * B:2 * B + k * B].view(k, B).bool()
            idx = ops[2 * B + k * B:]
            toks = torch.zeros((B, k), dtype=torch.int64, device=self.device)
            ok = torch.ones((B,), dtype=torch.bool, device=self.device)
            for r in range(k):
                logits, _ = forward_decode_pool(
                    self.params, cur_tok, cur_pos, self.cache, self.cfg,
                    rope_len=self.rope_len, active=idx[offs[r]:offs[r + 1]])
                lf = logits.to(torch.float32)
                nxt = torch.argmax(lf, dim=-1)
                a = act_t[r]
                ok = ok & (torch.isfinite(lf).all(dim=-1) | ~a)
                toks[:, r] = torch.where(a, nxt, torch.zeros_like(nxt))
                cur_tok = torch.where(a, nxt, cur_tok)
                cur_pos = cur_pos + a.to(torch.int32)
            self.rounds_total += k
            host = torch.cat([toks, ok[:, None].to(torch.int64)],
                             dim=1).cpu().numpy()
            if not all(bool(host[s.index, k]) for s in proposing):
                # a poisoned pool: rebuild from params and propose
                # nothing, so the engine runs the plain decode step
                self._crashes += 1
                self._rebuild_locked()
                return {}
            for s in proposing:
                cap = int(caps[s.index])
                out[s.index] = [int(t) for t in host[s.index, :cap]]
                self._next[s.index] = s.pos + cap
                self._proposed += cap
        return out

    def commit(self, index: int, new_pos: int) -> None:
        """Rewind the slot's validity cursor past rejected rows: entries
        at positions >= ``new_pos`` hold rejected drafts' K/V and are fed
        again (the accepted prefix below it is valid by construction)."""
        with self._lock:
            self._next[index] = min(self._next[index], new_pos)

    def release(self, index: int) -> None:
        with self._lock:
            self._next[index] = 0

    def reset(self) -> None:
        """Engine crash recovery: a fresh pool."""
        with self._lock:
            self._rebuild_locked()


def build_drafter(serving, target_cfg, rope_len: int,
                  drafter: Optional[Tuple[dict, object]] = None,
                  device="cpu"):
    """The configured drafter of an engine, or None with spec off.

    ``drafter`` is an optional pre-loaded ``(params, cfg)`` pair (tests,
    sample.py, the server's verified and quantized load); otherwise
    ``spec_mode == "model"`` loads ``spec_drafter_ckpt`` through
    ``load_params_for_inference`` (manifest verified). A drafter whose
    vocab differs from the target's cannot share the tokenizer and
    raises."""
    if not serving.spec_enabled():
        return None
    if serving.spec_mode == "ngram":
        return NGramDrafter()
    if serving.spec_mode != "model":
        raise ValueError(f"unknown spec_mode {serving.spec_mode!r}")
    if drafter is not None:
        d_params, d_cfg = drafter
    else:
        if not serving.spec_drafter_ckpt:
            raise ValueError(
                "spec_mode='model' needs spec_drafter_ckpt (or a "
                "pre-loaded drafter)"
            )
        from differential_transformer_replication_tpu_torch.train.checkpoint import (
            load_params_for_inference,
        )

        d_params, d_cfg, _ = load_params_for_inference(
            serving.spec_drafter_ckpt)
    if d_cfg.vocab_size != target_cfg.vocab_size:
        raise ValueError(
            f"drafter vocab ({d_cfg.vocab_size}) != target vocab "
            f"({target_cfg.vocab_size}): drafter and target must share "
            "one tokenizer"
        )
    return ModelDrafter(d_params, d_cfg, serving.num_slots, rope_len,
                        prefill_chunk=serving.prefill_chunk,
                        draft_len=serving.spec_draft_len, device=device)


def constrain_proposals(props: Dict[int, List[int]],
                        fsms: Dict[int, tuple]) -> Dict[int, List[int]]:
    """Truncate drafter proposals at the first token a slot's constraint
    FSM disallows (serving/constrain.py:TokenFsm). ``fsms`` maps slot
    index -> (fsm, current state) for constrained slots; others pass
    through. A draft the FSM refuses outright is dropped (the slot rides
    the verify step with no draft). Truncation only saves verify rows:
    the verify compares each draft with the constraint-masked target,
    so a disallowed draft is rejected anyway."""
    if not fsms:
        return props
    out: Dict[int, List[int]] = {}
    for i, toks in props.items():
        ent = fsms.get(i)
        if ent is not None:
            fsm, state = ent
            toks = toks[:fsm.prefix_len(toks, state=state)]
        if toks:
            out[i] = toks
    return out
