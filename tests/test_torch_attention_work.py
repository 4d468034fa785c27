"""The work arithmetic behind every attention kernel's bound
(``testing.attention_work``, used by ``chip_smoke.py`` and
``train/attention_bench.py``): the visible (row, column) pairs of a causal
block under an offset against a brute-force count of the mask the plain
versions apply, and the bytes against the operands each kernel reads and
writes. CPU only."""

from __future__ import annotations

import pytest
import torch

from differential_transformer_replication_tpu_torch import testing
from differential_transformer_replication_tpu_torch.ops import flash


@pytest.mark.parametrize("T", [100, 520])
@pytest.mark.parametrize("off_of", ["-T", "-24", "0", "+40", "+T"])
def test_visible_pairs_match_the_mask(T, off_of):
    off = {"-T": -T, "-24": -24, "0": 0, "+40": 40, "+T": T}[off_of]
    pos = torch.arange(T)
    mask = pos[None, :] <= pos[:, None] + off  # the plain versions' visibility
    assert testing.visible_pairs(T, off) == int(mask.sum())
    pairs, _, ops = testing.attention_work(2, 3, 2, T, 96, 192, off, "chunk_fwd")
    assert pairs == 6 * int(mask.sum())
    assert ops == pairs * 2 * (2 * 96 + 2 * 192)


def test_visible_pairs_of_the_plain_forward():
    """The plain forward gives exactly the rows with no visible key the
    lse of a masked row (-1e30): the rows the pair count leaves empty."""
    T, off = 100, -24
    q, k = (torch.randn(1, 1, T, 8, generator=torch.Generator().manual_seed(s))
            for s in (1, 2))
    v = torch.randn(1, T, 8, generator=torch.Generator().manual_seed(3))
    _, _, lse = flash.bh_attention_fwd_reference(q, k, v, None, 0.0, (0, 0), off)
    empty = int((lse < -1e29).sum())
    assert empty == -off  # rows 0 .. 23 see no column
    assert testing.visible_pairs(T, off) == sum(max(0, min(T, r + off + 1))
                                                for r in range(T))


def _operand_bytes(kind, BH, S, T, d, dv, es, seen):
    """The operands' bytes, inputs counted over the ``seen`` query rows
    that see a key (q, g, lse, delta) and key rows that a row sees (k,
    v); outputs over all T rows."""
    qk, v, o_all = BH * S * T * d * es, BH * T * dv * es, BH * S * T * dv * es
    rows = BH * S * T * 4  # one fp32 per (head, stream, row): lse or delta
    q_in, k_in, v_in = (x * seen // T for x in (qk, qk, v))
    g_in, go_in, rows_in = v * seen // T, o_all * seen // T, rows * seen // T
    return {
        "fwd": q_in + k_in + v_in + v + o_all + rows,                  # -> out o_all lse
        "chunk_fwd": q_in + k_in + v_in + o_all + rows,                # -> o_all lse
        "dq": q_in + k_in + v_in + g_in + 2 * rows_in + qk,            # g lse delta -> dq
        "dkv": q_in + k_in + v_in + g_in + 2 * rows_in + qk + v,       # ... -> dk dv
        "bwd": q_in + k_in + v_in + g_in + 2 * rows_in + 2 * qk + v,   # ... -> dq dk dv
        "chunk_dq": q_in + k_in + v_in + go_in + 2 * rows_in + qk,     # per-stream g
        "chunk_dkv": q_in + k_in + v_in + go_in + 2 * rows_in + qk + v,
    }[kind]


@pytest.mark.parametrize("off_of", ["0", "-T", "-24", "+40"])
@pytest.mark.parametrize("kind", testing.ATTENTION_KINDS)
def test_attention_bytes_are_the_operands(kind, off_of):
    """Each input the result depends on read once, each output written
    once: a fully masked block (off -T) reads nothing and still writes
    its outputs."""
    B, H, S, T, d, dv = 2, 4, 3, 100, 40, 80
    off = {"0": 0, "-T": -T, "-24": -24, "+40": 40}[off_of]
    pos = torch.arange(T)
    mask = pos[None, :] <= pos[:, None] + off
    seen_rows, seen_keys = int(mask.any(1).sum()), int(mask.any(0).sum())
    assert seen_rows == seen_keys  # the count attention_work takes for both
    for es in (2, 4):
        _, nbytes, _ = testing.attention_work(B, H, S, T, d, dv, off, kind, es)
        assert nbytes == _operand_bytes(kind, B * H, S, T, d, dv, es, seen_rows)
