"""Autoregressive sampling on the training forward.

Counterpart of ``differential_transformer_replication_tpu/models/
generate.py``: run a full forward over a fixed ``(B, block_size)``
window buffer, take the last real position's logits
and sample. The prompt sits left-aligned; new tokens are appended until
the buffer is full, then the window shifts by one a token (the
reference's crop to the last ``block_size`` tokens). Slots past the
current length hold zeros and cannot reach earlier positions under the
causal mask. Each token costs a full ``block_size`` forward; the KV-cached
route is ``models/decode.py:generate_cached``.

Draws come from an explicit ``torch.Generator`` on the logits' device,
seeded from the caller's seed, so sampled tokens are a function of the
seed; they differ from the JAX package's
(another random stream), greedy tokens do not.
"""

from __future__ import annotations

from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.models import common
from differential_transformer_replication_tpu_torch.models.registry import model_forward

def make_generator(seed: int, device) -> torch.Generator:
    """The draws' generator on ``device``, seeded from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def sample_token(gen: torch.Generator, logits: torch.Tensor,
                 temperature: float = 1.0, top_k: Optional[int] = None
                 ) -> torch.Tensor:
    """One sampling step over (B, V) fp32 logits -> (B,) int64 ids.
    ``top_k`` > 0 sends logits below the k-th largest of their row to
    -inf (ties at the k-th value are kept); ``temperature <= 0`` is
    greedy argmax (first index on ties); otherwise a multinomial draw
    from ``gen`` over ``softmax(logits / temperature)``."""
    if top_k is not None and int(top_k) > 0:  # <= 0 means off
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, -float("inf")),
                             logits)
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=gen).squeeze(-1)


@torch.no_grad()
def generate(params: dict, idx: torch.Tensor, cfg: ModelConfig,
             max_new_tokens: int, seed: int = 0, temperature: float = 1.0,
             top_k: Optional[int] = None) -> torch.Tensor:
    """idx: (B, T0) prompt with 0 < T0 <= block_size. Returns
    (B, T0 + max_new_tokens), prompt included."""
    B, T0 = idx.shape
    S = cfg.block_size
    if not 0 < T0 <= S:
        raise ValueError(f"prompt length {T0} must be in (0, block_size={S}]")
    gen = make_generator(seed, idx.device)
    # weights cast to the compute dtype once, not in every forward
    params = common.inference_params(params, common.compute_dtype(cfg), idx.device)
    window = torch.zeros((B, S), dtype=torch.int64, device=idx.device)
    window[:, :T0] = idx
    length = T0
    samples = []
    for _ in range(max_new_tokens):
        logits, _ = model_forward(params, window, cfg)
        nxt = sample_token(gen, logits[:, length - 1, :].to(torch.float32),
                           temperature, top_k)
        samples.append(nxt)
        if length < S:
            window[:, length] = nxt
            length += 1
        else:
            window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
    if not samples:
        return idx.clone()
    return torch.cat([idx, torch.stack(samples, dim=1).to(idx.dtype)], dim=1)
