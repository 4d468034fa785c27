"""Paper-level introspection: per-layer lambda + per-group norms.

Counterpart of the JAX package's ``obs/introspect.py``. The
Differential Transformer's central learnable quantity is the per-layer
lambda that weights the subtracted attention map; the paper's
lambda-evolution figure shows it drifting away from the
``0.8 - 0.6*exp(-0.3*(l-1))`` init schedule during training. The trainer
calls :func:`make_param_summary`'s op at every eval and logs
:func:`lambda_record` of it as one ``{"record": "introspection"}`` row
of ``metrics.jsonl``, so ``tools/lambda_report.py`` renders the figure
from a port run as from a JAX one (the same key schema).

Family shapes:
  - control: no lambdas — only norms are logged,
  - diff:    ``lambdas`` is (n_layer,) — one effective lambda/layer,
  - ndiff:   ``lambdas`` is (n_layer, n_terms) — one per term per layer.
"""

from __future__ import annotations

from typing import Optional

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig
from differential_transformer_replication_tpu_torch.ops.lambdas import (
    diff_lambda,
    lambda_init_schedule,
    ndiff_lambdas,
)
from differential_transformer_replication_tpu_torch.train.optim import (
    global_norm,
    leaves,
)


def effective_diff_lambda(attn_params: dict, layer_idx: int) -> torch.Tensor:
    """Scalar effective lambda of one diff-attention layer: the mean over
    heads of :func:`diff_lambda` (``layer_idx`` 1-based, like the
    schedule)."""
    lq, lk = attn_params["lambda_q"], attn_params["lambda_k"]
    return diff_lambda(lq[0], lk[0], lq[1], lk[1],
                       lambda_init_schedule(layer_idx)).mean()


def effective_ndiff_lambdas(attn_params: dict, layer_idx: int) -> torch.Tensor:
    """(n_terms,) effective lambdas of one ndiff layer: the mean over
    heads of :func:`ndiff_lambdas` per term."""
    return ndiff_lambdas(attn_params["lambda_q"], attn_params["lambda_k"],
                         lambda_init_schedule(layer_idx)).mean(dim=-1)


def _layer_lambdas(params: dict, cfg: ModelConfig) -> Optional[torch.Tensor]:
    if cfg.model == "control":
        return None
    per_layer = (effective_diff_lambda if cfg.model == "diff"
                 else effective_ndiff_lambdas)
    return torch.stack([per_layer(blk["attn"], li)  # 1-based layers
                        for li, blk in enumerate(params["blocks"], 1)])


@torch.no_grad()
def serving_lambda_summary(params: dict, cfg: ModelConfig) -> dict:
    """Host-side per-layer effective-lambda view for the serving
    telemetry (serving/engine.py mirrors it into
    ``serving_lambda_mean{layer=}`` and ``{"record": "quality"}`` rows):
    the key schema of :func:`lambda_record`. ``lambda_l<k>`` is the term
    mean for ndiff (the gauge's value); per-term detail rides the
    ``_t<j>`` keys. Empty dict for the control family.

    It runs once at engine build and after a params rebind (the
    ``quality_drift`` fault), never per step: it copies to the host."""
    lams = _layer_lambdas(params, cfg)
    if lams is None:
        return {}
    lams = lams.detach().to("cpu", torch.float32)
    out = {}
    for li in range(lams.shape[0]):
        if lams.dim() == 1:  # diff: one effective lambda per layer
            out[f"lambda_l{li + 1}"] = float(lams[li])
        else:  # ndiff: per-term lambdas + their mean
            out[f"lambda_l{li + 1}"] = float(lams[li].mean())
            for tj in range(lams.shape[1]):
                out[f"lambda_l{li + 1}_t{tj}"] = float(lams[li, tj])
    return out


def group_norms(tree: dict) -> dict:
    """Global L2 norm per layer group: embeddings, each block, the final
    norm + lm head (of params or of their gradients)."""
    embed = {k: v for k, v in tree.items() if k in ("tok_emb", "pos_emb")}
    head = {k: v for k, v in tree.items() if k in ("ln_f", "lm_head")}
    return {
        "embed": global_norm(leaves(embed)),
        "blocks": torch.stack([global_norm(leaves(b)) for b in tree["blocks"]]),
        "head": global_norm(leaves(head)),
    }


def make_param_summary(cfg: ModelConfig):
    """``summary(params) -> dict`` with ``lambdas`` (see module docstring;
    absent for control) and ``param_norms`` (embed / (L,) blocks / head),
    computed without grad on the params' device."""

    @torch.no_grad()
    def summary(params: dict) -> dict:
        out = {"param_norms": group_norms(params)}
        lams = _layer_lambdas(params, cfg)
        if lams is not None:
            out["lambdas"] = lams
        return out

    return summary


def lambda_record(summary_out: dict, cfg: ModelConfig, grad_norms=None) -> dict:
    """Flat JSON-friendly fields of one ``metrics.jsonl`` record from a
    summary (the JAX package's keys and rounding):

      - diff:  ``lambda_l<k>`` (1-based layer) -> float,
      - ndiff: ``lambda_l<k>_t<j>`` (0-based term) -> float,
      - every family: ``param_norm_embed`` / ``param_norm_l<k>`` /
        ``param_norm_head``; with lambdas ``lambda_init_l<k>`` (the
        schedule),
      - optional ``grad_norm_*`` from the train step's per-group
        gradient norms (embed, each block, head).
    """
    rec = {}
    lams = summary_out.get("lambdas")
    if lams is not None:
        lams = lams.detach().cpu().tolist()
        for li, lam in enumerate(lams, 1):
            rec[f"lambda_init_l{li}"] = round(float(lambda_init_schedule(li)), 6)
            if isinstance(lam, float):  # diff: one per layer
                rec[f"lambda_l{li}"] = round(lam, 6)
            else:  # ndiff: one per term per layer
                for tj, v in enumerate(lam):
                    rec[f"lambda_l{li}_t{tj}"] = round(v, 6)
    norms = summary_out["param_norms"]
    rec["param_norm_embed"] = round(float(norms["embed"]), 4)
    for li, v in enumerate(norms["blocks"].tolist(), 1):
        rec[f"param_norm_l{li}"] = round(v, 4)
    rec["param_norm_head"] = round(float(norms["head"]), 4)
    if grad_norms is not None:
        g = [float(v) for v in grad_norms]
        rec["grad_norm_embed"] = round(g[0], 6)
        for li in range(1, len(g) - 1):
            rec[f"grad_norm_l{li}"] = round(g[li], 6)
        rec["grad_norm_head"] = round(g[-1], 6)
    return rec
