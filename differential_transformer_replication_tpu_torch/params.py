"""The weight bridge between the JAX package and the port.

The two packages share one param layout (Linear ``w`` is ``(in, out)``,
``wq``/``wk`` ``(S, E, H, d)``, ``wv`` ``(E, H, dv)``, LayerNorm
``{"w", "b"}``), so a JAX param tree crosses as its numpy leaves with no
transpose: ``params_from_jax(jax.tree.map(np.asarray, tree), cfg, ...)``
on one side, :func:`params_to_numpy` on the other. No JAX is imported:
anything ``numpy.asarray`` accepts is a valid leaf.
:func:`train_state_from_jax` carries a whole JAX train state (params,
the optax AdamW moments and count, the step, the guard) the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig


def _to_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.kind == "V" or arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)  # numpy has no native bfloat16
    t = torch.tensor(arr)  # a copy: the source may be read-only
    if t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_jax(tree, cfg: ModelConfig, device="cpu",
                    dtype: torch.dtype = torch.float32) -> dict:
    """The port's param tree (torch tensors on ``device``, floating
    leaves in ``dtype``) from a JAX param tree of numpy-convertible
    leaves. Checks the tree against ``cfg``."""

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [walk(v) for v in node]
        return _to_tensor(node, device, dtype)

    params = walk(tree)
    E = cfg.n_embd
    if tuple(params["tok_emb"].shape) != (cfg.vocab_size, E):
        raise ValueError(
            f"tok_emb is {tuple(params['tok_emb'].shape)}, config wants "
            f"({cfg.vocab_size}, {E})"
        )
    if len(params["blocks"]) != cfg.n_layer:
        raise ValueError(
            f"{len(params['blocks'])} blocks, config wants {cfg.n_layer}"
        )
    wv = params["blocks"][0]["attn"]["wv"]
    if tuple(wv.shape) != (E, cfg.n_head, cfg.value_size):
        raise ValueError(
            f"wv is {tuple(wv.shape)}, config wants "
            f"({E}, {cfg.n_head}, {cfg.value_size})"
        )
    if (cfg.model == "diff") != ("pos_emb" in params):
        raise ValueError("pos_emb present iff the model is the diff family")
    return params


def params_to_numpy(params):
    """The same tree with numpy leaves (float32 for floating tensors)."""
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, list):
        return [params_to_numpy(v) for v in params]
    t = params.detach().cpu()
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.numpy()


def _find_adam(node):
    """The optax ScaleByAdamState inside an optax chain state (any object
    with ``mu``, ``nu`` and ``count``), found by walking tuples."""
    if all(hasattr(node, a) for a in ("mu", "nu", "count")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, cfg: ModelConfig, device="cpu") -> dict:
    """The port's train state (train/step.py layout) from a JAX one
    ``{"params", "opt_state", "step"[, "guard"]}`` whose leaves are
    numpy-convertible: fp32 params that require grad, the AdamW moments
    ``mu``/``nu`` in the param layout and the optimizer ``count``."""
    import numpy as np

    adam = _find_adam(state["opt_state"])
    if adam is None:
        raise ValueError("no AdamW state (mu, nu, count) in opt_state")
    params = params_from_jax(state["params"], cfg, device)
    for leaf in _leaves(params):
        leaf.requires_grad_(True)
    out = {
        "params": params,
        "opt_state": {"mu": params_from_jax(adam.mu, cfg, device),
                      "nu": params_from_jax(adam.nu, cfg, device),
                      "count": int(np.asarray(adam.count))},
        "step": int(np.asarray(state["step"])),
    }
    if "guard" in state:
        g = state["guard"]
        out["guard"] = {"ema": np.float32(np.asarray(g["ema"])),
                        "good_steps": int(np.asarray(g["good_steps"])),
                        "bad_streak": int(np.asarray(g["bad_streak"])),
                        "skipped": int(np.asarray(g["skipped"]))}
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]
