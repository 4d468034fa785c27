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

from types import SimpleNamespace

import numpy as np
import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig


def _to_tensor(a, device, dtype) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        t = a.detach().clone()
    else:
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
    with ``mu``, ``nu`` and ``count``, or a map of them as a checkpoint's
    state dict holds it), found by walking tuples, lists and maps."""
    if isinstance(node, dict):
        if {"mu", "nu", "count"} <= set(node):
            return SimpleNamespace(**node)
        node = [node[k] for k in sorted(node)]
    if all(hasattr(node, a) for a in ("mu", "nu", "count")):
        return node
    if isinstance(node, (tuple, list)):
        for child in node:
            found = _find_adam(child)
            if found is not None:
                return found
    return None


def train_state_from_jax(state, cfg: ModelConfig, device="cpu",
                         tensor=None) -> dict:
    """The port's train state (train/step.py layout) from a JAX one
    ``{"params", "opt_state", "step"[, "guard"]}`` whose leaves are
    numpy-convertible: fp32 params that require grad, the AdamW moments
    ``mu``/``nu`` in the param layout and the optimizer ``count``. With
    a ``tensor`` line (``parallel/mesh.py:Line``) of more than one rank,
    this rank's shard of it (``parallel/sharding.py:TensorLayout``)."""
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
    if tensor is not None and tensor.size > 1:
        from differential_transformer_replication_tpu_torch.parallel.sharding import (
            TensorLayout,
        )

        out = TensorLayout(tensor).shard_state(out)
    return out


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


def _host_copy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of a tensor (never a view of a live CPU tensor:
    the optimizer updates params in place), fp32 for floating leaves."""
    t = t.detach()
    if t.is_floating_point():
        t = t.to(torch.float32)
    return t.to("cpu", copy=True).numpy()


def host_tree(tree):
    """The tree with host numpy leaves and dict keys sorted, the order
    ``jax.device_get`` gives a JAX state before the JAX package writes
    it."""
    if isinstance(tree, dict):
        return {k: host_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [host_tree(v) for v in tree]
    return _host_copy(tree)


def train_state_to_jax(state: dict) -> dict:
    """The inverse of :func:`train_state_from_jax`: the port's train state
    as the JAX-shaped numpy tree the JAX package checkpoints, ``{"opt_state",
    "params", "step"}``. ``opt_state`` is the optax chain of
    ``clip_by_global_norm`` and ``adamw`` (scale_by_adam, weight decay,
    scale by schedule) as flax lays it out, ``{"0": {}, "1": {"0":
    {"count", "mu", "nu"}, "1": {}, "2": {"count"}}}``; both ``count``
    leaves carry the optimizer count, and it and ``step`` are 0-d
    ``int32``. The anomaly guard is dropped, as the JAX package drops it
    (its state is the run's own health, not the model's)."""
    opt = state["opt_state"]
    count = np.asarray(opt["count"], dtype=np.int32)
    return {
        "opt_state": {
            "0": {},
            "1": {"0": {"count": count,
                        "mu": host_tree(opt["mu"]),
                        "nu": host_tree(opt["nu"])},
                  "1": {},
                  "2": {"count": count.copy()}},
        },
        "params": host_tree(state["params"]),
        "step": np.asarray(state["step"], dtype=np.int32),
    }


def check_tree_like(want, got, where: str = "params") -> None:
    """Raise ValueError naming the first path where ``got`` differs from
    ``want`` in its keys, list lengths or leaf shapes."""
    if isinstance(want, dict):
        if not isinstance(got, dict) or set(want) != set(got):
            keys = sorted(got) if isinstance(got, dict) else type(got).__name__
            raise ValueError(f"{where}: keys {keys}, expected {sorted(want)}")
        for k in want:
            check_tree_like(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if not isinstance(got, (list, tuple)) or len(got) != len(want):
            raise ValueError(f"{where}: {type(got).__name__} of "
                             f"{len(got) if isinstance(got, (list, tuple)) else '?'}"
                             f" entries, expected {len(want)}")
        for i, (w, g) in enumerate(zip(want, got)):
            check_tree_like(w, g, f"{where}[{i}]")
    elif tuple(want.shape) != tuple(got.shape):
        raise ValueError(f"{where}: shape {tuple(got.shape)}, expected "
                         f"{tuple(want.shape)}")
