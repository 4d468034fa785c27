"""Pipeline parallelism: GPipe microbatch scheduling over the mesh's
``pipeline`` axis.

Counterpart of ``differential_transformer_replication_tpu/parallel/
pipeline.py``. The transformer's layers split into P contiguous stages,
one per position of this rank's pipeline line (``parallel/mesh.py``: the
last, stride-1 axis, so neighbouring stages are neighbouring ranks), and
the microbatches stream through the stages, each stage's output sent to
the next stage's rank (``mesh.send_``/``mesh.recv_``).

- **Layers per stage.** Stage s holds layers ``s * Lp .. (s + 1) * Lp -
  1`` (Lp = n_layer / P) as its slice of the ``blocks`` list, params and
  AdamW moments alike (:func:`stage_state`), and passes block j its
  GLOBAL 1-based index ``s * Lp + j + 1``: the lambda init schedule reads
  it (JAX ``pipeline.py:256``). The embeddings, ``ln_f`` and ``lm_head``
  are replicated on every stage.
- **The GPipe schedule.** With M microbatches (the ``grad_acc_steps``
  axis of the batch: pipeline microbatching is gradient accumulation),
  tick t has stage s work on microbatch ``t - s``: stage 0 embeds the fed
  microbatch (only stage 0 embeds), each stage runs its layers and sends
  the output on; the last stage runs ``tail_and_loss`` (which honours
  ``loss_chunk``) and sums ``loss_m / M``. The backward runs the ticks
  in reverse: the last stage starts from each microbatch's loss, and
  each stage sends the gradient of its input to the stage before, one
  ``torch.autograd.grad`` per microbatch, where JAX differentiates its
  tick scan. Bubble ticks compute nothing (JAX computes on garbage and
  masks it out), so keep M >= P. Each send is an ``isend`` waited for at
  the end of its tick, each receive an ``irecv`` waited for before the
  tick's compute: the forward's traffic goes one way and the backward's
  the other, so no two stages wait on each other. GPipe keeps every microbatch's activations alive
  until its backward, as JAX's scan residuals do; ``cfg.remat`` applies
  per layer (``models/common.py:remat_block``).
- **Loss, gradients, norm.** The loss is the microbatch mean on the last
  stage, summed over the plane of every axis but tensor (the other
  stages add 0) and divided by the batch shards: every rank holds the
  mean. The gradients of the replicated leaves (embeddings from stage 0,
  ``ln_f``/``lm_head`` from the last stage, zeros elsewhere) are summed
  over that same plane, so every stage holds the same bits and updates
  them alike; the block gradients over the plane of every axis but tensor
  and pipeline (the ranks holding the same layers). The global gradient
  norm, which the clip reads, counts the block squares of every stage and
  each replicated leaf once (under tensor through
  ``sharding.tensor_group_sq``'s per-leaf counting): one clip for all
  stages. The metrics are JAX's: ``loss``, ``learning_rate``,
  ``grad_norm``.
- **Dropout** is live with a seed: the step's seed is folded with this
  rank's position over data, fsdp and sequence (JAX folds ``data * fsdp
  + fsdp_idx``, the same number where sequence is 1), then with the
  microbatch index, then with the global layer index, in JAX's order
  (``pipeline.py:237-244``, ``:285``, ``:257``), with
  ``ops/dropout.py:fold_seed``; the attention folds the tensor index in
  itself (``parallel/shard_flash.py:attention_seed``).

Composition, by running each stage's layers as the one-card forward
does on the other axes:

- ``data`` and ``fsdp`` split the microbatch rows (``shard_batch``).
  fsdp is a second data axis here: params and AdamW's moments are
  replicated over it, not sharded (a warning says so; no ``FsdpLayout``).
- ``tensor``: each stage's params are the ``TensorLayout`` cut of its
  layers, and its forward crosses ``parallel/regions.py``'s boundaries
  with head-sharded attention, as the flat step's does. JAX instead
  gathers the attention's operands and runs its kernel replicated.
- ``sequence``: each stage runs its sequence line's ring or Ulysses
  (``ModelConfig.sequence_impl``) on the rank's T-shard. JAX's pipeline
  ignores ``sequence_impl`` and lets GSPMD gather K/V.
- The SwiGLU runs the fused kernel by device, as everywhere in the port
  (JAX's pipeline forces its XLA composition).

Restrictions (checked, with JAX's texts): pipeline >= 2, ``n_layer % P
== 0`` and ``micro_batch_size`` divisible by data x fsdp.
"""

from __future__ import annotations

import warnings

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.models import common, control, diff, ndiff
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.ops.rope import rope_cos_sin
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    AXES,
    Mesh,
    all_gather_,
    all_reduce_sum_,
    recv_,
    send_,
)
from differential_transformer_replication_tpu_torch.parallel.sharding import (
    shard_batch,
    tensor_group_sq,
    tensor_norm_slots,
)
from differential_transformer_replication_tpu_torch.train.optim import (
    adamw_update,
    clip_by_global_norm,
    cosine_warmup_schedule,
    leaves,
    unflatten,
)
from differential_transformer_replication_tpu_torch.train.step import create_train_state

_MODULES = {"control": control, "diff": diff, "ndiff": ndiff}


# ---------------------------------------------------------------------------
# param layout: list-of-blocks <-> stage-stacked, and the stage's cut
# ---------------------------------------------------------------------------


def _stack(blocks: list):
    first = blocks[0]
    if isinstance(first, dict):
        return {k: _stack([b[k] for b in blocks]) for k in first}
    return torch.stack([b.detach() for b in blocks])


def _unstack(tree, n: int) -> list:
    if isinstance(tree, dict):
        parts = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: parts[k][i] for k in tree} for i in range(n)]
    return [tree[i] for i in range(n)]


def stack_blocks(params: dict) -> dict:
    """Model params with the per-layer ``blocks`` list stacked on a
    leading layer axis (JAX's stage-stacked layout); the other entries
    pass through."""
    out = dict(params)
    out["blocks"] = _stack(list(params["blocks"]))
    return out


def unstack_blocks(params: dict, n_layer: int) -> dict:
    """Inverse of :func:`stack_blocks`: back to the list of per-layer
    dicts (views of the stacked leaves)."""
    out = dict(params)
    out["blocks"] = _unstack(params["blocks"], n_layer)
    return out


def _check_pipeline_cfg(model_cfg: ModelConfig, mesh: Mesh) -> int:
    """The pipeline's refusals and warnings (JAX's texts where JAX has
    them); returns the stage count."""
    shape = dict(zip(AXES, mesh.shape))
    n_stages = shape["pipeline"]
    if n_stages < 2:
        raise ValueError(f"pipeline axis must be > 1, got mesh {shape}")
    if shape["fsdp"] != 1:
        warnings.warn(
            "under pipeline parallelism the fsdp axis acts as a SECOND DATA "
            "axis only: non-block params and all optimizer state are "
            "replicated, not ZeRO-sharded (parallel/pipeline.py:stage_state). "
            "Use the sharded step (no --pipeline-parallel) for real parameter "
            "sharding",
            stacklevel=3,
        )
    if model_cfg.n_layer % n_stages:
        raise ValueError(
            f"n_layer={model_cfg.n_layer} not divisible by pipeline={n_stages}"
        )
    return n_stages


def stage_state(state: dict, mesh: Mesh) -> dict:
    """A full train state cut to this rank's stage: the blocks of its
    layers (params and AdamW's moments; the same tensors), the replicated
    leaves whole."""
    P, s = mesh.n_stages, mesh.stage
    n = len(state["params"]["blocks"])
    if n % P:
        raise ValueError(f"n_layer={n} not divisible by pipeline={P}")
    lp = n // P

    def cut(tree):
        out = dict(tree)
        out["blocks"] = list(tree["blocks"][s * lp:(s + 1) * lp])
        return out

    opt = state["opt_state"]
    out = dict(state)
    out["params"] = cut(state["params"])
    out["opt_state"] = {"mu": cut(opt["mu"]), "nu": cut(opt["nu"]),
                        "count": opt["count"]}
    return out


def gather_stage_tree(tree: dict, mesh: Mesh) -> dict:
    """The full param-layout tree (every stage's blocks, in layer order;
    fresh fp32 tensors) of this stage's: one all-gather of the stage's
    flat blocks over the pipeline line, which every rank of it joins."""
    pl = mesh.line("pipeline")
    if pl.size == 1:
        return tree
    blocks = list(tree["blocks"])
    ts = [t.detach() for t in leaves(blocks)]
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in ts])
    got = torch.empty(pl.size * flat.numel(), dtype=torch.float32, device=flat.device)
    got = all_gather_(got, flat, pl).view(pl.size, flat.numel())
    sizes = [t.numel() for t in ts]
    out = {k: unflatten(v, [t.detach().clone() for t in leaves(v)])
           for k, v in tree.items() if k != "blocks"}
    out["blocks"] = []
    for s in range(pl.size):
        parts = torch.split(got[s], sizes)
        out["blocks"] += unflatten(blocks, [p.view(t.shape).clone()
                                            for p, t in zip(parts, ts)])
    return out


def gather_stage_state(state: dict, mesh: Mesh) -> dict:
    """The full train state (canonical list of blocks) of this stage's:
    params and AdamW's moments gathered over the pipeline line."""
    opt = state["opt_state"]
    out = dict(state)
    out["params"] = gather_stage_tree(state["params"], mesh)
    out["opt_state"] = {"mu": gather_stage_tree(opt["mu"], mesh),
                        "nu": gather_stage_tree(opt["nu"], mesh),
                        "count": opt["count"]}
    return out


def create_pipeline_train_state(gen: torch.Generator, cfg: TrainConfig,
                                mesh: Mesh) -> dict:
    """This rank's train state: the full state drawn from ``gen`` (the
    params a one-rank run draws), cut to its stage's layers, then to its
    tensor shard."""
    from differential_transformer_replication_tpu_torch.parallel.sharding import (
        tensor_layout,
    )

    _check_pipeline_cfg(cfg.resolved_model(), mesh)
    state = stage_state(create_train_state(gen, cfg, mesh.device), mesh)
    tl = tensor_layout(mesh)
    return state if tl is None else tl.shard_state(state)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


def _rope(mod, cfg: ModelConfig, T: int, sg, device) -> tuple:
    """The RoPE tables of this rank's positions (None, None without
    RoPE), as the families' ``forward`` makes them."""
    if not mod.USES_ROPE:
        return None, None
    t0 = common.shard_start(T, sg)
    return tuple(t[t0:] for t in rope_cos_sin(cfg.head_size, t0 + T, device=device))


def make_pipeline_loss(model_cfg: ModelConfig, mesh: Mesh):
    """``loss(params, x, y, seed=None, grads=False)`` on this rank of
    ``mesh``: ``params`` the stage's (its tensor shard), ``x``/``y`` this
    rank's (M, B, T) microbatches (its rows and T-shard; ``x`` is read on
    stage 0, ``y`` on the last stage). Returns the microbatch-mean loss
    averaged over the batch shards (a 0-d tensor, equal on every rank),
    with ``grads`` also the stage's gradients in :func:`leaves` order
    (summed over the ranks as the module docstring says, divided by M and
    the batch shards), as ``(loss, grads)``. With ``seed`` and
    ``model_cfg.dropout > 0`` dropout is live (module docstring);
    without one it is inert."""
    n_stages = _check_pipeline_cfg(model_cfg, mesh)
    mod = _MODULES[model_cfg.model]
    lp = model_cfg.n_layer // n_stages
    s = mesh.stage
    first, last = s == 0, s == n_stages - 1
    pl = mesh.line("pipeline")
    rest_plane = mesh.plane("tensor")  # loss and replicated leaves
    block_plane = mesh.plane("tensor", "pipeline")
    n_batch = mesh.n_batch
    sg = mesh.sequence_group
    block = common.remat_block(mod.block_forward, model_cfg) if model_cfg.remat \
        else mod.block_forward
    cdtype = common.compute_dtype(model_cfg)

    def stage_fn(h, params, cos, sin, mb_seed):
        for j, blk in enumerate(params["blocks"]):
            li = s * lp + j + 1  # the global 1-based layer index
            r = None if mb_seed is None else fold_seed(mb_seed, li)
            h = block(h, blk, li, model_cfg, cos, sin, r, sg)
        return h

    def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor, seed=None,
                grads: bool = False):
        M, B, T = x.shape
        E = params["ln_f"]["w"].shape[-1]
        live = seed is not None and model_cfg.dropout > 0.0
        base = fold_seed(seed, mesh.replicated_position) if live else None
        cos, sin = _rope(mod, model_cfg, T, sg, x.device)
        plist = leaves(params)
        inputs, outputs, losses = [], [], []
        loss = torch.zeros((), dtype=torch.float32, device=x.device)
        with torch.set_grad_enabled(grads):
            # the forward ticks: stage s works on microbatch t - s
            for m in range(M):
                if first:
                    h = mod.embed(params, x[m], model_cfg, sg)
                else:
                    h = recv_(torch.empty((B, T, E), dtype=cdtype, device=x.device),
                              pl, s - 1)
                    h.requires_grad_(grads)
                out = stage_fn(h, params, cos, sin,
                               None if base is None else fold_seed(base, m))
                if last:
                    _, lm = common.tail_and_loss(out, params, model_cfg, y[m], sg)
                    loss = loss + lm.detach().to(torch.float32)
                    losses.append(lm)
                else:
                    send_(out, pl, s + 1)
                if grads:
                    inputs.append(h)
                    outputs.append(out)
            loss = loss / M if last else loss
        g = None
        if grads:
            acc = [None] * len(plist)
            # the backward ticks, in reverse: the last stage starts from
            # each microbatch's loss, the others from the gradient the
            # next stage sends back
            for m in reversed(range(M)):
                h = inputs[m]
                wrt = plist + ([] if first else [h])
                if last:
                    gi = torch.autograd.grad(losses[m], wrt, allow_unused=True)
                    losses[m] = None
                else:
                    g_out = recv_(torch.empty_like(outputs[m]), pl, s + 1)
                    gi = torch.autograd.grad(outputs[m], wrt, g_out, allow_unused=True)
                inputs[m] = outputs[m] = None
                if not first:
                    send_(gi[-1], pl, s - 1)
                for i, t in enumerate(gi[:len(plist)]):
                    if t is not None:
                        acc[i] = t if acc[i] is None else acc[i] + t
            g = [torch.zeros_like(p) if a is None else a / M
                 for p, a in zip(plist, acc)]
        # the loss and the replicated leaves' gradients over the plane of
        # every axis but tensor; the blocks' over the ranks of this stage's
        # layers (one flat all-reduce each). "blocks" sorts first among the
        # param keys: its leaves lead ``leaves(params)``
        nb = len(leaves(params["blocks"]))
        rest = [loss.reshape(1)] + ([] if g is None else [t.reshape(-1) for t in g[nb:]])
        flat = all_reduce_sum_(torch.cat(rest), rest_plane)
        if n_batch > 1:
            flat.div_(n_batch)
        if g is None:
            return flat[0]
        bflat = all_reduce_sum_(torch.cat([t.reshape(-1) for t in g[:nb]]), block_plane)
        if n_batch > 1:
            bflat.div_(n_batch)
        sizes = [t.numel() for t in g]
        parts = (list(torch.split(bflat, sizes[:nb]))
                 + list(torch.split(flat[1:], sizes[nb:])))
        return flat[0], [p.view(t.shape) for p, t in zip(parts, g)]

    return loss_fn


# ---------------------------------------------------------------------------
# train / eval steps
# ---------------------------------------------------------------------------


def make_pipeline_train_step(cfg: TrainConfig, mesh: Mesh, batch_is_local: bool = False):
    """``step(state, batch, seed=None) -> (state, metrics)`` on this rank
    of ``mesh``: the state is the stage's (:func:`create_pipeline_train_state`
    or :func:`stage_state`), ``batch`` the global ``{"x", "y"}`` (A, B, T)
    batch, of which the rank keeps its rows and T-shard (already this
    rank's with ``batch_is_local``); the grad-accumulation axis A is the
    microbatch stream. The update is AdamW after one global-norm clip,
    in place; the metrics are JAX's (``loss``, ``learning_rate``,
    ``grad_norm``), host floats."""
    model_cfg = cfg.resolved_model()
    # TrainConfig refused a micro-batch that data x fsdp cannot split
    n_stages = _check_pipeline_cfg(model_cfg, mesh)
    if cfg.grad_acc_steps < n_stages:
        warnings.warn(
            f"grad_acc_steps={cfg.grad_acc_steps} < pipeline stages "
            f"{n_stages}: the GPipe bubble dominates; use at least "
            f"{n_stages} (ideally a few x) microbatches",
            stacklevel=2,
        )
    schedule = cosine_warmup_schedule(cfg.learning_rate, cfg.warmup_iters,
                                      cfg.max_iters, cfg.min_lr)
    loss_f = make_pipeline_loss(model_cfg, mesh)
    pl, tp = mesh.line("pipeline"), mesh.line("tensor")
    slots = []  # tensor_norm_slots of the stage's params, at the first step

    def step(state: dict, batch: dict, seed=None):
        params = state["params"]
        if not batch_is_local:
            batch = shard_batch(batch, mesh)
        loss, grads = loss_f(params, batch["x"], batch["y"], seed, grads=True)
        nb = len(leaves(params["blocks"]))
        if tp.size > 1:
            if not slots:
                slots.append(tensor_norm_slots(params, grads[0].device))
            sq = tensor_group_sq(grads, slots[0], tp)
            sq_blocks, sq_rest = sq[1:-1].sum(), sq[0] + sq[-1]
        else:
            n2 = torch.stack(torch._foreach_norm([g.to(torch.float32) for g in grads])) ** 2
            sq_blocks, sq_rest = n2[:nb].sum(), n2[nb:].sum()
        sq_blocks = all_reduce_sum_(sq_blocks.reshape(1).clone(), pl)[0]
        norm_f = float(torch.sqrt(sq_blocks + sq_rest))
        metrics = {"loss": float(loss),
                   "learning_rate": float(schedule(state["step"])),
                   "grad_norm": norm_f}
        opt = state["opt_state"]
        clipped = clip_by_global_norm(grads, norm_f, cfg.grad_clip)
        adamw_update(params, clipped, opt, schedule(opt["count"]),
                     cfg.beta1, cfg.beta2, cfg.weight_decay)
        state["step"] += 1
        return state, metrics

    return step


def make_pipeline_eval_step(cfg: TrainConfig, mesh: Mesh, batch_is_local: bool = False):
    """``eval_step(params, x, y) -> loss`` on the stage's params: one
    global (B, T) batch through the pipeline as one microbatch (bubble
    (P-1)/P: :func:`make_pipeline_eval_many` for eval loops)."""
    eval_many = make_pipeline_eval_many(cfg, mesh, batch_is_local)

    def eval_step(params: dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        return eval_many(params, x[None], y[None])

    return eval_step


def make_pipeline_eval_many(cfg: TrainConfig, mesh: Mesh, batch_is_local: bool = False):
    """``eval_many(params, xs, ys) -> mean loss`` (a 0-d tensor) over a
    stacked (K, B, T) eval set, fed through the pipeline as ONE
    K-microbatch stream, no grad, no dropout: the bubble is
    (P-1)/(K+P-1) instead of (P-1)/P at each of the eval batches. The
    mean over the stream is the mean of the per-batch losses (equal batch
    sizes)."""
    loss_f = make_pipeline_loss(cfg.resolved_model(), mesh)

    @torch.no_grad()
    def eval_many(params: dict, xs: torch.Tensor, ys: torch.Tensor) -> torch.Tensor:
        if not batch_is_local:
            b = shard_batch({"x": xs, "y": ys}, mesh)
            xs, ys = b["x"], b["y"]
        return loss_f(params, xs, ys)

    return eval_many


__all__ = [
    "create_pipeline_train_state",
    "gather_stage_state",
    "gather_stage_tree",
    "make_pipeline_eval_many",
    "make_pipeline_eval_step",
    "make_pipeline_loss",
    "make_pipeline_train_step",
    "stack_blocks",
    "stage_state",
    "unstack_blocks",
]
