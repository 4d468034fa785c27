"""The training step on a mesh of ranks: data parallelism and FSDP.

Counterpart of ``differential_transformer_replication_tpu/parallel/
dp_step.py``. :func:`make_sharded_train_step` routes as JAX's does:

1. **Overlap-scheduled DP** (a pure data mesh, ``TrainConfig.dp_overlap``
   on, :func:`overlap_eligible`): every rank runs the single-card step
   body on its batch shard, and the params pass through
   :func:`make_param_sync`: one identity-forward autograd Function per
   gradient bucket whose backward sums that bucket's cotangents over the
   data line and takes their mean (JAX's custom-vjp ``pmean``). A bucket's
   Function is applied where the forward first reaches the bucket, so
   autograd's ready queue (latest-made node first) runs its backward as
   soon as the bucket's cotangents exist: the tail, then the blocks from
   the last layer down, then the embeddings. With ``grad_acc_steps > 1``
   the microbatches accumulate LOCAL grads and one whole-tree mean runs
   after the loop (JAX's ``grad_sync``). The step's dropout seed is
   folded with the data index, so every shard draws its own masks (JAX
   ``dp_step.py:191-200``).
2. **The flat step** (any other mesh without fsdp: data beside sequence
   or tensor, the ring or Ulysses alone, tensor alone, or ``dp_overlap``
   off): the step body runs with the mesh threaded into the forward (on
   a tensor line through the region collectives of
   ``parallel/regions.py``), and one all-reduce of the loss and every
   gradient over the plane of every axis but ``tensor`` follows the
   backward, divided by the batch shards (what GSPMD's partitioner
   inserts in JAX).
3. **The sharded (FSDP) step** (fsdp > 1): the state at rest is this
   rank's flat shards (``parallel/sharding.py:FsdpLayout``). Each bucket
   is all-gathered over the fsdp line where the forward first reaches it,
   by an autograd Function whose backward reduce-scatters the bucket's
   gradient over the fsdp line and sums it over the ranks that hold the
   same shard (mean over data x fsdp). The gathered tensors live as long
   as the autograd graph holds them (a remat block's recompute reads
   them again in the backward) and are freed with it after the step.
   Global-norm clipping, the per-group norms and AdamW then run on the
   shards, their squared sums reduced over the fsdp line. With tensor
   the FSDP layout cuts the rank's tensor shard (JAX's test mesh is
   ``data=2, fsdp=2, tensor=2``), the gradients are summed over the
   plane of every axis but fsdp and tensor, and the loss over the plane
   of every axis but tensor.

:func:`shard_train_state` turns a full train state into a rank's state
at rest (its tensor shard, then the fsdp shards of that) and
:func:`full_train_state` gathers it back (a checkpoint's);
:func:`model_params` is what the forward takes (the tensor shard) and
:func:`full_params` the whole tree (eval's lambda summaries).

Over gloo with CUDA tensors every collective stages through pinned host
memory (``parallel/mesh.py``), so a bucket's sync is synchronous with
the host: on ranks sharing one card the overlap cannot show.

JAX's ``_attach_compile_counter`` has no counterpart: eager PyTorch
compiles nothing (ROADMAP "Settled").
"""

from __future__ import annotations

import torch

from differential_transformer_replication_tpu_torch.config import TrainConfig
from differential_transformer_replication_tpu_torch.ops.dropout import fold_seed
from differential_transformer_replication_tpu_torch.parallel.mesh import (
    Line,
    Mesh,
    all_reduce_sum_,
)
from differential_transformer_replication_tpu_torch.parallel.pipeline import (
    gather_stage_state,
    gather_stage_tree,
    stage_state,
)
from differential_transformer_replication_tpu_torch.parallel.sharding import (
    FsdpLayout,
    param_buckets,
    shard_batch,
    tensor_layout,
)
from differential_transformer_replication_tpu_torch.train.optim import leaves, unflatten
from differential_transformer_replication_tpu_torch.train.step import make_step_fn


def overlap_eligible(cfg: TrainConfig) -> bool:
    """The bucketed-mean path covers pure data parallelism only: fsdp
    shards the params themselves and sequence needs the forward's own
    exchanges. JAX's ``jax.process_count() == 1`` clause has no
    counterpart: the port's ranks are always processes."""
    m = cfg.mesh
    return (cfg.dp_overlap and m.data > 1 and m.fsdp == 1 and m.tensor == 1
            and m.sequence == 1 and m.pipeline == 1)


# ---------------------------------------------------------------------------
# params whose buckets come into being where the forward first reaches them
# ---------------------------------------------------------------------------


class _LazyBlocks:
    """The blocks list of a :class:`LazyParams`: reaching block i makes its
    bucket."""

    def __init__(self, owner: "LazyParams"):
        self._owner = owner

    def __len__(self) -> int:
        return self._owner._n_layer

    def __getitem__(self, i: int) -> dict:
        return self._owner._block(i)

    def __iter__(self):
        return (self._owner._block(i) for i in range(len(self)))


class LazyParams:
    """A param tree for the model forward whose buckets (``sharding.
    param_buckets``) are made by ``make(i) -> subtree`` at their first
    access, in the order the forward reaches them."""

    def __init__(self, buckets: list, n_layer: int, make):
        self._buckets, self._n_layer, self._make = buckets, n_layer, make
        self._made = {}
        self._top = {k: i for i, b in enumerate(buckets) for k in b.keys}

    def _bucket(self, i: int):
        if i not in self._made:
            self._made[i] = self._make(i)
        return self._made[i]

    def _block(self, j: int) -> dict:
        for i, b in enumerate(self._buckets):
            if not b.keys and b.start <= j < b.stop:
                return self._bucket(i)[j - b.start]
        raise IndexError(j)

    def __getitem__(self, key: str):
        if key == "blocks":
            return _LazyBlocks(self)
        return self._bucket(self._top[key])[key]


class _BucketSync(torch.autograd.Function):
    """Identity forward; the backward sums the bucket's cotangents over
    the data line, in one flat buffer, and divides by its size (JAX's
    ``_bucket_sync``: ``lax.pmean``)."""

    @staticmethod
    def forward(ctx, line, *ts):
        ctx.line = line
        return tuple(t.view_as(t) for t in ts)

    @staticmethod
    def backward(ctx, *gs):
        flat = torch.cat([g.reshape(-1) for g in gs])
        all_reduce_sum_(flat, ctx.line).div_(ctx.line.size)
        parts = torch.split(flat, [g.numel() for g in gs])
        return (None, *(f.view(g.shape) for f, g in zip(parts, gs)))


def make_param_sync(line: Line, bucket_layers: int):
    """``params -> params`` with one :class:`_BucketSync` per gradient
    bucket (the embedding table(s), every ``bucket_layers`` consecutive
    blocks, the ln_f/lm_head tail), each applied where the forward first
    reaches its bucket. Backward runs tail -> blocks(L..1) ->
    embeddings."""

    def param_sync(params: dict) -> LazyParams:
        buckets = param_buckets(params, bucket_layers)

        def make(i):
            sub = buckets[i].subtree(params)
            return unflatten(sub, _BucketSync.apply(line, *leaves(sub)))

        return LazyParams(buckets, len(params["blocks"]), make)

    return param_sync


def tree_mean(line: Line):
    """JAX's ``grad_sync`` and ``loss_sync``: the mean over ``line`` of a
    list of tensors (one flat all-reduce) or of a 0-d loss."""

    def sync(x):
        if isinstance(x, torch.Tensor):
            return all_reduce_sum_(x.reshape(1).clone(), line)[0] / line.size
        flat = torch.cat([g.reshape(-1) for g in x])
        all_reduce_sum_(flat, line).div_(line.size)
        parts = torch.split(flat, [g.numel() for g in x])
        return [f.view(g.shape) for f, g in zip(parts, x)]

    return sync


def _make_overlap_train_step(cfg: TrainConfig, mesh: Mesh, batch_is_local: bool):
    line = mesh.line("data")
    sync = tree_mean(line)
    # group=None: every shard runs the single-card forward on its rows
    inner = make_step_fn(cfg, None, param_sync=make_param_sync(line, cfg.dp_bucket_layers),
                         loss_sync=sync, grad_sync=sync)

    def step(state: dict, batch: dict, seed=None):
        if seed is not None:
            seed = fold_seed(seed, mesh.axis_index("data"))
        return inner(state, batch if batch_is_local else shard_batch(batch, mesh), seed)

    return step


# ---------------------------------------------------------------------------
# FSDP
# ---------------------------------------------------------------------------


class _GatherBucket(torch.autograd.Function):
    """Bucket ``i``'s full flat vector from this rank's shard; the
    backward is the layout's reduce-scatter and mean
    (``FsdpLayout.reduce_grad``)."""

    @staticmethod
    def forward(ctx, shard, layout: FsdpLayout, i: int):
        ctx.layout, ctx.i = layout, i
        return layout.gather_flat(i, shard)

    @staticmethod
    def backward(ctx, g):
        return ctx.layout.reduce_grad(ctx.i, g), None, None


def make_param_gather(layout: FsdpLayout):
    """``shards -> params``: bucket i all-gathered where the forward first
    reaches it, through :class:`_GatherBucket`."""

    def gather(shards: list) -> LazyParams:
        def make(i):
            return layout.unflat(i, _GatherBucket.apply(shards[i], layout, i))

        return LazyParams(layout.buckets, layout.n_layer, make)

    return gather


def _make_fsdp_train_step(cfg: TrainConfig, mesh: Mesh, layout: FsdpLayout,
                          batch_is_local: bool):
    # every rank of a tensor line holds the same loss: sum over the rest
    plane = mesh.plane("tensor")

    def loss_sync(loss):
        return all_reduce_sum_(loss.reshape(1).clone(), plane)[0] / mesh.n_batch

    # the mesh threads into the forward: rows and T-shard by shard_batch,
    # the sequence line, the dropout fold
    return make_step_fn(cfg, mesh, param_sync=make_param_gather(layout),
                        loss_sync=loss_sync, layout=layout, batch_is_local=batch_is_local)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------


def fsdp_layout(cfg: TrainConfig, mesh: Mesh, params: dict):
    """The FSDP layout of ``params`` on ``mesh`` (None without fsdp, and
    under pipeline, where fsdp is a second data axis)."""
    if mesh.axis_size("fsdp") == 1 or mesh.axis_size("pipeline") > 1:
        return None
    return FsdpLayout(params, mesh, cfg.dp_bucket_layers)


def shard_train_state(cfg: TrainConfig, mesh: Mesh, state: dict) -> tuple:
    """(this rank's train state at rest, its FSDP layout or None) from a
    full state: under pipeline its stage's layers
    (``pipeline.stage_state``), then the tensor shard
    (``sharding.TensorLayout``), then under fsdp that shard's flat
    shards."""
    if mesh.axis_size("pipeline") > 1:
        state = stage_state(state, mesh)
    tl = tensor_layout(mesh)
    if tl is not None:
        state = tl.shard_state(state)
    layout = fsdp_layout(cfg, mesh, state["params"])
    if layout is not None:
        state = layout.shard_state(state)
    return state, layout


def model_params(params, layout):
    """The param tree the forward takes: the rank's tensor shard (the
    fsdp shards gathered where ``layout`` is set)."""
    return params if layout is None else layout.gather_tree(params)


def full_params(params, mesh, layout) -> dict:
    """The whole param tree of a rank's params at rest (every rank of
    the mesh joins): the fsdp gather, the tensor gather, then under
    pipeline every stage's blocks."""
    tree = model_params(params, layout)
    if mesh is None:
        return tree
    tl = tensor_layout(mesh)
    if tl is not None:
        tree = tl.gather_tree(tree)
    return gather_stage_tree(tree, mesh)


def full_train_state(state: dict, mesh, layout) -> dict:
    """The full train state of a rank's state at rest (every rank
    joins): the fsdp gather, then the tensor gather, then under pipeline
    the stages' gather (the canonical list of blocks)."""
    if layout is not None:
        state = layout.gather_state(state)
    if mesh is None:
        return state
    tl = tensor_layout(mesh)
    if tl is not None:
        state = tl.gather_state(state)
    return gather_stage_state(state, mesh)


def make_sharded_train_step(cfg: TrainConfig, mesh: Mesh, layout=None,
                            batch_is_local: bool = False):
    """``step(state, batch, seed=None) -> (state, metrics)`` on this rank
    of ``mesh``, given the GLOBAL batch (each rank keeps its
    ``shard_batch`` slice; ``batch_is_local``: the batch is that slice
    already, ``multihost.local_batch``): the overlap path on a pure data
    mesh with ``dp_overlap``, the sharded step with fsdp (``layout``, from
    :func:`fsdp_layout`; the state is then its shards), else the flat
    step (module docstring). A pipeline mesh takes
    ``pipeline.make_pipeline_train_step``, as JAX's trainer does."""
    if mesh.axis_size("pipeline") > 1:
        raise ValueError("a pipeline mesh trains through "
                         "parallel/pipeline.py:make_pipeline_train_step")
    if overlap_eligible(cfg):
        return _make_overlap_train_step(cfg, mesh, batch_is_local)
    if mesh.axis_size("fsdp") > 1:
        if layout is None:
            raise ValueError("an fsdp mesh needs the state's FsdpLayout")
        return _make_fsdp_train_step(cfg, mesh, layout, batch_is_local)
    return make_step_fn(cfg, mesh, batch_is_local=batch_is_local)
