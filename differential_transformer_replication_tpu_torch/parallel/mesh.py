"""The mesh of ranks of the port.

Counterpart of ``differential_transformer_replication_tpu/parallel/
mesh.py`` (``create_mesh``): the ``torch.distributed`` ranks that
``torchrun`` starts, laid out on the axes of ``MeshConfig`` in JAX's
order ``(data, fsdp, tensor, sequence, pipeline)`` (JAX
``config.py:MeshConfig.axis_names``): world rank r sits at the row-major
coordinates of r over ``MeshConfig.shape``, as JAX reshapes its device
list. The port runs every axis. ``pipeline`` is the last, stride-1
axis (JAX ``config.py:MeshConfig.axis_names``): neighbouring stages are
neighbouring ranks; :attr:`Mesh.stage` and :attr:`Mesh.n_stages` say
where this rank stands on it.

:func:`create_mesh` joins the world (or the default group the process
already joined) and makes one ``dist.new_group`` for each line of each
axis whose size is > 1. ``new_group`` is collective over the world even
for ranks outside the group, so every rank makes every line, in one
order; each keeps its own. A :class:`Line` is this rank's line: the
global ranks on it, by position, and its group. The mesh also makes the
planes its steps sum over: with ``tensor`` the plane of every other axis
(the ranks holding the same tensor shard: the flat step's loss and
gradient sum), under FSDP the plane of every axis but fsdp and tensor
(the ranks holding the same fsdp shard of the same tensor shard), and
with pipeline the plane of every axis but tensor and pipeline (the
ranks holding the same layers of the same tensor shard: the pipeline
step's block-gradient sum). The autograd collectives at the tensor
axis's region boundaries are in ``parallel/regions.py``.

:func:`init_sequence_group` joins a mesh whose only axis > 1 is
``sequence`` (the ring alone) and returns its :class:`SequenceGroup`,
the view of this rank's sequence line that the model and the ring take.

The backend is always named by the caller; nothing switches between
them:

- ``nccl`` needs one card per rank (NCCL refuses two ranks on one card),
  so ranks that would share a card raise, naming ``gloo``;
- ``gloo`` puts rank r on ``cuda:(LOCAL_RANK % device_count)``, so the
  ranks may share one card, or on the CPU when the caller asks for
  ``device="cpu"``. gloo moves only CPU tensors: every collective here
  stages CUDA tensors through pinned host memory (:func:`to_host`), so
  it is synchronous with the host.
"""

from __future__ import annotations

import itertools
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
AXES = ("data", "fsdp", "tensor", "sequence", "pipeline")
# the axes whose mesh position folds a dropout seed, in JAX's order
# (parallel/ring.py:sequence_shard_map; pipeline stages hold no shard)
FOLD_AXES = ("data", "fsdp", "tensor", "sequence")
# the axes of the activations every tensor rank holds in full: their
# dropout masks fold these only, so the tensor line draws one mask
REPLICATED_FOLD_AXES = ("data", "fsdp", "sequence")


@dataclass(frozen=True)
class Line:
    """This rank's line along some mesh axes: the global ``ranks`` on it
    by position, this rank's ``index`` there, and the line's process
    ``group`` (None: the default group, when the line is the world)."""

    ranks: Tuple[int, ...]
    index: int
    group: Any = None
    stages_through_host: bool = False

    @property
    def size(self) -> int:
        return len(self.ranks)


@dataclass(frozen=True)
class SequenceGroup:
    """This rank's place on its sequence line: ``rank`` (its position on
    the line) of ``size``, its ``device`` and the ``backend``; ``peers``
    the global ranks of the line's positions (None: 0 .. size - 1, the
    line is the world) and ``group`` the line's process group (None: the
    default group). ``position`` is the dropout fold of this rank's mesh
    position over data, fsdp and sequence (:data:`REPLICATED_FOLD_AXES`:
    what every rank of a tensor line shares) when the mesh has more than
    one rank, else None (the ring rank is then the fold). ``tensor`` is
    this rank's tensor line where that axis is > 1, else None: the model
    then holds its tensor shard of the params (``parallel/sharding.py``)
    and crosses the region boundaries of ``parallel/regions.py``; the
    attention folds the line's index into its own seed, so that each
    (data, fsdp, tensor, sequence) position draws its own masks, as JAX's
    ``Mesh.position`` fold makes them."""

    rank: int
    size: int
    device: torch.device
    backend: str
    owned: bool = True  # joined by init_sequence_group (it leaves it)
    peers: Optional[Tuple[int, ...]] = None
    group: Any = None
    position: Optional[int] = None
    tensor: Optional[Line] = None

    @property
    def stages_through_host(self) -> bool:
        """gloo with CUDA tensors: collectives go through host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def peer(self, pos: int) -> int:
        """The global rank at position ``pos`` (mod size) of the line."""
        pos %= self.size
        return pos if self.peers is None else self.peers[pos]


@dataclass(frozen=True)
class Mesh:
    """The ranks on the mesh axes (module docstring). ``shape`` is in
    :data:`AXES` order, ``coords`` this rank's coordinates there,
    ``lines`` this rank's :class:`Line` for each axis set the mesh made
    (keyed by the tuple of axis names)."""

    shape: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    device: torch.device
    backend: str
    lines: dict = field(default_factory=dict)
    owned: bool = True  # create_mesh joined the world (destroy_mesh leaves it)
    made: tuple = ()  # the subgroups this mesh made (destroy_mesh frees them)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def stages_through_host(self) -> bool:
        return self.backend == "gloo" and self.device.type == "cuda"

    def axis_size(self, name: str) -> int:
        return self.shape[AXES.index(name)]

    def axis_index(self, name: str) -> int:
        return self.coords[AXES.index(name)]

    @property
    def batch_index(self) -> int:
        """This rank's shard of the batch: JAX's ``("data", "fsdp")``
        batch spec, data major."""
        return self.axis_index("data") * self.axis_size("fsdp") + self.axis_index("fsdp")

    @property
    def n_batch(self) -> int:
        """The batch shards: data x fsdp."""
        return self.axis_size("data") * self.axis_size("fsdp")

    def _fold(self, axes: tuple) -> int:
        pos = 0
        for ax in axes:
            pos = pos * self.axis_size(ax) + self.axis_index(ax)
        return pos

    @property
    def position(self) -> int:
        """The dropout fold of JAX ``ring.py:207-209`` (and, with
        sequence 1, of ``shard_flash.py:80-83``): the mesh position over
        data, fsdp, tensor, sequence, data major."""
        return self._fold(FOLD_AXES)

    @property
    def stage(self) -> int:
        """This rank's pipeline stage: its index on the pipeline line."""
        return self.axis_index("pipeline")

    @property
    def n_stages(self) -> int:
        return self.axis_size("pipeline")

    @property
    def replicated_position(self) -> int:
        """The fold of the activations a tensor line holds in full: the
        position over data, fsdp, sequence (the tensor index left out)."""
        return self._fold(REPLICATED_FOLD_AXES)

    def plane(self, *without: str) -> Line:
        """This rank's line over every axis but ``without``."""
        return self.line(*(a for a in AXES if a not in without))

    def line(self, *axes: str) -> Line:
        """This rank's line along ``axes``; a line of this rank alone
        where every one of them has size 1."""
        key = tuple(a for a in AXES if a in axes and self.axis_size(a) > 1)
        if not key:
            return Line((self.rank,), 0, None, self.stages_through_host)
        if key == tuple(a for a in AXES if self.axis_size(a) > 1):
            return self.world
        return self.lines[key]

    @property
    def world(self) -> Line:
        return Line(tuple(range(self.size)), self.rank, None, self.stages_through_host)

    @property
    def sequence_group(self) -> SequenceGroup:
        """The view of this rank's sequence line the model takes."""
        ln, tp = self.line("sequence"), self.line("tensor")
        return SequenceGroup(ln.index, ln.size, self.device, self.backend, owned=False,
                             peers=ln.ranks, group=ln.group,
                             position=self.replicated_position if self.size > 1 else None,
                             tensor=tp if tp.size > 1 else None)


def _env_int(name: str, default: Optional[int] = None) -> int:
    value = os.environ.get(name)
    if value is None:
        if default is None:
            raise RuntimeError(
                f"{name} is not set: start the ranks with torchrun (python -m "
                "torch.distributed.run --nproc-per-node P ...)"
            )
        return default
    return int(value)


def _join(backend: str, device: str) -> tuple:
    """Join the world as the rank ``torchrun`` made this process (or the
    default group the process already joined): (rank, size, device,
    whether this call joined)."""
    if backend not in BACKENDS:
        raise ValueError(f"dist backend must be one of {BACKENDS}, got {backend!r}")
    joined = dist.is_initialized()
    if joined:
        if dist.get_backend() != backend:
            raise RuntimeError(f"the process group runs {dist.get_backend()}, "
                               f"not {backend}")
        rank, size = dist.get_rank(), dist.get_world_size()
    else:
        rank, size = _env_int("RANK"), _env_int("WORLD_SIZE")
    local_rank = _env_int("LOCAL_RANK", rank)
    local_size = _env_int("LOCAL_WORLD_SIZE", size)
    dev_type = torch.device(device).type
    if dev_type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    if dev_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but CUDA is not "
                           "available; pass device='cpu' (with gloo) for a "
                           "CPU run")
    n_cards = torch.cuda.device_count() if dev_type == "cuda" else 0
    if backend == "nccl":
        if dev_type != "cuda" or local_size > n_cards:
            raise RuntimeError(
                f"nccl needs one card per rank: {local_size} ranks on this "
                f"host, {n_cards} cards; ranks that share a card (or run on "
                "the CPU) need --dist-backend gloo"
            )
        dev = torch.device("cuda", local_rank)
    else:
        dev = (torch.device("cuda", local_rank % n_cards) if dev_type == "cuda"
               else torch.device("cpu"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not joined:
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank,
                                world_size=size, **kw)
    return rank, size, dev, not joined


def _axis_sets(shape: Tuple[int, ...]) -> list:
    """The axis sets whose lines a mesh of ``shape`` makes, in one order:
    each axis of size > 1, then with tensor the plane of the other axes
    of size > 1 (the ranks holding the same tensor shard), then under
    fsdp the plane of the axes of size > 1 but fsdp and tensor (the
    ranks holding the same shard), each where it spans more than one of
    them."""
    live = [a for a, n in zip(AXES, shape) if n > 1]
    sets = [(a,) for a in live]
    planes = []
    if "tensor" in live:
        planes.append(tuple(a for a in live if a != "tensor"))
    if "fsdp" in live:
        planes.append(tuple(a for a in live if a not in ("fsdp", "tensor")))
    for rest in planes:
        if len(rest) > 1 and rest not in sets:
            sets.append(rest)
    return sets


def _coords(r: int, shape: Tuple[int, ...]) -> Tuple[int, ...]:
    """The row-major coordinates of world rank ``r`` over ``shape``."""
    out = []
    for n in reversed(shape):
        out.append(r % n)
        r //= n
    return tuple(reversed(out))


def _make_lines(shape: Tuple[int, ...], rank: int, axes: tuple,
                staged: bool) -> tuple:
    """Every line along ``axes`` (a ``dist.new_group`` each, made by every
    rank in the same order); returns (this rank's Line, the groups made).
    A line's positions are its ranks in increasing order (row-major over
    ``axes``); a line that is the whole world uses the default group."""
    moving = [AXES.index(a) for a in axes]
    world = math.prod(shape)
    lines = {}
    for r in range(world):
        c = _coords(r, shape)
        key = tuple(v for i, v in enumerate(c) if i not in moving)
        lines.setdefault(key, []).append(r)
    mine, made = None, []
    for key in sorted(lines):
        ranks = tuple(lines[key])
        group = None
        if len(ranks) < world:
            group = dist.new_group(list(ranks))
            made.append(group)
        if rank in ranks:
            mine = Line(ranks, ranks.index(rank), group, staged)
    return mine, made


def create_mesh(cfg, backend: str, device: str = "cuda") -> Mesh:
    """Join the world and lay its ranks out on ``cfg`` (a ``MeshConfig``):
    the world must hold exactly ``cfg.n_devices`` ranks. ``backend`` is
    ``nccl`` or ``gloo``, ``device`` ``cuda`` (the default) or ``cpu``
    (gloo only)."""
    shape = tuple(cfg.shape)
    rank, size, dev, owned = _join(backend, device)
    if size != cfg.n_devices:
        if owned:
            dist.destroy_process_group()
        raise ValueError(f"mesh shape {shape} needs {cfg.n_devices} ranks, got {size}")
    staged = backend == "gloo" and dev.type == "cuda"
    lines, made = {}, []
    for axes in _axis_sets(shape):
        lines[axes], groups = _make_lines(shape, rank, axes, staged)
        made.extend(groups)
    return Mesh(shape, rank, _coords(rank, shape), dev, backend, lines, owned,
                tuple(made))


def destroy_mesh(mesh: Mesh) -> None:
    """Free the subgroups the mesh made, and leave the world if
    :func:`create_mesh` joined it."""
    if not dist.is_initialized():
        return
    for g in mesh.made:
        dist.destroy_process_group(g)
    if mesh.owned:
        dist.destroy_process_group()


def init_sequence_group(backend: str, device: str = "cuda") -> SequenceGroup:
    """Join the sequence-parallel group as the rank ``torchrun`` made this
    process: the mesh whose only axis > 1 is ``sequence``, over the
    world. ``backend`` is ``nccl`` or ``gloo``; ``device`` ``cuda`` (the
    default) or ``cpu`` (gloo only). The rendezvous is ``env://`` (the
    MASTER_ADDR and MASTER_PORT torchrun sets). Where the process already
    joined a default group (its own rendezvous), that group is the ring;
    its backend must be ``backend``."""
    rank, size, dev, owned = _join(backend, device)
    return SequenceGroup(rank, size, dev, backend, owned=owned)


def destroy_sequence_group(sg: SequenceGroup) -> None:
    """Leave the group if :func:`init_sequence_group` joined it."""
    if sg.owned and dist.is_initialized():
        dist.destroy_process_group()


def to_host(t: torch.Tensor) -> torch.Tensor:
    """A copy of CUDA tensor ``t`` in pinned host memory (from PyTorch's
    caching host allocator: a pageable copy runs at a fraction of the
    link's rate)."""
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return host.copy_(t)


# The collectives: ``over`` is a Line, a SequenceGroup or a Mesh (its
# world); each runs over that group, through host buffers where gloo
# holds CUDA tensors, and is a no-op on a line of one rank. STATS counts
# the calls of this process, the bytes each rank put in, and the host
# seconds spent in them (with gloo the wait for the tensor's kernels
# comes first, outside the time): the chip smoke reads it around a step.

STATS = {"calls": 0, "bytes": 0, "host_s": 0.0}


def reset_collective_stats() -> None:
    STATS.update(calls=0, bytes=0, host_s=0.0)


def _run(over, t: torch.Tensor, op, out: torch.Tensor,
         inplace: bool = False) -> torch.Tensor:
    """``op(dst, src, group)`` on ``t`` into ``out`` over ``over``'s
    group (``inplace``: in ``t``'s own buffer), through pinned host
    buffers where gloo holds CUDA tensors, and a contiguous buffer where
    ``out`` is not."""
    staged = over.stages_through_host and t.is_cuda
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    src = to_host(t.detach()) if staged else t.detach().contiguous()
    if inplace:
        dst = src
    elif staged or not out.is_contiguous():
        dst = torch.empty(out.shape, dtype=out.dtype, device=src.device,
                          pin_memory=staged)
    else:
        dst = out
    op(dst, src, getattr(over, "group", None))
    if dst.data_ptr() != out.data_ptr():
        out.copy_(dst)
    STATS["calls"] += 1
    STATS["bytes"] += t.numel() * t.element_size()
    STATS["host_s"] += time.perf_counter() - t0
    return out


def all_reduce_sum_(t: torch.Tensor, over) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``over``, in place. Every rank ends
    with the same bits."""
    if over.size == 1:
        return t
    return _run(over, t, lambda dst, src, g: dist.all_reduce(dst, group=g), t,
                inplace=True)


def all_gather_(out: torch.Tensor, t: torch.Tensor, over) -> torch.Tensor:
    """``out`` (1-D, size x ``t.numel()``) = the ranks' ``t`` in line
    order."""
    if over.size == 1:
        return out.copy_(t.reshape(-1))
    return _run(over, t.reshape(-1), lambda dst, src, g: dist.all_gather_into_tensor(
        dst, src, group=g), out)


def reduce_scatter_(out: torch.Tensor, t: torch.Tensor, over) -> torch.Tensor:
    """``out`` = this rank's slice (by line position) of ``t`` (1-D, size
    x ``out.numel()``) summed over the ranks."""
    if over.size == 1:
        return out.copy_(t.reshape(-1))
    return _run(over, t.reshape(-1), lambda dst, src, g: dist.reduce_scatter_tensor(
        dst, src, group=g), out)


def all_to_all_(out: torch.Tensor, t: torch.Tensor, over) -> torch.Tensor:
    """All-to-all of equal chunks: ``t``'s leading dim splits into size
    chunks, chunk j goes to line position j, and ``out``'s chunk j comes
    from position j."""
    if over.size == 1:
        return out.copy_(t)
    return _run(over, t, lambda dst, src, g: dist.all_to_all_single(
        dst, src, group=g), out)


# ---------------------------------------------------------------------------
# point to point: the pipeline's neighbours
# ---------------------------------------------------------------------------

# the sends of this process: count, bytes sent, host seconds spent in them
# (the copy to the host, the send and its wait); the receives are
# counted under ``recv_*`` (read by the chip smoke around a step)
SEND = {"calls": 0, "bytes": 0, "host_s": 0.0,
        "recv_calls": 0, "recv_bytes": 0, "recv_host_s": 0.0}


def reset_send_stats() -> None:
    SEND.update(calls=0, bytes=0, host_s=0.0, recv_calls=0, recv_bytes=0,
                recv_host_s=0.0)


def send_(t: torch.Tensor, over: Line, index: int) -> None:
    """Send ``t`` to the rank at position ``index`` of the line ``over``
    (its group) and wait for the send: an ``isend`` whose buffer lives
    until then (with gloo and a CUDA tensor, a pinned host copy taken once
    ``t``'s kernels are done)."""
    staged = over.stages_through_host and t.is_cuda
    if staged:
        torch.cuda.current_stream(t.device).synchronize()
    t0 = time.perf_counter()
    buf = to_host(t.detach()) if staged else t.detach().contiguous()
    dist.isend(buf, over.ranks[index], group=over.group).wait()
    SEND["calls"] += 1
    SEND["bytes"] += buf.numel() * buf.element_size()
    SEND["host_s"] += time.perf_counter() - t0


def recv_(out: torch.Tensor, over: Line, index: int) -> torch.Tensor:
    """Receive into ``out`` from the rank at position ``index`` of the
    line ``over`` and wait for it (with gloo and a CUDA ``out``, through a
    pinned host buffer)."""
    staged = over.stages_through_host and out.is_cuda
    t0 = time.perf_counter()
    buf = (torch.empty(out.shape, dtype=out.dtype, pin_memory=staged)
           if staged or not out.is_contiguous() else out)
    dist.irecv(buf, over.ranks[index], group=over.group).wait()
    if buf.data_ptr() != out.data_ptr():
        out.copy_(buf)
    SEND["recv_calls"] += 1
    SEND["recv_bytes"] += out.numel() * out.element_size()
    SEND["recv_host_s"] += time.perf_counter() - t0
    return out
