"""The sequence-parallel process group of the port.

Counterpart of ``differential_transformer_replication_tpu/parallel/
mesh.py`` (``create_mesh``) for the one mesh axis the port runs,
``sequence``: P ranks, each holding a T/P shard of every sequence, joined
by a ``torch.distributed`` process group. The ranks are the processes
``torchrun`` starts; :func:`init_sequence_group` reads the ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` (and ``LOCAL_WORLD_SIZE``) it sets.

The backend is always named by the caller; nothing switches between
them:

- ``nccl`` needs one card per rank (NCCL refuses two ranks on one card),
  so ranks that would share a card raise, naming ``gloo``;
- ``gloo`` puts rank r on ``cuda:(LOCAL_RANK % device_count)``, so P
  ranks may share one card, or on the CPU when the caller asks for
  ``device="cpu"``. gloo moves only CPU tensors: the ring stages CUDA
  tensors through pinned host memory (:func:`to_host`).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass(frozen=True)
class SequenceGroup:
    """This rank's place on the ring, which is the default process group:
    ``rank`` of ``size``, its ``device`` and the ``backend``."""

    rank: int
    size: int
    device: torch.device
    backend: str
    owned: bool = True  # joined by init_sequence_group (it leaves it)

    @property
    def stages_through_host(self) -> bool:
        """gloo with CUDA tensors: collectives go through host buffers."""
        return self.backend == "gloo" and self.device.type == "cuda"


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


def init_sequence_group(backend: str, device: str = "cuda") -> SequenceGroup:
    """Join the sequence-parallel group as the rank ``torchrun`` made this
    process. ``backend`` is ``nccl`` or ``gloo``; ``device`` ``cuda`` (the
    default) or ``cpu`` (gloo only). The rendezvous is ``env://`` (the
    MASTER_ADDR and MASTER_PORT torchrun sets). Where the process already
    joined a default group (its own rendezvous), that group is the ring;
    its backend must be ``backend``."""
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
    return SequenceGroup(rank, size, dev, backend, owned=not joined)


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


def all_reduce_sum_(t: torch.Tensor, sg: SequenceGroup) -> torch.Tensor:
    """Sum ``t`` over the ranks, in place (through a host buffer where
    gloo holds CUDA tensors). Every rank ends with the same bits."""
    if sg.stages_through_host:
        host = to_host(t.detach())
        dist.all_reduce(host)
        t.copy_(host)
    else:
        dist.all_reduce(t)
    return t

