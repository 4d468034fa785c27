"""The multi-process runtime: joining the world, the primary process,
each process's share of a batch, and the full state on the host.

Counterpart of ``differential_transformer_replication_tpu/parallel/
multihost.py``. The port's ranks are processes (one per card with
``nccl``, several sharing a card or the CPU with ``gloo``), started by
``torchrun`` or by hand:

- :func:`initialize` joins the default group: under ``torchrun`` from its
  environment (``env://``), or with an explicit coordinator address,
  process count and id (``tcp://``, no ``torchrun``). One process with no
  arguments and no ``torchrun`` environment needs no group: a no-op, so
  the same trainer runs on one card or many;
- :func:`is_primary` gates logging and checkpoint writes to rank 0;
- :func:`local_batch` is the counterpart of JAX's ``global_batch``:
  every rank draws the same offsets from the same seeded sampler and
  builds only its own rows and T-shard of the batch, bit-equal to
  ``shard_batch`` of the global one (``parallel/sharding.py``), so no rank
  builds the global batch on its card;
- :func:`gather_to_host` is the full train state on the host, in the
  canonical list-of-blocks layout: the fsdp, tensor and pipeline shards
  gathered, a collective that every rank of the mesh joins.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE")


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the default process group; returns whether this call joined.

    A no-op (False) when the process already joined, and in one process
    given no arguments without a ``torchrun`` environment. Under
    ``torchrun`` with no arguments it joins through ``env://``; with
    ``coordinator_address`` (``host:port``), ``num_processes`` and
    ``process_id`` it joins ``tcp://<coordinator_address>`` as that rank
    of that world. ``backend`` (``nccl`` or ``gloo``) must be named for a
    join: nothing picks one."""
    if dist.is_initialized():
        return False
    explicit = (coordinator_address, num_processes, process_id)
    if all(v is None for v in explicit) and not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"joining a process group needs a named backend, nccl "
                         f"or gloo, got {backend!r}")
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", process_id or 0))
        torch.cuda.set_device(local % max(torch.cuda.device_count(), 1))
    if coordinator_address is None:
        dist.init_process_group(backend, init_method="env://")
        return True
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator address needs num_processes and process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes), rank=int(process_id))
    return True


def is_primary() -> bool:
    """True on the process that writes logs and checkpoints: rank 0, or
    the only process when there is no group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def local_batch_slice(global_batch_size: int) -> tuple:
    """(start, size) of this process's share of a global batch: each
    process draws only its own windows."""
    n = process_count()
    if global_batch_size % n:
        raise ValueError(
            f"global batch {global_batch_size} must divide evenly over "
            f"{n} processes"
        )
    per = global_batch_size // n
    return process_index() * per, per


def local_batch(ds, offsets: np.ndarray, mesh) -> dict:
    """This rank's ``{"x", "y"}`` of the batch at ``offsets`` ((..., B)
    window starts in ``ds``, a ``data/sampler.py:TokenWindows``, drawn
    alike on every rank): its rows (``mesh.batch_index`` of data x fsdp,
    data major) and its sequence coordinate's T-shard, gathered from the
    token stream directly. Bit-equal to ``shard_batch(ds.batches(offsets),
    mesh)``; ``ds.batches(offsets)`` itself without a mesh."""
    if mesh is None:
        return ds.batches(offsets)
    offsets = np.asarray(offsets, dtype=np.int64)
    n, b = mesh.n_batch, mesh.batch_index
    rows = offsets.shape[-1] // n
    offs = offsets[..., b * rows:(b + 1) * rows]
    seq = mesh.line("sequence")
    Tl = ds.block_size // seq.size
    dev = ds.tokens.device
    span = torch.arange(seq.index * Tl, (seq.index + 1) * Tl + 1, device=dev)
    grab = ds.tokens[torch.as_tensor(offs, device=dev)[..., None] + span]
    return {"x": grab[..., :-1], "y": grab[..., 1:]}


def gather_to_host(state: dict, mesh=None, layout=None) -> dict:
    """The full train state on the host (CPU tensors), in the canonical
    list-of-blocks layout, from this rank's state at rest on ``mesh``
    (``layout``: its FSDP layout or None). A collective: every rank of
    the mesh joins the fsdp, tensor and pipeline gathers, even where only
    rank 0 reads the result. Without a mesh, a host copy."""
    from differential_transformer_replication_tpu_torch.parallel.dp_step import (
        full_train_state,
    )

    full = state if mesh is None else full_train_state(state, mesh, layout)

    def host(node):
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        if isinstance(node, list):
            return [host(v) for v in node]
        if isinstance(node, torch.Tensor):
            return node.detach().to("cpu", copy=True)
        return node

    return host(full)
