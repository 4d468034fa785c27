"""The port's multi-process runtime (``parallel/multihost.py``) against
the JAX package's, on the CPU: twin of JAX ``tests/test_multihost.py``.

- ``initialize`` is a no-op in one process with no arguments and no
  ``torchrun`` environment; ``is_primary`` and ``process_count`` are
  then the one process's;
- ``local_batch_slice`` gives JAX's numbers and JAX's error text, over
  a faked process count on both sides;
- ``local_batch`` (the counterpart of JAX's ``global_batch``) is bit-equal
  to ``shard_batch`` of the global draw at every position of a
  ``data=2 x sequence=2`` mesh (and of ``data=2 x fsdp=2``), for the
  epoch sampler's offsets;
- two plain processes (no ``torchrun``) joined by ``initialize(
  coordinator_address=..., num_processes=2, process_id=i)`` run one
  all-reduce, and exactly one of them is primary.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from differential_transformer_replication_tpu.parallel import multihost as jmultihost
from differential_transformer_replication_tpu_torch.data.native import EpochPermutation
from differential_transformer_replication_tpu_torch.data.sampler import TokenWindows
from differential_transformer_replication_tpu_torch.parallel import multihost
from differential_transformer_replication_tpu_torch.parallel.mesh import AXES, Line, Mesh
from differential_transformer_replication_tpu_torch.parallel.sharding import shard_batch

REPO = Path(__file__).resolve().parents[1]
JOIN_TIMEOUT_S = 120


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize() is False  # reaches no coordinator
    assert not torch.distributed.is_initialized()
    assert multihost.process_count() == 1 and multihost.is_primary()
    assert multihost.local_batch_slice(32) == (0, 32)
    jmultihost.initialize()
    assert jmultihost.process_count() == 1 and jmultihost.is_primary()
    # a join names its backend: nothing picks one
    with pytest.raises(ValueError, match="named backend"):
        multihost.initialize("127.0.0.1:1", 2, 0)


@pytest.mark.parametrize("n,size", [(4, 32), (2, 6), (3, 32), (8, 4)])
def test_local_batch_slice_matches_jax(n, size, monkeypatch):
    """Each process's (start, size) of a global batch, or the refusal,
    with JAX's arithmetic and text (process counts faked on both
    sides)."""
    monkeypatch.setattr(multihost, "process_count", lambda: n)
    monkeypatch.setattr(jax, "process_count", lambda: n)
    for i in range(n):
        monkeypatch.setattr(multihost, "process_index", lambda i=i: i)
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        if size % n:
            with pytest.raises(ValueError) as want:
                jmultihost.local_batch_slice(size)
            with pytest.raises(ValueError) as got:
                multihost.local_batch_slice(size)
            assert str(got.value) == str(want.value)
            assert "must divide evenly over" in str(got.value)
        else:
            assert multihost.local_batch_slice(size) == jmultihost.local_batch_slice(size)


def _mesh_at(coords: tuple, shape: tuple) -> Mesh:
    """The mesh as the rank at ``coords`` sees it (its lines, no process
    group: ``local_batch`` and ``shard_batch`` read positions only)."""
    lines = {}
    for a, n in zip(AXES, shape):
        if n > 1:
            lines[(a,)] = Line(tuple(range(n)), coords[AXES.index(a)])
    return Mesh(shape, 0, coords, torch.device("cpu"), "gloo", lines)


@pytest.mark.parametrize("axes", [dict(data=2, sequence=2), dict(data=2, fsdp=2)],
                         ids=["data2-sequence2", "data2-fsdp2"])
def test_local_batch_is_bit_equal_to_shard_batch_of_the_global_draw(axes):
    tokens = (np.arange(4096, dtype=np.int64) * 31) % 113
    ds = TokenWindows(tokens, block_size=16)
    perm = EpochPermutation(len(ds), 7)
    A, B = 2, 8
    offs = perm.take(A * B).reshape(A, B)
    whole = ds.batches(offs)
    shape = tuple(axes.get(a, 1) for a in AXES)
    seen = []
    for coords in np.ndindex(*shape):
        mesh = _mesh_at(tuple(coords), shape)
        got = multihost.local_batch(ds, offs, mesh)
        want = shard_batch(whole, mesh)
        for k in ("x", "y"):
            assert got[k].shape == want[k].shape
            assert torch.equal(got[k], want[k]), (coords, k)
        seen.append(got["x"])
    # the positions' shares are distinct and tile the global batch
    assert sum(t.numel() for t in seen) == whole["x"].numel()
    assert len({t.numpy().tobytes() for t in seen}) == len(seen)
    assert multihost.local_batch(ds, offs, None)["x"].equal(whole["x"])


_JOIN = """
import json, sys
import torch
import torch.distributed as dist
from differential_transformer_replication_tpu_torch.parallel import multihost
addr, pid, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
joined = multihost.initialize(coordinator_address=addr, num_processes=2,
                              process_id=pid, backend="gloo")
again = multihost.initialize(coordinator_address=addr, num_processes=2,
                             process_id=pid, backend="gloo")
t = torch.tensor([float(pid + 1)])
dist.all_reduce(t)
json.dump({"joined": joined, "again": again, "sum": float(t), "primary":
           multihost.is_primary(), "count": multihost.process_count(),
           "slice": list(multihost.local_batch_slice(8))}, open(out, "w"))
dist.destroy_process_group()
"""


def test_two_plain_processes_join_through_initialize(tmp_path):
    with socket.socket() as s:  # a free port on this host
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                        "MASTER_ADDR", "MASTER_PORT")}
    env.update(PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _JOIN, f"127.0.0.1:{port}", str(i),
                               str(tmp_path / f"out{i}.json")], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [p.communicate(timeout=JOIN_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"the two processes did not join within {JOIN_TIMEOUT_S} s")
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    got = [json.load(open(tmp_path / f"out{i}.json")) for i in range(2)]
    assert [g["joined"] for g in got] == [True, True]
    assert [g["again"] for g in got] == [False, False]  # already joined: returns
    assert all(g["sum"] == 3.0 and g["count"] == 2 for g in got)
    assert sorted(g["primary"] for g in got) == [False, True]
    assert got[0]["primary"] and [g["slice"] for g in got] == [[0, 4], [4, 4]]
