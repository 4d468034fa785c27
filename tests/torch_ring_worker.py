"""One rank of the port's sequence-parallel ring, for the ring tests.

    python tests/torch_ring_worker.py TASK DIR

is started P times by :func:`run_ranks` (from ``tests/test_torch_ring.py``
on the CPU and ``tests/test_torch_gpu.py`` on one card, gloo both), with
``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in the environment. It imports
torch and the port only (no JAX, not the test files), joins the group
through a ``file://`` rendezvous in DIR (no TCP port), reads
``DIR/in.npz``, runs TASK and writes ``DIR/out<rank>.npz``. Tasks:

- ``rotate``: one ring step of a rank-stamped tensor and its backward;
- ``ring``: ``ring_multi_stream_attention`` on this rank's shards of the
  global inputs, forward and backward, for each dropout rate given (each
  rank its own seed words);
- ``wrappers``: ``ring_vanilla_attention``, ``ring_diff_attention`` and
  ``ring_ndiff_attention`` on this rank's shards, forward and backward
  (the lambdas' gradients too);
- ``model``: ``model_forward`` of each family given (its params passed as
  leaves), this rank's logits and loss share;
- ``step``: one SP train step from a given train state, and the grads;
- ``cli``: the trainer's command line with the arguments given;
- ``cli_corpus``: ``cli``, with the rank's BPE trainings counted.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from differential_transformer_replication_tpu_torch.config import (  # noqa: E402
    MeshConfig,
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.models import (  # noqa: E402
    init_model,
    model_forward,
)
from differential_transformer_replication_tpu_torch.parallel import (  # noqa: E402
    destroy_sequence_group,
    init_sequence_group,
    ring,
    ring_multi_stream_attention,
    rotate,
)
from differential_transformer_replication_tpu_torch.train.optim import (  # noqa: E402
    leaves,
    unflatten,
)
from differential_transformer_replication_tpu_torch.train.step import (  # noqa: E402
    make_grad_fn,
    make_train_step,
    shard_tokens,
)


def _t(a, device, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t if dtype is None else t.to(dtype)


def _np(t):
    return t.detach().to("cpu", torch.float32).numpy() if t.is_floating_point() \
        else t.detach().cpu().numpy()


def task_rotate(sg, inp):
    x = torch.full((3, 5), float(sg.rank), device=sg.device).requires_grad_(True)
    y = rotate(x, sg)
    y.backward(torch.full_like(y, float(10 * sg.rank + 1)))
    return {"y": _np(y), "gx": _np(x.grad)}


def task_ring(sg, inp):
    dev, P, r = sg.device, sg.size, sg.rank
    dt = getattr(torch, str(inp["dtype"]))
    T = inp["qs"].shape[2]
    Tl = T // P
    sl = slice(r * Tl, (r + 1) * Tl)
    out = {}
    for i, rate in enumerate(inp["rates"].tolist()):
        qs = _t(inp["qs"][:, :, sl], dev, dt).requires_grad_(True)
        ks = _t(inp["ks"][:, :, sl], dev, dt).requires_grad_(True)
        v = _t(inp["v"][:, sl], dev, dt).requires_grad_(True)
        c = _t(inp["coeffs"], dev).requires_grad_(True)
        seed = torch.from_numpy(inp["words"][i, r].reshape(1, 2)) if rate > 0 else None
        ring.reset_rotation_stats()
        o = ring_multi_stream_attention(qs, ks, v, c, sg, dropout_rate=rate,
                                        dropout_seed=seed)
        out[f"fwd_exchanges{i}"] = np.int64(ring.ROTATION["calls"])
        o.backward(_t(inp["g"][:, sl], dev, dt))
        out[f"exchanges{i}"] = np.int64(ring.ROTATION["calls"])
        for name, t in (("out", o), ("dqs", qs.grad), ("dks", ks.grad),
                        ("dv", v.grad), ("dcoeffs", c.grad)):
            out[f"{name}{i}"] = _np(t)
    return out


def task_wrappers(sg, inp):
    dev, P, r = sg.device, sg.size, sg.rank
    Tl = inp["v"].shape[1] // P
    sl = slice(r * Tl, (r + 1) * Tl)
    out = {}
    for kind in ("vanilla", "diff", "ndiff"):
        qs = _t(inp["qs"][:, :, sl], dev).requires_grad_(True)
        ks = _t(inp["ks"][:, :, sl], dev).requires_grad_(True)
        v = _t(inp["v"][:, sl], dev).requires_grad_(True)
        lam = _t(inp["lam"], dev).requires_grad_(True)
        lams = _t(inp["lams"], dev).requires_grad_(True)
        if kind == "vanilla":
            o = ring.ring_vanilla_attention(qs[0], ks[0], v, sg)
        elif kind == "diff":
            o = ring.ring_diff_attention(qs[0], ks[0], qs[1], ks[1], v, lam, sg)
        else:
            o = ring.ring_ndiff_attention(qs, ks, v, lams, _t(inp["signs"], dev), sg)
        o.backward(_t(inp["g"][:, sl], dev))
        for name, t in (("out", o), ("dqs", qs.grad), ("dks", ks.grad), ("dv", v.grad),
                        ("dlam", lam.grad), ("dlams", lams.grad)):
            if t is not None:
                out[f"{kind}_{name}"] = _np(t)
    return out


def _params(inp, cfg, prefix, device):
    template = init_model(torch.Generator().manual_seed(0), cfg)
    flat = [_t(inp[f"{prefix}{i}"], device) for i in range(len(leaves(template)))]
    return unflatten(template, flat)


def task_model(sg, inp):
    out = {}
    for kind in inp["kinds"].tolist():
        cfg = ModelConfig(**json.loads(str(inp[f"cfg_{kind}"])))
        params = _params(inp, cfg, f"p_{kind}_", sg.device)
        x = shard_tokens(_t(inp[f"x_{kind}"], sg.device), sg)
        y = shard_tokens(_t(inp[f"y_{kind}"], sg.device), sg)
        with torch.no_grad():
            logits, loss = model_forward(params, x, cfg, targets=y, group=sg)
            logits_only, _ = model_forward(params, x, cfg, group=sg)
        out[f"logits_{kind}"] = _np(logits_only)
        out[f"loss_{kind}"] = _np(loss)
    return out


def task_step(sg, inp):
    meta = json.loads(str(inp["meta"]))
    cfg = TrainConfig(model=ModelConfig(**meta["model"]),
                      mesh=MeshConfig(sequence=sg.size), **meta["train"])
    mcfg = cfg.resolved_model()
    dev = sg.device
    params = _params(inp, mcfg, "p", dev)
    for t in leaves(params):
        t.requires_grad_(True)
    state = {"params": params,
             "opt_state": {"mu": _params(inp, mcfg, "mu", dev),
                           "nu": _params(inp, mcfg, "nu", dev),
                           "count": int(meta["count"])},
             "step": int(meta["step"])}
    if "guard" in meta:
        g = meta["guard"]
        state["guard"] = {"ema": np.float32(g["ema"]), "good_steps": g["good_steps"],
                          "bad_streak": g["bad_streak"], "skipped": g["skipped"]}
    batch = {"x": _t(inp["x"], dev), "y": _t(inp["y"], dev)}
    loss, grads = make_grad_fn(cfg, sg)(state["params"], batch)
    state, metrics = make_train_step(cfg, sg)(state, batch)
    out = {"loss": np.float32(metrics["loss"]),
           "grad_loss": _np(loss),
           "grad_norm": np.float32(metrics["grad_norm"])}
    for i, (g, p) in enumerate(zip(grads, leaves(state["params"]))):
        out[f"g{i}"] = _np(g)
        out[f"p{i}"] = _np(p)
    return out


def task_cli(sg, inp):
    from differential_transformer_replication_tpu_torch.train.__main__ import run

    _, history = run([str(a) for a in inp["argv"].tolist()])
    return {"losses": np.array([m["loss"] for m in history], np.float64)}


def task_cli_corpus(sg, inp):
    from differential_transformer_replication_tpu_torch.train import trainer

    real, trained = trainer.train_bpe_tokenizer, []

    def counted(*args, **kwargs):
        trained.append(1)
        return real(*args, **kwargs)

    trainer.train_bpe_tokenizer = counted
    return {**task_cli(sg, inp), "bpe_trainings": np.array(len(trained))}


TASKS = {"rotate": task_rotate, "ring": task_ring, "wrappers": task_wrappers,
         "model": task_model, "step": task_step, "cli": task_cli,
         "cli_corpus": task_cli_corpus}


def run_ranks(task: str, P: int, d: Path, inputs: dict, timeout: float) -> list:
    """Run ``task`` on P worker processes joined in ``d``; return each
    rank's outputs. Every rank must exit 0 within ``timeout`` seconds, else
    all are killed and this raises, so a deadlock fails a test instead of
    hanging it."""
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "in.npz", **inputs)
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, WORLD_SIZE=str(P), LOCAL_WORLD_SIZE=str(P),
               OMP_NUM_THREADS="1", PYTHONPATH=str(repo))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), task, str(d)],
        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(P)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{task}: the ranks did not finish within {timeout} s")
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"{task} rank {r} exited {p.returncode}:\n{log}")
    return [dict(np.load(d / f"out{r}.npz")) for r in range(P)]


def main() -> int:
    task, d = sys.argv[1], Path(sys.argv[2])
    torch.set_num_threads(1)
    inp = dict(np.load(d / "in.npz", allow_pickle=False))
    device = str(inp.get("device", "cpu"))
    rank, size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdzv'}",
                            rank=rank, world_size=size)
    sg = init_sequence_group("gloo", device)
    try:
        out = TASKS[task](sg, inp)
    finally:
        destroy_sequence_group(sg)
        dist.destroy_process_group()
    np.savez(d / f"out{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
