"""One rank of the port's sequence-parallel ring, for the ring tests.

    python tests/torch_ring_worker.py TASK[+TASK...] DIR

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
- ``grads``: the loss and grads of one SP step (dropout seed given) under
  each model config given, from the same params and batch (remat and the
  chunked loss against the plain step);
- ``cli``: the trainer's command line with the arguments given;
- ``cli_corpus``: ``cli``, with the rank's BPE trainings counted;
- ``clis``: ``cli`` for each command line of a list, in turn;
- ``mesh_step``: on a mesh of the world's ranks (``create_mesh`` over
  data, fsdp, tensor, sequence), one ``make_sharded_train_step`` step
  per case given, from the same full train state (cut to the rank's
  shards) and global batch: the metrics, the updated params (gathered
  under tensor and fsdp), the elements each rank holds at rest, and
  every collective the step issued (kind and size, in order);
- ``mesh_attention``: on such a mesh, each rank's attention on its batch
  rows, heads (tensor) and T-shard with the seed words of its mesh
  position, forward and backward: ``shard_flash_multi_stream_attention``,
  or the ring over the sequence line;
- ``tensor_parts``: on a tensor line of the world, the GroupLayerNorm of
  the rank's columns, the vocab-parallel losses (dense and chunked) of
  its vocab shard, forward and backward, and the dropout seeds of a
  mesh position;
- ``ulysses``: ``ulysses_multi_stream_attention`` on this rank's shards,
  forward and backward, for each coefficient set and dropout rate given;
- ``pipeline``: on a mesh of the world's ranks with a pipeline axis, per
  case given, from the same full train state cut to the rank's stage
  (and tensor shard) and the same global batch: one
  ``make_pipeline_train_step`` step (the metrics, the updated params
  gathered to the canonical layout on the host by
  ``multihost.gather_to_host``, the rank's own replicated leaves,
  every send and receive of the step in order), or the forward loss
  alone; the eval stream against per-batch evals, and dropout's losses
  by seed, where the case asks.
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
from differential_transformer_replication_tpu_torch.parallel.sharding import (  # noqa: E402
    shard_batch,
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
    # fresh copies: a step updates them in place
    flat = [_t(inp[f"{prefix}{i}"], device).clone()
            for i in range(len(leaves(template)))]
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


def task_grads(sg, inp):
    meta = json.loads(str(inp["meta"]))
    out = {}
    for k, mdict in enumerate(meta["models"]):
        cfg = TrainConfig(model=ModelConfig(**mdict), mesh=MeshConfig(sequence=sg.size),
                          **meta["train"])
        params = _params(inp, cfg.resolved_model(), "p", sg.device)
        for t in leaves(params):
            t.requires_grad_(True)
        batch = {"x": _t(inp["x"], sg.device), "y": _t(inp["y"], sg.device)}
        loss, grads = make_grad_fn(cfg, sg)(params, batch, meta["seed"])
        out[f"loss{k}"] = _np(loss)
        out.update({f"g{k}_{i}": _np(g) for i, g in enumerate(grads)})
    return out


def task_cli(sg, inp):
    from differential_transformer_replication_tpu_torch.train.__main__ import run

    _, history = run([str(a) for a in inp["argv"].tolist()])
    return {"losses": np.array([m["loss"] for m in history], np.float64)}


def task_clis(sg, inp):
    """``cli`` for each command line of the JSON list ``inp["runs"]``, in
    turn (each run joins the world's group and leaves its own)."""
    from differential_transformer_replication_tpu_torch.train.__main__ import run

    out = {}
    for k, argv in enumerate(json.loads(str(inp["runs"]))):
        _, history = run([str(a) for a in argv])
        out[f"losses{k}"] = np.array([m["loss"] for m in history], np.float64)
    return out


def task_cli_corpus(sg, inp):
    from differential_transformer_replication_tpu_torch.train import trainer

    real, trained = trainer.train_bpe_tokenizer, []

    def counted(*args, **kwargs):
        trained.append(1)
        return real(*args, **kwargs)

    trainer.train_bpe_tokenizer = counted
    return {**task_cli(sg, inp), "bpe_trainings": np.array(len(trained))}


def _counting(log):
    """Wrap the collectives the mesh step's modules call so that each
    call appends (kind, elements) to ``log``; returns the undo."""
    from differential_transformer_replication_tpu_torch.parallel import dp_step, sharding
    from differential_transformer_replication_tpu_torch.train import step as step_mod

    from differential_transformer_replication_tpu_torch.ops import losses
    from differential_transformer_replication_tpu_torch.parallel import regions

    saved = []
    for mod, name, kind in ((dp_step, "all_reduce_sum_", "all_reduce"),
                            (step_mod, "all_reduce_sum_", "all_reduce"),
                            (sharding, "all_reduce_sum_", "all_reduce"),
                            (sharding, "reduce_scatter_", "reduce_scatter"),
                            (sharding, "all_gather_", "all_gather"),
                            (regions, "all_reduce_sum_", "all_reduce"),
                            (regions, "reduce_scatter_", "reduce_scatter"),
                            (regions, "all_gather_", "all_gather"),
                            (losses, "all_gather_", "all_gather")):
        real = getattr(mod, name)

        def wrapped(*a, _real=real, _kind=kind):
            t = a[0] if _kind == "all_reduce" else a[1]
            if a[-1].size > 1:
                log.append((_kind, int(t.numel())))
            return _real(*a)

        saved.append((mod, name, real))
        setattr(mod, name, wrapped)

    def undo():
        for mod, name, real in saved:
            setattr(mod, name, real)

    return undo


def task_mesh_step(sg, inp):
    from differential_transformer_replication_tpu_torch.parallel import (
        create_mesh,
        destroy_mesh,
    )
    from differential_transformer_replication_tpu_torch.parallel.dp_step import (
        full_train_state,
        make_sharded_train_step,
        shard_train_state,
    )

    meta = json.loads(str(inp["meta"]))
    out = {}
    for c, case in enumerate(meta["cases"]):
        cfg = TrainConfig(model=ModelConfig(**dict(meta["model"], **case.get("model", {}))),
                          mesh=MeshConfig(**case["mesh"]),
                          **dict(meta["train"], **case.get("train", {})))
        mesh = create_mesh(cfg.mesh, "gloo", str(sg.device))
        try:
            mcfg = cfg.resolved_model()
            dev = mesh.device
            pre = case.get("prefix", "")  # the case's own params, where given
            params = _params(inp, mcfg, pre + "p", dev)
            for t in leaves(params):
                t.requires_grad_(True)
            state = {"params": params,
                     "opt_state": {"mu": _params(inp, mcfg, pre + "mu", dev),
                                   "nu": _params(inp, mcfg, pre + "nu", dev),
                                   "count": int(meta["count"])},
                     "step": int(meta["step"])}
            g = meta["guard"]
            state["guard"] = {"ema": np.float32(g["ema"]), "good_steps": g["good_steps"],
                              "bad_streak": g["bad_streak"], "skipped": g["skipped"]}
            state, layout = shard_train_state(cfg, mesh, state)
            opt = state["opt_state"]
            out[f"{c}_rest"] = np.array([sum(t.numel() for t in leaves(ts)) for ts in (
                state["params"], opt["mu"], opt["nu"])])
            step = make_sharded_train_step(cfg, mesh, layout)
            x = case.get("x", "x")
            batch = {"x": _t(inp[x], dev), "y": _t(inp[case.get("y", "y")], dev)}
            log = []
            undo = _counting(log)
            try:
                state, m = step(state, batch, case.get("seed"))
            finally:
                undo()
            full = full_train_state(state, mesh, layout)
            out[f"{c}_loss"] = np.float32(m["loss"])
            out[f"{c}_grad_norm"] = np.float32(m["grad_norm"])
            out[f"{c}_groups"] = np.array(m["grad_norm_groups"], np.float32)
            out[f"{c}_calls"] = np.array([[("all_reduce", "reduce_scatter",
                                            "all_gather").index(k), n] for k, n in log],
                                         np.int64).reshape(-1, 2)
            for i, t in enumerate(leaves(full["params"])):
                out[f"{c}_p{i}"] = _np(t).copy()
            out[f"{c}_coords"] = np.array(mesh.coords)
        finally:
            destroy_mesh(mesh)
    return out


def task_mesh_attention(sg, inp):
    from differential_transformer_replication_tpu_torch.parallel import (
        create_mesh,
        destroy_mesh,
    )
    from differential_transformer_replication_tpu_torch.parallel.shard_flash import (
        shard_flash_multi_stream_attention,
    )

    meta = json.loads(str(inp["meta"]))
    out = {}
    for c, case in enumerate(meta["cases"]):
        mesh = create_mesh(MeshConfig(**case["mesh"]), "gloo", str(sg.device))
        try:
            dev = mesh.device
            qs, ks, v = (_t(inp[k], dev) for k in ("qs", "ks", "v"))
            S, B, T, H, d = qs.shape
            dv = v.shape[-1]
            n, b = mesh.n_batch, mesh.batch_index
            seq = mesh.sequence_group
            rows, Tl = slice(b * B // n, (b + 1) * B // n), T // seq.size
            cols = slice(seq.rank * Tl, (seq.rank + 1) * Tl)
            tp = mesh.line("tensor")
            Hl = H // tp.size
            heads = slice(tp.index * Hl, (tp.index + 1) * Hl)
            ql = qs[:, rows, cols, heads].clone().requires_grad_(True)
            kl = ks[:, rows, cols, heads].clone().requires_grad_(True)
            vl = v[rows, cols, heads].clone().requires_grad_(True)
            coeffs = _t(inp["coeffs"], dev)[:, heads].clone().requires_grad_(True)
            words = torch.from_numpy(inp["words"][mesh.position].reshape(1, 2))
            kw = dict(dropout_rate=case["rate"], dropout_seed=words)
            if seq.size > 1:
                o = ring_multi_stream_attention(ql, kl, vl, coeffs, seq, **kw)
            else:
                o = shard_flash_multi_stream_attention(ql, kl, vl, coeffs, **kw)
            o.backward(_t(inp["g"], dev)[rows, cols, heads])
            for name, t in (("out", o), ("dqs", ql.grad), ("dks", kl.grad),
                            ("dv", vl.grad), ("dcoeffs", coeffs.grad)):
                out[f"{c}_{name}"] = _np(t)
            out[f"{c}_where"] = np.array([b, seq.rank, mesh.position])
            out[f"{c}_heads"] = np.array([heads.start, heads.stop])
        finally:
            destroy_mesh(mesh)
    return out


def task_tensor_parts(sg, inp):
    """On the world as one tensor line: the GroupLayerNorm of this rank's
    columns of ``gn_x`` (gathered statistics), the vocab-parallel dense and
    chunked losses of its vocab columns of ``ce_w``, each forward and
    backward, and the forward's dropout seeds for the mesh positions of
    ``meta["seed_meshes"]``."""
    from differential_transformer_replication_tpu_torch.models import common
    from differential_transformer_replication_tpu_torch.ops import losses
    from differential_transformer_replication_tpu_torch.ops.dropout import generator
    from differential_transformer_replication_tpu_torch.parallel import (
        create_mesh,
        destroy_mesh,
    )
    from differential_transformer_replication_tpu_torch.parallel.regions import (
        copy_to_region,
        own_columns,
    )
    from differential_transformer_replication_tpu_torch.parallel.shard_flash import (
        attention_seed,
    )

    meta = json.loads(str(inp["meta"]))
    out = {}
    mesh = create_mesh(MeshConfig(tensor=sg.size), "gloo", str(sg.device))
    try:
        dev, tp = mesh.device, mesh.line("tensor")

        def mine(a):  # this rank's block of the last dim
            return own_columns(_t(a, dev), tp).contiguous().clone().requires_grad_(True)

        x, w, b = mine(inp["gn_x"]), mine(inp["gn_w"]), mine(inp["gn_b"])
        y = common.apply_group_norm(x, {"w": w, "b": b}, tp)
        y.backward(own_columns(_t(inp["gn_g"], dev), tp))
        out.update(gn_y=_np(y), gn_dx=_np(x.grad), gn_dw=_np(w.grad), gn_db=_np(b.grad))
        for kind in ("dense", "chunked"):
            h = _t(inp["ce_h"], dev).requires_grad_(True)
            cw, cb = mine(inp["ce_w"]), mine(inp["ce_b"])
            hh = copy_to_region(h, tp)
            tgt = _t(inp["ce_t"], dev)
            if kind == "dense":
                loss, logits = losses.dense_linear_cross_entropy(hh, cw, cb, tgt, None, tp)
                out["ce_logits"] = _np(logits)
            else:
                loss = losses.fused_linear_cross_entropy(hh, cw, cb, tgt, meta["chunk"],
                                                         None, tp)
            loss.backward()
            out.update({f"ce_{kind}_loss": _np(loss), f"ce_{kind}_dh": _np(h.grad),
                        f"ce_{kind}_dw": _np(cw.grad), f"ce_{kind}_db": _np(cb.grad)})
    finally:
        destroy_mesh(mesh)
    for c, axes in enumerate(meta["seed_meshes"]):
        mesh = create_mesh(MeshConfig(**axes), "gloo", str(sg.device))
        try:
            grp = mesh.sequence_group
            s = common.rank_seed(meta["seed"], grp)
            shape = (64,)
            out[f"seed{c}_residual"] = _np(common.apply_dropout(
                torch.ones(shape), 0.5, s))
            gen = generator(attention_seed(s, grp), "cpu")
            out[f"seed{c}_attention"] = _np(torch.rand(shape, generator=gen))
            out[f"seed{c}_coords"] = np.array(mesh.coords)
        finally:
            destroy_mesh(mesh)
    return out


def task_ulysses(sg, inp):
    from differential_transformer_replication_tpu_torch.parallel import ulysses

    dev, P, r = sg.device, sg.size, sg.rank
    out = {}
    for i, rate in enumerate(inp["rates"].tolist()):
        Tl = inp[f"qs{i}"].shape[2] // P
        sl = slice(r * Tl, (r + 1) * Tl)
        qs = _t(inp[f"qs{i}"][:, :, sl], dev).requires_grad_(True)
        ks = _t(inp[f"ks{i}"][:, :, sl], dev).requires_grad_(True)
        v = _t(inp[f"v{i}"][:, sl], dev).requires_grad_(True)
        c = _t(inp[f"coeffs{i}"], dev).requires_grad_(True)
        seed = torch.from_numpy(inp["words"][r].reshape(1, 2)) if rate > 0 else None
        ulysses.reset_exchange_stats()
        o = ulysses.ulysses_multi_stream_attention(qs, ks, v, c, sg, dropout_rate=rate,
                                                   dropout_seed=seed)
        o.backward(_t(inp[f"g{i}"][:, sl], dev))
        out[f"exchanges{i}"] = np.int64(ulysses.EXCHANGE["calls"])
        for name, t in (("out", o), ("dqs", qs.grad), ("dks", ks.grad),
                        ("dv", v.grad), ("dcoeffs", c.grad)):
            out[f"{name}{i}"] = _np(t)
    return out


def task_pipeline(sg, inp):
    from differential_transformer_replication_tpu_torch.parallel import (
        create_mesh,
        destroy_mesh,
        multihost,
        pipeline,
    )
    from differential_transformer_replication_tpu_torch.parallel.dp_step import (
        shard_train_state,
    )

    meta = json.loads(str(inp["meta"]))
    out = {}
    for c, case in enumerate(meta["cases"]):
        cfg = TrainConfig(model=ModelConfig(**dict(meta["model"], **case.get("model", {}))),
                          mesh=MeshConfig(**case["mesh"]),
                          **dict(meta["train"], **case.get("train", {})))
        mesh = create_mesh(cfg.mesh, "gloo", str(sg.device))
        try:
            mcfg = cfg.resolved_model()
            dev, pre = mesh.device, case["prefix"]
            state = {"params": _params(inp, mcfg, pre + "p", dev),
                     "opt_state": {"mu": _params(inp, mcfg, pre + "mu", dev),
                                   "nu": _params(inp, mcfg, pre + "nu", dev),
                                   "count": int(meta["count"])},
                     "step": int(meta["step"])}
            for t in leaves(state["params"]):
                t.requires_grad_(True)
            state, _ = shard_train_state(cfg, mesh, state)
            x, y = _t(inp[case["x"]], dev), _t(inp[case["y"]], dev)
            out[f"{c}_coords"] = np.array(mesh.coords)
            out[f"{c}_rest"] = np.int64(sum(t.numel() for t in leaves(state["params"])))
            if case.get("loss_only"):
                local = shard_batch({"x": x, "y": y}, mesh)
                loss = pipeline.make_pipeline_loss(mcfg, mesh)(
                    state["params"], local["x"], local["y"])
                out[f"{c}_loss"] = np.float32(loss)
                continue
            if "xe" in case:
                xe, ye = _t(inp[case["xe"]], dev), _t(inp[case["ye"]], dev)
                out[f"{c}_eval_many"] = np.float32(pipeline.make_pipeline_eval_many(
                    cfg, mesh)(state["params"], xe, ye))
                ev = pipeline.make_pipeline_eval_step(cfg, mesh)
                out[f"{c}_eval_each"] = np.array(
                    [float(ev(state["params"], a, b)) for a, b in zip(xe, ye)], np.float32)
            if case.get("dropout"):
                dcfg = mcfg.replace(dropout=0.3)
                local = shard_batch({"x": x, "y": y}, mesh)
                loss_f = pipeline.make_pipeline_loss(dcfg, mesh)
                runs = [loss_f(state["params"], local["x"], local["y"], s)
                        for s in (2, 2, 3, None)]
                runs.append(pipeline.make_pipeline_loss(mcfg, mesh)(
                    state["params"], local["x"], local["y"]))
                out[f"{c}_dropout"] = np.array([float(v) for v in runs], np.float64)
                _, g = loss_f(state["params"], local["x"], local["y"], 2, grads=True)
                out[f"{c}_dropout_gsq"] = np.float64(sum(float((t ** 2).sum()) for t in g))
            log = []
            real = (pipeline.send_, pipeline.recv_)

            def send(t, over, index):
                log.append((0, index, t.numel()))
                return real[0](t, over, index)

            def recv(t, over, index):
                log.append((1, index, t.numel()))
                return real[1](t, over, index)

            pipeline.send_, pipeline.recv_ = send, recv
            try:
                step = pipeline.make_pipeline_train_step(cfg, mesh)
                state, m = step(state, {"x": x, "y": y}, case.get("seed"))
            finally:
                pipeline.send_, pipeline.recv_ = real
            out[f"{c}_traffic"] = np.array(log, np.int64).reshape(-1, 3)
            out[f"{c}_loss"] = np.float32(m["loss"])
            out[f"{c}_grad_norm"] = np.float32(m["grad_norm"])
            own = {k: v for k, v in state["params"].items() if k != "blocks"}
            for i, t in enumerate(leaves(own)):
                out[f"{c}_rep{i}"] = _np(t).copy()
            full = multihost.gather_to_host(state, mesh)
            assert all(not t.is_cuda for t in leaves(full["params"]))
            for i, t in enumerate(leaves(full["params"])):
                out[f"{c}_p{i}"] = _np(t).copy()
        finally:
            destroy_mesh(mesh)
    return out


TASKS = {"rotate": task_rotate, "ring": task_ring, "wrappers": task_wrappers,
         "model": task_model, "step": task_step, "grads": task_grads, "cli": task_cli,
         "cli_corpus": task_cli_corpus, "clis": task_clis, "mesh_step": task_mesh_step,
         "mesh_attention": task_mesh_attention, "ulysses": task_ulysses,
         "tensor_parts": task_tensor_parts, "pipeline": task_pipeline}


def start_ranks(task: str, P: int, d: Path, inputs: dict, timeout: float,
                env: dict = None) -> list:
    """Run ``task`` on P worker processes joined in ``d`` (``env`` added
    to each one's environment); return each rank's (exit code, output).
    Every rank must end within ``timeout`` seconds, else all are killed
    and this raises, so a deadlock fails a test instead of hanging it."""
    d.mkdir(parents=True, exist_ok=True)
    np.savez(d / "in.npz", **inputs)
    repo = Path(__file__).resolve().parents[1]
    base = dict(os.environ, WORLD_SIZE=str(P), LOCAL_WORLD_SIZE=str(P),
                OMP_NUM_THREADS="1", PYTHONPATH=str(repo), **(env or {}))
    procs = [subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), task, str(d)],
        env=dict(base, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(P)]
    try:
        logs = [p.communicate(timeout=timeout)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        raise AssertionError(f"{task}: the ranks did not finish within {timeout} s")
    return [(p.returncode, log) for p, log in zip(procs, logs)]


def run_ranks(task: str, P: int, d: Path, inputs: dict, timeout: float) -> list:
    """:func:`start_ranks`, every rank exiting 0; return each rank's
    outputs."""
    for r, (rc, log) in enumerate(start_ranks(task, P, d, inputs, timeout)):
        if rc != 0:
            raise AssertionError(f"{task} rank {r} exited {rc}:\n{log}")
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
        if "+" in task:  # several tasks in turn, each output key "task/key",
            # each reading its own "meta_<task>" as "meta" where given
            out = {f"{name}/{k}": v for name in task.split("+")
                   for k, v in TASKS[name](sg, dict(
                       inp, **({"meta": inp[f"meta_{name}"]}
                               if f"meta_{name}" in inp else {}))).items()}
        else:
            out = TASKS[task](sg, inp)
    finally:
        destroy_sequence_group(sg)
        dist.destroy_process_group()
    np.savez(d / f"out{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
