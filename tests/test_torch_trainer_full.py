"""The port's full trainer against the JAX trainer, on the CPU: guard
rollback and abort, fault injection, the metric families, the
introspection records, the step watchdog under the supervisor and the
heartbeat on a ring.

Both trainers start from one JAX-initialised step-0 checkpoint
(checkpoints cross both ways) and train on the same corpus cache (the
synthetic corpus through the BPE; the port reads the JAX package's cache
entry) with the same epoch draws, so they run the same steps. Under
``corrupt_params@K`` and under a persistent ``nan@A-B`` they must take
the same rollbacks at the same iterations, write the same ``rollbacks``
and ``skipped_steps`` on every record, abort with
``TrainingDivergedError`` at the same iteration without overwriting the
last checkpoint, and register the same metric families with the same
counter values (each side's ``Registry`` wrapped to capture it). Losses
are held within tests/test_torch_train.py's fp32 bound, the lambdas of
the introspection rows within 1e-6.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from differential_transformer_replication_tpu.config import ModelConfig as JModelConfig
from differential_transformer_replication_tpu.config import TrainConfig as JTrainConfig
from differential_transformer_replication_tpu.train import checkpoint as jckpt
from differential_transformer_replication_tpu.train import step as jstep
from differential_transformer_replication_tpu.train import trainer as jtrainer
from differential_transformer_replication_tpu.utils import faults as jfaults
from differential_transformer_replication_tpu_torch.config import (
    ModelConfig,
    TrainConfig,
)
from differential_transformer_replication_tpu_torch.obs import registry as treg
from differential_transformer_replication_tpu_torch.train import checkpoint as tckpt
from differential_transformer_replication_tpu_torch.train import trainer as ttrainer
from differential_transformer_replication_tpu_torch.train.anomaly import (
    TrainingDivergedError,
)
from differential_transformer_replication_tpu_torch.train.watchdog import (
    HANG_EXIT_CODE,
)
from differential_transformer_replication_tpu_torch.utils import faults as tfaults

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_ring_worker  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SUPERVISOR = REPO / "tools" / "train_supervisor.py"
FP32_TOL = 1e-5  # tests/test_torch_train.py: losses of the same steps
TINY = dict(model="diff", vocab_size=256, n_embd=32, n_head=2, n_layer=2,
            block_size=16, dropout=0.0, compute_dtype="float32")
COMMON = dict(vocab_size=256, dataset="synthetic", num_train_samples=200,
              micro_batch_size=4, eval_iters=1, log_interval=1,
              learning_rate=3e-3, min_lr=3e-4, warmup_iters=2, seed=7)
# no compile cache in eager PyTorch: the JAX trainer's one family and
# record key the port does not have
JAX_ONLY_FAMILIES = {"train_compile_events_total"}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv(jfaults.ENV_VAR, raising=False)
    jfaults.reset()
    tfaults.reset()
    yield
    jfaults.reset()
    tfaults.reset()


@pytest.fixture(scope="module")
def init_ckpt(tmp_path_factory):
    """A JAX-initialised step-0 checkpoint and the shared corpus cache."""
    d = tmp_path_factory.mktemp("init")
    jcfg = JTrainConfig(model=JModelConfig(**TINY), tokenizer_dir=str(d / "tok"),
                        checkpoint_path=str(d / "unused"), **COMMON)
    _, vocab, _, _ = jtrainer.build_data(jcfg)  # the entry both trainers load
    jcfg = jcfg.replace(vocab_size=vocab)  # the tokenizer's, as the trainers do
    state = jstep.create_train_state(jax.random.PRNGKey(11), jcfg)
    jckpt.save_checkpoint(str(d / "init.ckpt"), state, float("inf"), jcfg,
                          consumed_windows=0)
    return d


def _cfgs(d: Path, name: str, init: Path, **kw):
    """(JAX config, port config) of one run under ``d/name``, resumed from
    the step-0 checkpoint."""
    run = d / name
    run.mkdir(parents=True, exist_ok=True)
    common = dict(COMMON, tokenizer_dir=str(init / "tok"),
                  resume_from=str(init / "init.ckpt"), **kw)

    def paths(side):
        return dict(checkpoint_path=str(run / f"{side}.best.ckpt"),
                    metrics_path=str(run / f"{side}.jsonl"))
    return (JTrainConfig(model=JModelConfig(**TINY), **common, **paths("jax")),
            TrainConfig(model=ModelConfig(**TINY), **common, **paths("port")))


def _capture_registries(monkeypatch):
    """Wrap both trainers' Registry: every registry they make is kept."""
    made = {"jax": [], "port": []}
    for side, mod in (("jax", jtrainer), ("port", ttrainer)):
        base = mod.Registry

        class Kept(base):
            def __init__(self, _side=side, _base=base):
                _base.__init__(self)
                made[_side].append(self)
        monkeypatch.setattr(mod, "Registry", Kept)
    return made


def _families(reg) -> dict:
    return {m.name: (type(m).__name__, m.help) for m in reg.metrics()}


def _counters(reg) -> dict:
    types, samples = treg.parse_exposition(reg.render())
    return {(n, tuple(sorted(lab.items()))): v for n, lab, v in samples
            if types.get(n) == "counter"}


def _rows(path) -> list:
    return [json.loads(x) for x in open(path)]


def _rollbacks(out: str) -> list:
    return [(int(a), int(b)) for a, b in re.findall(
        r"\[anomaly\] \d+ consecutive bad steps at iter (\d+): rolling back "
        r"to iter (\d+)", out)]


def _run_both(capsys, jcfg, tcfg, expect_abort=False):
    """Both trainers on their configs: (JAX output, port output)."""
    outs = []
    for side, fn in (("jax", lambda: jtrainer.train(jcfg)),
                     ("port", lambda: ttrainer.train(tcfg, device="cpu"))):
        if expect_abort:
            with pytest.raises(Exception) as e:
                fn()
            assert type(e.value).__name__ == "TrainingDivergedError", side
            if side == "port":
                assert isinstance(e.value, TrainingDivergedError)
            outs.append((capsys.readouterr().out, str(e.value)))
        else:
            fn()
            outs.append((capsys.readouterr().out, None))
    return outs


def _compare_records(jpath, tpath, check_losses=True):
    jrows, trows = _rows(jpath), _rows(tpath)
    kinds = lambda rows: [r.get("record", "eval" if "val_loss" in r else "step")  # noqa: E731
                          for r in rows]
    assert kinds(trows) == kinds(jrows)
    for j, t in zip(jrows, trows):
        kind = j.get("record", "eval" if "val_loss" in j else "step")
        if kind == "run_header":
            continue
        assert set(t) == set(j) - {"compile_events"}, (kind, j.get("iter"))
        assert t["iter"] == j["iter"]
        if kind == "step":
            assert t["skipped_steps"] == j["skipped_steps"], j["iter"]
            assert t["rollbacks"] == j["rollbacks"], j["iter"]
            if check_losses:
                assert (np.isnan(t["loss"]) and np.isnan(j["loss"])) or \
                    abs(t["loss"] - j["loss"]) <= FP32_TOL, j["iter"]
        elif kind == "introspection":
            for k, v in j.items():
                if k.startswith("lambda_"):
                    assert abs(t[k] - v) <= 1e-6, k
    return jrows, trows


def test_rollback_on_corrupt_params_matches_jax(tmp_path, init_ckpt, capsys,
                                                monkeypatch):
    made = _capture_registries(monkeypatch)
    jcfg, tcfg = _cfgs(tmp_path, "rollback", init_ckpt, max_iters=12,
                       eval_interval=6, faults="corrupt_params@8",
                       anomaly_check_interval=1, anomaly_rollback_after=2,
                       anomaly_snapshot_interval=3, anomaly_max_rollbacks=1)
    (jout, _), (tout, _) = _run_both(capsys, jcfg, tcfg)
    # one rollback, once iterations 8 and 9 are bad, to the snapshot at 6
    assert _rollbacks(tout) == _rollbacks(jout) == [(10, 6)]
    jrows, trows = _compare_records(jcfg.metrics_path, tcfg.metrics_path)
    steps = [r for r in trows if "loss" in r]
    assert [r["iter"] for r in steps] == [*range(1, 10), *range(7, 13)]
    assert [r["rollbacks"] for r in steps] == [0] * 9 + [1] * 6
    assert [r["skipped_steps"] for r in steps] == [0] * 8 + [1] + [0] * 6
    # the replayed steps end where an unfaulted run of the port ends
    _, clean = _cfgs(tmp_path, "clean", init_ckpt, max_iters=12, eval_interval=6)
    _, history = ttrainer.train(clean, device="cpu")
    last_of_iter = {r["iter"]: r["loss"] for r in steps}
    assert [m["loss"] for m in history] == [last_of_iter[i] for i in range(1, 13)]
    faulted = tckpt.read_meta(tcfg.resolved_last_checkpoint_path())
    assert faulted["iter_num"] == 12
    a = Path(tcfg.resolved_last_checkpoint_path(), "state.msgpack").read_bytes()
    b = Path(clean.resolved_last_checkpoint_path(), "state.msgpack").read_bytes()
    assert a == b
    # the metric families (name, type, help) and the counters
    (jreg,), (treg_,) = made["jax"], made["port"][:1]
    jf = _families(jreg)
    assert _families(treg_) == {k: v for k, v in jf.items()
                                if k not in JAX_ONLY_FAMILIES}
    jc, tc = _counters(jreg), _counters(treg_)
    assert tc == {k: v for k, v in jc.items() if k[0] not in JAX_ONLY_FAMILIES}
    assert tc[("train_iterations_total", ())] == 15
    assert tc[("train_anomaly_events_total", (("kind", "rollback"),))] == 1
    assert tc[("train_anomaly_events_total", (("kind", "skip"),))] == 1
    intro = [r for r in trows if r.get("record") == "introspection"]
    assert [r["iter"] for r in intro] == [6, 12]
    assert {"lambda_l1", "lambda_l2", "param_norm_l2", "grad_norm_head"} <= \
        set(intro[-1])


def test_persistent_nan_aborts_like_jax_without_overwriting_the_last_checkpoint(
        tmp_path, init_ckpt, capsys):
    jcfg, tcfg = _cfgs(tmp_path, "abort", init_ckpt, max_iters=30,
                       eval_interval=100, faults="nan@4-29",
                       anomaly_check_interval=2, anomaly_rollback_after=3,
                       anomaly_snapshot_interval=2, anomaly_max_rollbacks=2)
    before = {}
    for cfg in (jcfg, tcfg):  # a previous good last checkpoint
        last = cfg.resolved_last_checkpoint_path()
        shutil.copytree(init_ckpt / "init.ckpt", last)
        before[last] = Path(last, "state.msgpack").read_bytes()
    (jout, jerr), (tout, terr) = _run_both(capsys, jcfg, tcfg, expect_abort=True)
    assert _rollbacks(tout) == _rollbacks(jout) == [(8, 4), (8, 4)]
    assert terr == jerr
    assert "at iter 8" in terr
    for last, data in before.items():
        assert Path(last, "state.msgpack").read_bytes() == data
    assert "skipping last-checkpoint save: non-finite loss" in tout
    _compare_records(jcfg.metrics_path, tcfg.metrics_path)


def test_default_guard_rolls_back_and_aborts_where_jax_does(tmp_path, init_ckpt,
                                                            capsys):
    """The four rollback fields at their defaults (check every 10 steps,
    roll back after 20 bad steps, at most 3 rollbacks, a snapshot every
    200): a run whose every step from 5 on is NaN rolls back to its entry
    snapshot three times and then aborts, as the JAX trainer does; it
    never ends as if it had succeeded."""
    jcfg, tcfg = _cfgs(tmp_path, "default", init_ckpt, max_iters=40,
                       eval_interval=1000, log_interval=10, faults="nan@5-40")
    for cfg in (jcfg, tcfg):
        assert (cfg.anomaly_rollback_after, cfg.anomaly_check_interval,
                cfg.anomaly_max_rollbacks, cfg.anomaly_snapshot_interval) == \
            (20, 10, 3, 200)
    (jout, jerr), (tout, terr) = _run_both(capsys, jcfg, tcfg, expect_abort=True)
    assert _rollbacks(tout) == _rollbacks(jout) == [(30, 0)] * 3
    assert terr == jerr and "at iter 30" in terr
    _compare_records(jcfg.metrics_path, tcfg.metrics_path)
    assert not os.path.exists(tcfg.resolved_last_checkpoint_path())


# ---------------------------------------------------------------------------
# the watchdog under the supervisor; heartbeats on a ring
# ---------------------------------------------------------------------------


def _cli_argv(d: Path, tokens: Path, *extra) -> list:
    return ["-m", "differential_transformer_replication_tpu_torch.train",
            "--model", "diff", "--tokens", str(tokens), "--device", "cpu",
            "--n-embd", "32", "--n-head", "2", "--n-layer", "2",
            "--block-size", "16", "--vocab-size", "256",
            "--micro-batch-size", "4", "--max-iters", "10",
            "--eval-interval", "10", "--eval-iters", "1", "--log-interval", "1",
            "--warmup-iters", "2", "--learning-rate", "3e-3",
            "--compute-dtype", "float32",
            "--checkpoint-path", str(d / "best.ckpt"),
            "--metrics-path", str(d / "metrics.jsonl"), *extra]


def test_supervisor_restarts_a_hung_port_run_from_its_step_checkpoint(tmp_path):
    tokens = tmp_path / "t.npy"
    np.save(tokens, np.random.default_rng(0).integers(0, 256, 4000).astype(np.int32))
    log = tmp_path / "restarts.json"
    cmd = [sys.executable, *_cli_argv(tmp_path, tokens, "--ckpt-interval", "4",
                                      "--ckpt-keep-last", "4",
                                      "--step-deadline-s", "2",
                                      "--resume-from", "auto")]
    env = dict(os.environ, PYTHONPATH=str(REPO), DTX_FAULTS="train_hang@6",
               DTX_TRAIN_HANG_S="120")
    proc = subprocess.run(
        [sys.executable, str(SUPERVISOR), "--backoff-base", "0.05",
         "--max-restarts", "0", "--max-hang-restarts", "1",
         "--restart-log", str(log), "--", *cmd],
        capture_output=True, text=True, timeout=300, env=env, cwd=str(tmp_path))
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-3000:])
    records = [json.loads(x) for x in open(log)]
    assert [r["outcome"] for r in records] == ["hang", "clean"]
    assert records[0]["rc"] == HANG_EXIT_CODE
    report = json.load(open(tmp_path / "best.hang_report.json"))
    assert report["iter"] == 6
    assert "train_stall" in report["threads"]["MainThread"]
    assert "--resume-from auto: resuming from" in proc.stdout
    assert "Resumed from" in proc.stdout and "at iter 4" in proc.stdout
    rows = _rows(tmp_path / "metrics.jsonl")
    assert [r["record"] for r in rows if "record" in r].count("hang") == 1
    assert tckpt.read_meta(str(tmp_path / "best.last.ckpt"))["iter_num"] == 10


def test_a_silent_rank_makes_rank_0_exit_113_naming_it(tmp_path):
    tokens = tmp_path / "t.npy"
    np.save(tokens, np.random.default_rng(1).integers(0, 64, 20000).astype(np.int32))
    argv = ["--model", "diff", "--tokens", str(tokens), "--sampler", "replacement",
            "--device", "cpu", "--n-embd", "32", "--n-head", "2", "--n-layer", "1",
            "--block-size", "32", "--vocab-size", "64", "--micro-batch-size", "2",
            "--max-iters", "100000", "--eval-interval", "100000",
            "--eval-iters", "1", "--warmup-iters", "1", "--log-interval", "1",
            "--compute-dtype", "float32", "--metrics-path", "",
            "--checkpoint-path", str(tmp_path / "best.ckpt"),
            "--last-checkpoint-path", "",
            "--sequence-parallel", "2", "--dist-backend", "gloo",
            "--heartbeat-dir", str(tmp_path / "hb"),
            "--heartbeat-interval-s", "0.2", "--heartbeat-timeout-s", "2",
            "--faults", "heartbeat_silence@1"]
    res = torch_ring_worker.start_ranks("cli", 2, tmp_path / "ranks",
                                        {"argv": np.array(argv)}, timeout=120)
    (rc0, log0), (rc1, log1) = res
    assert rc0 == HANG_EXIT_CODE, log0[-3000:]
    assert rc1 != 0, log1[-3000:]
    report = json.load(open(tmp_path / "best.hang_report.json"))
    assert "peer process 1 heartbeat silent" in report["reason"]
    assert report["process_index"] == 0
    assert 1 in {int(k) for k in report["heartbeat_ages"]}
    assert sorted(os.listdir(tmp_path / "hb")) == ["hb-0.json"]  # 1 is muted


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

FULL_TRAINER_FLAGS = [
    ("--anomaly-rollback-after", "5", "anomaly_rollback_after", 5),
    ("--anomaly-max-rollbacks", "2", "anomaly_max_rollbacks", 2),
    ("--anomaly-snapshot-interval", "7", "anomaly_snapshot_interval", 7),
    ("--anomaly-check-interval", "3", "anomaly_check_interval", 3),
    ("--step-deadline-s", "30", "step_deadline_s", 30.0),
    ("--hang-report-path", "r.json", "hang_report_path", "r.json"),
    ("--heartbeat-dir", "hb", "heartbeat_dir", "hb"),
    ("--heartbeat-interval-s", "0.5", "heartbeat_interval_s", 0.5),
    ("--heartbeat-timeout-s", "5", "heartbeat_timeout_s", 5.0),
    ("--faults", "nan@3", "faults", "nan@3"),
    ("--metrics-port", "9310", "metrics_port", 9310),
    ("--trace-path", "t.json", "trace_path", "t.json"),
    ("--profile-dir", "prof", "profile_dir", "prof"),
]


@pytest.mark.parametrize("flag,value,field,want", FULL_TRAINER_FLAGS,
                         ids=[f[0] for f in FULL_TRAINER_FLAGS])
def test_cli_takes_each_full_trainer_flag_as_train_py_does(flag, value, field, want):
    from differential_transformer_replication_tpu_torch.train import __main__ as cli

    assert not cli.refused_flags([flag])
    cfg = cli.config_from_args(cli.build_parser().parse_args([flag, value]))
    assert getattr(cfg, field) == want
    assert cli.config_from_args(cli.build_parser().parse_args(["--wandb"])).use_wandb


@pytest.mark.parametrize("flag,item", [
    ("--profile-every", "tooling and analysis, item 10"),
    ("--profile-spool-dir", "tooling and analysis, item 10"),
    ("--data-parallel", "parallelism, item 9"),
    ("--tensor-parallel", "parallelism, item 9"),
    ("--fsdp", "parallelism, item 9"),
    ("--pipeline-parallel", "parallelism, item 9"),
    ("--no-dp-overlap", "parallelism, item 9"),
    ("--dp-bucket-layers", "parallelism, item 9"),
])
def test_cli_still_refuses_later_items_naming_them(flag, item, capsys):
    """A flag of a later item is refused naming it. The parallelism
    flags of item 9 run now: each is taken as the root ``train.py`` takes
    it."""
    import importlib.util

    from differential_transformer_replication_tpu_torch.train import __main__ as cli

    if flag not in cli.LATER_FLAGS:
        assert flag in ("--data-parallel", "--tensor-parallel", "--fsdp",
                        "--pipeline-parallel", "--no-dp-overlap", "--dp-bucket-layers")
        spec = importlib.util.spec_from_file_location(
            "root_train", Path(__file__).resolve().parents[1] / "train.py")
        jtrain = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(jtrain)
        argv = [flag] if flag == "--no-dp-overlap" else [flag, "2"]
        assert not cli.refused_flags(argv)
        got = cli.config_from_args(cli.build_parser().parse_args(argv))
        want = jtrain.config_from_args(jtrain.build_parser().parse_args(argv))
        for field in ("dp_overlap", "dp_bucket_layers"):
            assert getattr(got, field) == getattr(want, field)
        for axis in ("data", "fsdp", "tensor", "sequence", "pipeline"):
            assert getattr(got.mesh, axis) == getattr(want.mesh, axis)
        return
    with pytest.raises(SystemExit):
        cli.run([flag, "1"])
    assert f"ROADMAP Queue A: {item}" in capsys.readouterr().err



MEMORY_FLAGS = [
    ["--remat"],
    ["--remat", "--remat-policy", "dots"],
    ["--remat", "--remat-policy", "dots_no_batch"],
    ["--remat", "--remat-policy", "nothing"],
    ["--remat", "--remat-policy", "everything"],
    ["--remat-policy", "nothing"],
    ["--loss-chunk", "2048"],
    ["--remat", "--loss-chunk", "128"],
]


@pytest.mark.parametrize("argv", MEMORY_FLAGS, ids=" ".join)
def test_cli_takes_remat_and_loss_chunk_as_train_py_does(argv):
    """The three flags reach ``TrainConfig.model`` with the values that
    the root ``train.py`` gives the JAX package's."""
    import importlib.util

    from differential_transformer_replication_tpu_torch.train import __main__ as cli

    spec = importlib.util.spec_from_file_location(
        "root_train", Path(__file__).resolve().parents[1] / "train.py")
    jtrain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jtrain)
    assert not cli.refused_flags(argv)
    got = cli.config_from_args(cli.build_parser().parse_args(argv)).model
    want = jtrain.config_from_args(jtrain.build_parser().parse_args(argv)).model
    for field in ("remat", "remat_policy", "loss_chunk"):
        assert getattr(got, field) == getattr(want, field), field