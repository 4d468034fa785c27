"""Checkpointing and resume, in the JAX package's own format.

Counterpart of ``differential_transformer_replication_tpu/train/
checkpoint.py``. A training checkpoint is a directory of
``state.msgpack`` (the train state as flax serializes it: params, the
optax chain's AdamW moments and counts, the step), ``meta.json``
(``best_val_loss``, ``iter_num``, the full train config as
``cfg.to_dict()``, ``consumed_windows``) and ``manifest.json`` (per-file
SHA-256 digests, written last: its presence certifies the checkpoint;
train/ckpt_writer.py holds the atomic writes, verification, ``step-*``
rotation and the async writer). The bytes of ``state.msgpack`` are what
``flax.serialization.to_bytes`` writes for the same state
(train/state_codec.py), so a directory either package writes loads and
verifies in the other. ``save_pretrained`` / ``from_pretrained`` keep
the JAX package's ``params.msgpack`` + ``config.json`` pair.

The port has no pipeline, so the stage-stacked layout is never written
or read. A run built from a corpus records its tokenizer's
``tokenizer_fingerprint`` in the meta (a pre-encoded token stream has
none); the trainer checks it on resume. With a
sequence-parallel group every rank holds the same state: rank 0 writes,
every rank reads.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Optional, Tuple

import torch

from differential_transformer_replication_tpu_torch.config import ModelConfig, TrainConfig
from differential_transformer_replication_tpu_torch.models import init_model
from differential_transformer_replication_tpu_torch.params import (
    check_tree_like,
    host_tree,
    params_from_jax,
    train_state_from_jax,
    train_state_to_jax,
)
from differential_transformer_replication_tpu_torch.train import state_codec
from differential_transformer_replication_tpu_torch.train.ckpt_writer import (
    AsyncCheckpointWriter,
    CheckpointError,
    atomic_write,
    gc_step_checkpoints,
    list_step_checkpoints,
    read_manifest,
    step_dir_name,
    verify_checkpoint,
    write_manifest,
)

__all__ = [
    "AsyncCheckpointWriter",
    "CheckpointError",
    "ElasticResumeError",
    "config_hash",
    "elastic_resume_info",
    "from_pretrained",
    "load_checkpoint",
    "load_params_for_inference",
    "read_meta",
    "resolve_resume_auto",
    "save_checkpoint",
    "save_pretrained",
    "save_step_checkpoint",
    "verify_checkpoint",
]

class ElasticResumeError(RuntimeError):
    """A checkpoint cannot be resumed onto THIS runtime configuration:
    the model's parameter shapes differ, or the sampler's position cannot
    be reproduced exactly under the new batch math (and
    ``--allow-inexact-resume`` was not given). Says which field diverged
    and what would make the resume legal."""


def config_hash(cfg_dict: dict) -> str:
    """The JAX package's recipe hash (train/metrics.py:config_hash) of a
    ``cfg.to_dict()``: two checkpoint trees or metric streams with the
    same hash are the same experiment."""
    blob = json.dumps(cfg_dict, sort_keys=True, default=str)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def save_checkpoint(
    path: str, state: dict, best_val_loss: float, cfg: TrainConfig,
    tokenizer_fingerprint: Optional[str] = None,
    consumed_windows: Optional[int] = None,
) -> None:
    """Write one certified checkpoint directory of the port's train state
    (params, optimizer state, step; the guard is dropped) in the JAX
    package's format. Every file lands atomically, the manifest last."""
    host = train_state_to_jax(state)
    _write_checkpoint_dir(
        path, host, _checkpoint_meta(host, best_val_loss, cfg,
                                     tokenizer_fingerprint, consumed_windows)
    )


def _checkpoint_meta(
    state: dict, best_val_loss: float, cfg: TrainConfig,
    tokenizer_fingerprint: Optional[str],
    consumed_windows: Optional[int] = None,
) -> dict:
    meta = {
        "best_val_loss": float(best_val_loss),
        "iter_num": int(state["step"]),
        "config": cfg.to_dict(),
        # the epoch sampler's exact position, in WINDOWS CONSUMED: the
        # elastic-resume anchor (elastic_resume_info); the trainer supplies
        # it, the derivation covers direct callers
        "consumed_windows": int(
            consumed_windows if consumed_windows is not None
            else int(state["step"]) * cfg.grad_acc_steps
            * cfg.micro_batch_size
        ),
    }
    if tokenizer_fingerprint:
        meta["tokenizer_fingerprint"] = tokenizer_fingerprint
    return meta


def _write_checkpoint_dir(path: str, state: dict, meta: dict) -> None:
    """Serialize + write one certified checkpoint directory from a host
    state tree (train_state_to_jax): ``state.msgpack``, ``meta.json``,
    then the integrity manifest, each atomically. Runs on the async
    writer thread for periodic step checkpoints, inline for best/last
    saves."""
    os.makedirs(path, exist_ok=True)
    atomic_write(os.path.join(path, "state.msgpack"), state_codec.to_bytes(state))
    atomic_write(
        os.path.join(path, "meta.json"), json.dumps(meta, indent=1).encode()
    )
    write_manifest(
        path, step=meta["iter_num"], config_hash=_config_hash(meta)
    )


def _config_hash(meta: dict) -> Optional[str]:
    cfg = meta.get("config")
    return config_hash(cfg) if isinstance(cfg, dict) else None


def save_step_checkpoint(
    root: str,
    state: dict,
    best_val_loss: float,
    cfg: TrainConfig,
    tokenizer_fingerprint: Optional[str] = None,
    writer: Optional[AsyncCheckpointWriter] = None,
    keep_last: int = 3,
    keep_every: int = 0,
    consumed_windows: Optional[int] = None,
) -> float:
    """One rotating periodic checkpoint ``<root>/step-NNNNNNNN``,
    certified by its manifest, then retention GC (the newest
    ``keep_last`` certified + every ``keep_every``-th step). The host
    snapshot is taken here on the caller's thread; with a ``writer``,
    serialization, file I/O, certification and GC run on its thread and
    the return value is the seconds spent waiting for a previous save
    still in flight (0.0 when idle, always 0.0 in sync mode)."""
    host = train_state_to_jax(state)
    path = os.path.join(root, step_dir_name(int(host["step"])))
    meta = _checkpoint_meta(host, best_val_loss, cfg,
                            tokenizer_fingerprint, consumed_windows)

    def job() -> None:
        _write_checkpoint_dir(path, host, meta)
        gc_step_checkpoints(root, keep_last=keep_last, keep_every=keep_every)

    if writer is None:
        job()
        return 0.0
    return writer.submit(job)


# model-config fields that DETERMINE parameter shapes: a checkpoint whose
# saved values differ here cannot be resumed onto the runtime
_SHAPE_FIELDS = (
    "model", "n_embd", "n_head", "n_layer", "block_size", "n_terms",
)


def elastic_resume_info(meta: dict, cfg: TrainConfig) -> dict:
    """Check checkpoint-vs-runtime compatibility for a (possibly elastic)
    resume and return what the trainer needs, as the JAX package does:

    - parameter shapes must agree field by field (:data:`_SHAPE_FIELDS`,
      vocab_size, control_head_multiplier), else
      :class:`ElasticResumeError` names every divergent field;
    - the sampler anchor is the meta's recorded ``consumed_windows`` (or,
      for older checkpoints, step x the saving run's batch), so the epoch
      permutation stays exact when the global batch size changed;
    - a consumed count that is not a multiple of the new global batch, or
      a legacy checkpoint without one under changed batch math, raises
      unless ``cfg.allow_inexact_resume``.

    Returns ``{"elastic", "batch_changed", "exact", "saved_mesh",
    "consumed_windows"}``."""
    saved_cfg = meta.get("config") or {}
    saved_model = saved_cfg.get("model") or {}

    new_model = cfg.model
    mismatches = []
    for f in _SHAPE_FIELDS:
        if f in saved_model and saved_model[f] != getattr(new_model, f):
            mismatches.append(
                f"model.{f}: checkpoint {saved_model[f]!r} vs runtime "
                f"{getattr(new_model, f)!r}"
            )
    for f in ("vocab_size", "control_head_multiplier"):
        if f in saved_cfg and saved_cfg[f] != getattr(cfg, f):
            mismatches.append(
                f"{f}: checkpoint {saved_cfg[f]!r} vs runtime "
                f"{getattr(cfg, f)!r}"
            )
    if mismatches:
        raise ElasticResumeError(
            "checkpoint parameter shapes are incompatible with this "
            "run — elastic resume reshards, it cannot reshape: "
            + "; ".join(mismatches)
            + ". Match the model config, or start fresh."
        )

    saved_mesh = saved_cfg.get("mesh") or {}
    new_mesh = dataclasses.asdict(cfg.mesh)
    elastic = bool(saved_mesh) and saved_mesh != new_mesh

    consumed = meta.get("consumed_windows")
    saved_batch = None
    if "grad_acc_steps" in saved_cfg and "micro_batch_size" in saved_cfg:
        saved_batch = (
            int(saved_cfg["grad_acc_steps"])
            * int(saved_cfg["micro_batch_size"])
        )
        if consumed is None and "iter_num" in meta:
            consumed = int(meta["iter_num"]) * saved_batch
    new_batch = cfg.grad_acc_steps * cfg.micro_batch_size
    batch_changed = saved_batch is not None and saved_batch != new_batch

    exact = True
    problem = None
    if consumed is None:
        if batch_changed:
            problem = (
                "the checkpoint records neither consumed_windows nor "
                "its batch math, and the global batch size changed "
                f"(now {new_batch}) — the epoch-sampler position "
                "cannot be reproduced"
            )
    elif int(consumed) % new_batch != 0:
        problem = (
            f"consumed_windows={int(consumed)} is not a multiple of "
            f"the new global batch ({new_batch} windows/step): the "
            "resume lands mid-accumulation, so optimizer steps and "
            "data position cannot stay aligned exactly"
        )
    if problem is not None:
        exact = False
        if not cfg.allow_inexact_resume:
            raise ElasticResumeError(
                f"elastic resume cannot be exact: {problem}. Restore "
                "the original --grad-acc-steps/--micro-batch-size, or "
                "pass --allow-inexact-resume to accept a bounded "
                "sampler drift."
            )
    return {
        "elastic": elastic,
        "batch_changed": batch_changed,
        "exact": exact,
        "saved_mesh": saved_mesh or None,
        "consumed_windows": None if consumed is None else int(consumed),
    }


def resolve_resume_auto(
    cfg: TrainConfig,
) -> Tuple[Optional[str], List[Tuple[str, str]]]:
    """``--resume-from auto``: the newest checkpoint (by recorded step)
    that PASSES manifest verification among the run's ``step-*`` tree,
    its last checkpoint and its best checkpoint, falling back to older
    ones. Returns ``(path_or_None, skipped)``, ``skipped`` listing
    ``(path, reason)`` for each candidate that failed before the winner."""
    candidates = [p for _, p in list_step_checkpoints(cfg.resolved_ckpt_dir())]
    for path in (cfg.resolved_last_checkpoint_path(), cfg.checkpoint_path):
        if path and os.path.isdir(path):
            candidates.append(path)
    # order by recorded step from a cheap manifest read, then verify
    # newest-first; at equal steps the step dir wins over last/best
    ordered: List[Tuple[int, int, str]] = []
    skipped: List[Tuple[str, str]] = []
    for i, path in enumerate(candidates):
        try:
            step = int(read_manifest(path).get("step", -1))
        except CheckpointError as e:
            skipped.append((path, str(e)))
            continue
        ordered.append((step, -i, path))
    for _, _, path in sorted(ordered, reverse=True):
        try:
            verify_checkpoint(path)
            return path, skipped
        except CheckpointError as e:
            skipped.append((path, str(e)))
    return None, skipped


def _read_state(path: str, name: str = "state.msgpack"):
    """The state dict of a checkpoint file, lists restored from their
    index maps; a CheckpointError naming the file if it cannot be read."""
    state_path = os.path.join(path, name)
    try:
        with open(state_path, "rb") as f:
            data = bytearray(os.fstat(f.fileno()).st_size)
            f.readinto(data)
        return state_codec.lists_from_index_maps(state_codec.from_bytes(data))
    except (ValueError, TypeError, KeyError, IndexError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"cannot deserialize checkpoint state at {state_path!r}: "
            f"{type(e).__name__}: {e}. The file is truncated/corrupt or "
            "from an incompatible model/optimizer config — restore it "
            "from a good copy or resume from a different checkpoint"
        ) from e


def load_checkpoint(
    path: str, cfg: TrainConfig, target_state: dict, verify: bool = True,
) -> Tuple[dict, float]:
    """Restore (state, best_val_loss) from a checkpoint directory either
    package wrote. ``target_state`` (create_train_state's output) gives
    the param structure, which the file must match, and the device. A
    guarded target gets its fresh guard back (checkpoints carry none).

    ``verify`` (default on) re-hashes every file against the integrity
    manifest first: a corrupt or partly written checkpoint raises a
    :class:`CheckpointError` naming the file; ``verify=False`` loads a
    manifest-less legacy checkpoint."""
    if not os.path.isfile(os.path.join(path, "state.msgpack")):
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (expected {path}/state.msgpack)"
        )
    if verify:
        verify_checkpoint(path)
    tree = _read_state(path)
    state_path = os.path.join(path, "state.msgpack")
    device = _first_leaf(target_state["params"]).device
    try:
        if set(tree) != {"opt_state", "params", "step"}:
            raise ValueError(f"top-level keys {sorted(tree)}, expected "
                             "['opt_state', 'params', 'step']")
        state = train_state_from_jax(tree, cfg.resolved_model(), device)
        for part in ("params", "mu", "nu"):
            check_tree_like(target_state["params"],
                            state["params"] if part == "params"
                            else state["opt_state"][part], part)
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointError(
            f"checkpoint state at {state_path!r} does not fit this run's "
            f"train state: {e}"
        ) from e
    if "guard" in target_state:
        state["guard"] = target_state["guard"]
    meta = read_meta(path)
    try:
        best = meta["best_val_loss"]
    except KeyError as e:
        raise CheckpointError(
            f"checkpoint meta at {os.path.join(path, 'meta.json')!r} has "
            "no 'best_val_loss' — the file is corrupt or not a training "
            "checkpoint"
        ) from e
    return state, best


def _first_leaf(tree) -> torch.Tensor:
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) else tree[0]
    return tree


def read_meta(path: str) -> dict:
    """A checkpoint dir's meta.json, or one :class:`CheckpointError`
    naming the path for a missing, truncated or garbage file."""
    meta_path = os.path.join(path, "meta.json")
    try:
        with open(meta_path) as f:
            return json.load(f)
    except FileNotFoundError:
        raise CheckpointError(
            f"no checkpoint metadata at {meta_path!r} (the directory is "
            "not a checkpoint, or the save was interrupted before the "
            "atomic rename)"
        ) from None
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointError(
            f"cannot parse checkpoint metadata at {meta_path!r}: {e}. "
            "The file is truncated or corrupt — restore it from a good "
            "copy or resume from a different checkpoint"
        ) from e


def _validate_quantize(quantize: Optional[str]) -> None:
    if quantize not in ("int8", None, "", "none"):
        raise ValueError(
            f"unsupported weight quantization {quantize!r}; expected "
            "'int8' or None"
        )


def apply_weight_quantization(params: dict, quantize: Optional[str]) -> dict:
    """The one place the ``--quantize-weights`` option is interpreted:
    validates ``quantize`` and returns ``params`` with per-channel int8
    quantize-then-dequantize applied to every matmul weight
    (ops/decode_attention.py:``quantize_params_int8``), or untouched for
    None/""/"none". Shared by :func:`load_params_for_inference`,
    :func:`from_pretrained` and the server's random-init demo model."""
    _validate_quantize(quantize)
    if quantize == "int8":
        from differential_transformer_replication_tpu_torch.ops.decode_attention import (
            quantize_params_int8,
        )

        params = quantize_params_int8(params)
    return params


def _expected_params(model_cfg: ModelConfig) -> dict:
    """The param tree a model config builds (the values are a throwaway
    seed-0 init on the CPU: only keys and shapes are compared)."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    return init_model(gen, model_cfg)


def load_params_for_inference(
    path: str, verify: bool = True, quantize: Optional[str] = None,
    device="cpu",
) -> Tuple[dict, ModelConfig, dict]:
    """Load a TRAINING checkpoint dir (meta.json + state.msgpack) for
    inference: (params as fp32 tensors on ``device``, the resolved
    ModelConfig, the raw meta dict). ``verify`` digest-checks the
    manifest first, as :func:`load_checkpoint` does; ``quantize="int8"``
    quantizes and dequantizes every matmul weight on load
    (:func:`apply_weight_quantization`)."""
    _validate_quantize(quantize)
    meta = read_meta(path)
    try:
        saved = meta["config"]
        cfg = TrainConfig(
            model=ModelConfig(**saved["model"]),
            vocab_size=saved["vocab_size"],
            control_head_multiplier=saved["control_head_multiplier"],
        )
    except (KeyError, TypeError) as e:
        raise CheckpointError(
            f"checkpoint metadata at "
            f"{os.path.join(path, 'meta.json')!r} is missing the saved "
            f"train config ({type(e).__name__}: {e}) — the file is "
            "corrupt or from an incompatible version"
        ) from e
    if not os.path.isfile(os.path.join(path, "state.msgpack")):
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (expected {path}/state.msgpack)"
        )
    if verify:
        verify_checkpoint(path)
    model_cfg = cfg.resolved_model()
    tree = _read_state(path)
    try:
        params = params_from_jax(tree["params"], model_cfg, device)
        check_tree_like(_expected_params(model_cfg), params)
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointError(
            f"checkpoint params at {os.path.join(path, 'state.msgpack')!r} "
            f"do not fit the saved model config: {e}"
        ) from e
    return apply_weight_quantization(params, quantize), model_cfg, meta


def save_pretrained(path: str, params: dict, model_cfg: ModelConfig) -> None:
    """Self-describing model checkpoint for any of the three families:
    ``params.msgpack`` (flax's bytes of the param tree, floating leaves
    as fp32) and ``config.json`` (``{"model_args": ...}``)."""
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(state_codec.to_bytes(host_tree(params)))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump({"model_args": dataclasses.asdict(model_cfg)}, f, indent=1)


def from_pretrained(
    path: str, quantize: Optional[str] = None, device="cpu",
) -> Tuple[dict, ModelConfig]:
    """(params on ``device``, ModelConfig) from a :func:`save_pretrained`
    directory of either package; ``quantize`` as in
    :func:`load_params_for_inference`."""
    _validate_quantize(quantize)
    with open(os.path.join(path, "config.json")) as f:
        model_cfg = ModelConfig(**json.load(f)["model_args"])
    tree = _read_state(path, "params.msgpack")
    try:
        params = params_from_jax(tree, model_cfg, device)
        check_tree_like(_expected_params(model_cfg), params)
    except (ValueError, KeyError, TypeError) as e:
        raise CheckpointError(
            f"params at {os.path.join(path, 'params.msgpack')!r} do not "
            f"fit the model config in config.json: {e}"
        ) from e
    return apply_weight_quantization(params, quantize), model_cfg

