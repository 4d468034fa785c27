"""Pins of the PyTorch port's package boundary, on the CPU.

The port imports ``torch`` and never ``jax``, and nothing of the JAX
package, not even its jax-free modules: a fresh interpreter that imports
every module of the port must end with neither in ``sys.modules`` (the
pattern of tests/test_lint_clean.py), and no source file of the port may
name them in an import statement, lazy imports inside functions
included, nor the repo's ``tools/`` modules (which import the JAX
package). The fleet front (``serving/router.py``,
``serving/admission.py``, ``serving/fleet.py``) and the control plane
over it (``serving/autoscaler.py``) load not even torch or numpy, so
they keep routing, relaunching and steering while the runtimes they
front crash. Nor does
the port import ``tokenizers`` or ``regex``: the card's
machine is not promised them, and the port's byte-level BPE is its own
(``datasets`` stays allowed, imported lazily inside the corpus loader's
fallback ``try``). Kernel wrappers dispatch by device: off the CPU they launch
their kernel or raise, never run the plain version.
"""

from __future__ import annotations

import ast
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
PKG = "differential_transformer_replication_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "tokenizers", "regex",
             "ml_dtypes", "differential_transformer_replication_tpu")


# host-side modules that must never load torch: the router keeps routing,
# the fleet supervisor keeps relaunching and the control plane keeps
# steering, while the runtimes they front crash
FLEET_FRONT = (f"{PKG}.serving.router", f"{PKG}.serving.admission",
               f"{PKG}.serving.fleet", f"{PKG}.serving.autoscaler")
# the repo's tools/ modules, which import the JAX package: the port keeps
# its own copies of what it needs from them
TOOL_MODULES = ("tools", "autoscaler", "fleet", "perf_gate", "slo_report",
                "serve_bench", "train_supervisor")


def _modules():
    root = REPO / PKG
    out = []
    for path in sorted(root.rglob("*.py")):
        rel = path.relative_to(REPO).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts = parts[:-1]
        out.append(".".join(parts))
    return out


def test_every_module_imports_without_jax():
    mods = _modules()
    assert len(mods) >= 15
    # the walk reaches every subpackage, the sequence-parallel ring included
    for sub in ("ops", "models", "serving", "train", "parallel", "obs", "utils"):
        assert f"{PKG}.{sub}" in mods, sub
    assert {f"{PKG}.parallel.mesh", f"{PKG}.parallel.ring",
            f"{PKG}.parallel.ulysses", f"{PKG}.parallel.sharding",
            f"{PKG}.parallel.dp_step"} <= set(mods)
    # the fleet front: router, predictive admission, fleet supervisor,
    # and the control plane over them
    assert set(FLEET_FRONT) <= set(mods)
    # the full trainer's modules: resilience and observability
    assert {f"{PKG}.utils.faults", f"{PKG}.utils.profiling",
            f"{PKG}.train.watchdog", f"{PKG}.train.metrics",
            f"{PKG}.parallel.heartbeat", f"{PKG}.obs.registry",
            f"{PKG}.obs.http", f"{PKG}.obs.spans",
            f"{PKG}.obs.introspect"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        # the parallel package's exports, the lazy ones included
        f"from {PKG}.parallel import (create_mesh, make_sharded_train_step,\n"
        "    shard_batch, ulysses_multi_stream_attention)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def test_fleet_front_imports_without_torch():
    code = (
        "import importlib, sys\n"
        f"for m in {FLEET_FRONT!r}:\n"
        "    importlib.import_module(m)\n"
        f"from {PKG}.serving import Router, serve_router, backoff_delay\n"
        f"from {PKG}.serving.migrate import ReplayJournal\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"('torch', 'numpy', 'triton') + {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_roots(tree):
    for node in ast.walk(tree):  # walks function bodies: lazy imports too
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0], node.lineno
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0], node.lineno


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / PKG).rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_source_names_no_jax_import(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = [(root, line) for root, line in _imported_roots(tree)
           if root in FORBIDDEN + TOOL_MODULES]
    assert not bad, f"{path} imports {bad}"


def test_kernel_wrappers_raise_off_the_cpu_instead_of_falling_back():
    from differential_transformer_replication_tpu_torch.ops import (
        decode_attention as dat,
        flash,
        fused_ffn as ffn,
        fused_norm_residual as fnr,
    )

    meta = torch.device("meta")
    qkv = [torch.empty(1, 8, 2 * 4, device=meta) for _ in range(3)]
    lse = torch.empty(1, 8, 2, device=meta)
    # head-major chunk operands: q/k (BH, S, T, d), v, per-stream do, lse
    hm = [torch.empty(2, 2, 8, 16, device=meta), torch.empty(2, 8, 32, device=meta),
          torch.empty(2, 2, 8, 32, device=meta), torch.empty(2, 2, 8, device=meta)]
    x = torch.empty(4, 32, device=meta)
    w = torch.empty(32, device=meta)
    calls = {
        "fused_norm": lambda: fnr.fused_norm(x, w, w),
        "fused_add_norm": lambda: fnr.fused_add_norm(x, x, w, w),
        "fused_swiglu": lambda: ffn.fused_swiglu(
            x, torch.empty(32, 64, device=meta), torch.empty(64, device=meta),
            torch.empty(32, 64, device=meta), torch.empty(64, device=meta)),
        "decode_attention": lambda: dat.decode_attention(
            torch.empty(1, 2, 2, 8, device=meta),
            torch.empty(1, 2, 2, 16, 8, device=meta),
            torch.empty(2, 2, 16, 8, device=meta),
            torch.empty(2, dtype=torch.int32, device=meta),
            torch.empty(1, 2, device=meta)),
        "add_norm_bwd": lambda: fnr.add_norm_bwd(x, w, x, x),
        "swiglu_bwd": lambda: ffn.swiglu_bwd(
            x, torch.empty(32, 64, device=meta), torch.empty(64, device=meta),
            torch.empty(32, 64, device=meta), torch.empty(64, device=meta),
            torch.empty(4, 64, device=meta)),
        "flash_tm_fwd": lambda: flash.flash_tm_fwd(
            qkv[:1], qkv[1:2], qkv[2], torch.ones(1, 2, device=meta), 2, True),
        "flash_tm_bwd": lambda: flash.flash_tm_bwd(
            qkv[:1], qkv[1:2], qkv[2], qkv[2], lse, lse,
            torch.ones(1, 2, device=meta), 2, qkv[:1], qkv[1:2], qkv[2]),
        "flash_chunk_fwd": lambda: flash.flash_chunk_fwd(
            hm[0], hm[0], hm[1], 0, 0.0, (0, 0)),
        "flash_chunk_bwd_dq": lambda: flash.flash_chunk_bwd_dq(
            hm[0], hm[0], hm[1], hm[2], hm[3], hm[3], 8, 0.0, (0, 0)),
        "flash_chunk_bwd_dkv": lambda: flash.flash_chunk_bwd_dkv(
            hm[0], hm[0], hm[1], hm[2], hm[3], hm[3], -8, 0.0, (0, 0)),
    }
    wrappers = {"fused_norm": fnr.fused_norm, "fused_add_norm": fnr.fused_add_norm,
                "fused_swiglu": ffn.fused_swiglu,
                "decode_attention": dat.decode_attention,
                "add_norm_bwd": fnr.add_norm_bwd, "swiglu_bwd": ffn.swiglu_bwd,
                "flash_tm_fwd": flash.flash_tm_fwd,
                "flash_tm_bwd": flash.flash_tm_bwd,
                "flash_chunk_fwd": flash.flash_chunk_fwd,
                "flash_chunk_bwd_dq": flash.flash_chunk_bwd_dq,
                "flash_chunk_bwd_dkv": flash.flash_chunk_bwd_dkv}
    before = {k: f.launches for k, f in wrappers.items()}
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="no kernel for device 'meta'"):
            call()
    assert {k: f.launches for k, f in wrappers.items()} == before


def test_kernel_sources_and_build_flags():
    from differential_transformer_replication_tpu_torch.ops import _kernels

    for name in _kernels.SIGNATURES:
        src = (_kernels.CSRC / f"{name}.cu").read_text()
        assert "extern \"C\" int" in src
        for fn, argtypes in _kernels.SIGNATURES[name].items():
            assert fn in src
            # the ctypes declaration has one type per C parameter
            m = re.search(r'extern "C" int ' + fn + r"\((.*?)\)", src, re.S)
            assert m and len(m.group(1).split(",")) == len(argtypes), fn
    assert "arch=compute_90a,code=sm_90a" in _kernels.NVCC_FLAGS
    # the build output lives in a directory git ignores
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    assert _kernels.BUILD_DIR.relative_to(REPO).parts[0] == "build"
