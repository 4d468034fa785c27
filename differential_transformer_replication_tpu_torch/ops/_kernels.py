"""Build and load the port's CUDA C++ kernels.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` into
a shared library with a plain C interface, at first use, and loaded with
``ctypes``. The library lands in ``build/torch_kernels/`` at the root of
the checkout, named after a hash of its source and the ``csrc/`` headers
it includes, so an edited source is never served by a stale build; a
concurrent build writes to a temporary name and renames. Pointers and
the CUDA stream cross as ``ctypes.c_void_p``; every C entry point that
launches returns the CUDA error code of its launches
(``cudaGetLastError()``), which the wrapper turns into an exception.
Nothing here imports or builds anything when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint

# C signature of every kernel library: {library: {function: argtypes}}.
_PP = ctypes.POINTER(ctypes.c_void_p)  # a host array of device pointers

# q, k, v, g, lse, delta, coeffs, dq, S, BH, T, H, d, dv, off, scale, w0,
# w1, threshold, inv_keep, dropout_on, dtype, stream
_BWD_DQ = (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _U,
           _U, _U, _F, _I, _I, _P)
# ... dk, dv, S, ... (as _BWD_DQ with two outputs)
_BWD_DKV = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F,
            _U, _U, _U, _F, _I, _I, _P)
# q, k, v, g, lse, delta, coeffs, dq, dk, dv, dq_acc, S, ... (as _BWD_DQ
# with three outputs and a scratch, and no offset)
_BWD_FUSED = (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
              _I, _F, _U, _U, _U, _F, _I, _I, _P)

SIGNATURES = {
    "fused_norm_residual": {
        # M, E, dtype, instance -> workspace floats (-1: refused)
        "fused_norm_residual_bwd_workspace": (_I, _I, _I, _I),
        # x, w, gn, gx, dx, dwb, work, M, E, eps, dtype, instance, stream
        "fused_norm_residual_bwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I,
                                    _I, _P),
        # bad (uint64), blocks, seed, mode, stream: the quotient check
        "fused_norm_residual_quot_check": (_P, _I, _U, _I, _P),
    },
    "fused_swiglu": {
        # x, wg, bg, wx, bx, out, M, E, F, dtype, instance, stream
        "fused_swiglu_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
        # M, E, F, instance -> workspace floats (-1: refused)
        "fused_swiglu_bwd_workspace": (_I, _I, _I, _I),
        # x, wg, bg, wx, bx, gh, dgt, dw, db, work, M, E, F, dtype,
        # instance, stream
        "fused_swiglu_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _P),
    },
    "flash_tm": {
        # qs[S], ks[S], v, coeffs, out, o_all, lse, S, B, T, H, d, dv,
        # ld_qk, ld_v, scale, dtype, stream
        "flash_tm_fwd": (_PP, _PP, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, _I, _I, _F, _I, _P),
        # qs[S], ks[S], v, g, lse, delta, coeffs, dqs[S], dks[S], dv, S, B,
        # T, H, d, dv, ld_qk, ld_v, ld_dqk, ld_dv, scale, dtype, stream
        "flash_tm_bwd": (_PP, _PP, _P, _P, _P, _P, _P, _PP, _PP, _P, _I, _I,
                         _I, _I, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    },
    "flash_bh_fwd": {
        # q, k, v, coeffs, out, o_all, lse, S, BH, T, H, d, dv, off,
        # scale, w0, w1, threshold, inv_keep, dropout_on, dtype, stream
        "flash_bh_fwd": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _F, _U, _U, _U, _F, _I, _I, _P),
    },
    # K2 and K3 in fp32 (flash_bh) and bf16 (flash_bh_bwd_dq,
    # flash_bh_bwd_dkv: tensor cores), K4 in fp32 and bf16 past the
    # tensor-core instances (flash_bh) and on them (flash_bh_bwd_fused),
    # under one C signature each
    "flash_bh": {
        "flash_bh_bwd_dq": _BWD_DQ,
        "flash_bh_bwd_dkv": _BWD_DKV,
        "flash_bh_bwd_fused": _BWD_FUSED,
    },
    "flash_bh_bwd_dq": {"flash_bh_bwd_dq": _BWD_DQ},
    "flash_bh_bwd_dkv": {"flash_bh_bwd_dkv": _BWD_DKV},
    "flash_bh_bwd_fused": {"flash_bh_bwd_fused": _BWD_FUSED},
    "decode_attention": {
        # S, B, L, H, M, d, dv, TK -> workspace floats (-1: refused)
        "decode_attention_workspace": (_I, _I, _I, _I, _I, _I, _I, _I),
        # q, k, v, k_scale, v_scale, pos, tables, coeffs, out, work, S, B,
        # L, H, M, d, dv, TK, n_pages, page_size, pages_per_slot, scale,
        # dtype, kv_int8, paged, stream
        "decode_attention_run": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F,
                                 _I, _I, _I, _P),
    },
}

# dtype codes shared with the C sources
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def require_cuda(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a CUDA tensor on a machine with a card: a
    kernel wrapper never falls back to its plain version off the CPU."""
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{what}: no kernel for device {t.device.type!r}; the plain "
            "version runs only for CPU tensors"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(f"{what}: CUDA is not available")


def on_card(t: torch.Tensor, what: str) -> bool:
    """The dispatch rule of every kernel wrapper: False for a CPU tensor
    (run the plain version), True for a CUDA tensor (launch the kernel),
    and raise for any other device or a CUDA tensor without a card."""
    if t.device.type == "cpu":
        return False
    require_cuda(t, what)
    return True


def needs_grad(*tensors) -> bool:
    """Whether autograd will want a backward through these inputs."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def aligned16(tensors) -> list:
    """The kernels that load 16-byte vectors take operands whose data
    starts 16-byte aligned: any other (a view into a larger buffer) is
    copied, which aligns it. None passes through."""
    return [t if t is None or t.data_ptr() % 16 == 0 else t.clone()
            for t in tensors]


def pointers(tensors) -> ctypes.Array:
    """A host array of the tensors' device pointers (for ``_PP``)."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build on a machine "
                       "with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is built: named after a hash
    of the source, the local headers it reaches (through other headers
    too) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    seen, todo = set(), [src]
    while todo:
        for header in re.findall(rb'#include "([^"]+)"', todo.pop()):
            if header not in seen:
                seen.add(header)
                todo.append((CSRC / header.decode()).read_bytes())
                src += todo[-1]
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def _compile_cmd(name: str, out: Path) -> list:
    return [nvcc_path(), *NVCC_FLAGS, "-o", str(out), str(CSRC / f"{name}.cu")]


def build(names=None) -> dict:
    """Compile the named kernel libraries (all by default) that are not
    built yet, one ``nvcc`` per source, all started together. Returns
    {name: library path}. Raises with the compiler's output on failure."""
    names = list(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}
    for name in names:
        path = library_path(name)
        if not path.exists():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            todo[name] = (path, Path(tmp), subprocess.Popen(
                _compile_cmd(name, Path(tmp)), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
            ))
    errors = []
    for name, (path, tmp, proc) in todo.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            path.with_suffix(".log").write_text(log)
            os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: library_path(name) for name in names}


def ptxas_usage(name: str) -> dict:
    """{kernel (mangled name): (registers, spill bytes stored + loaded)}
    of the built library ``name``, from ``ptxas -v`` (the build keeps its
    output beside the library)."""
    usage, fn = {}, None
    for line in library_path(name).with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            fn = m.group(1)
            usage[fn] = [0, 0]
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            usage[fn][1] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            usage[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in usage.items()}


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (built first if needed), with
    ``argtypes``/``restype`` declared for each C entry point (all of them
    return an int)."""
    path = build([name])[name]
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def check(rc: int, what: str) -> None:
    """Turn a launch's CUDA error code into an exception."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
