"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first
use with ``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own
shared library under ``build/repro_torch_kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), then loaded with
``ctypes``.  The library name carries a hash of its source, so an edited
source is rebuilt.  :func:`build` starts one ``nvcc`` per source at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code.  A failed build raises: nothing
falls back to the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["SOURCES", "build", "load", "check", "stream_ptr"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name → C entry points and their argument types
SOURCES: Dict[str, Dict[str, List]] = {
    "flash_attention": {
        # q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal, window, scale, stream
        "fa_fwd_bf16": [P, P, P, P, I, I, I, I, I, I, I, I, F, P],
        "fa_fwd_f32": [P, P, P, P, I, I, I, I, I, I, I, I, F, P],
    },
    "block_sparse_matmul": {
        # x, w_comp, idx, y, B, K, Gn, L, bm, bn, stream
        "bsm_bf16": [P, P, P, P, I, I, I, I, I, I, P],
        "bsm_f32": [P, P, P, P, I, I, I, I, I, I, P],
    },
    "block_importance": {
        # w, out, M, N, bm, bn, criterion (0 = l1, 1 = l2), stream
        "bi_bf16": [P, P, I, I, I, I, I, P],
        "bi_f32": [P, P, I, I, I, I, I, P],
    },
    "intrablock_matmul": {
        # x, w_comp, row_idx, y, B, K, Kc, N, stream
        "igm_bf16": [P, P, P, P, I, I, I, I, P],
        "igm_f32": [P, P, P, P, I, I, I, I, P],
    },
    "bitserial_profile": {
        # q, counter (8 bytes scratch), out (int32[2]), V, K, group_rows, n_bits, stream
        "bsp_count": [P, P, P, I, I, I, I, P],
    },
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def _build_dir() -> Path:
    d = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(d) if d else _REPO_ROOT / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).exists():
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels of "
                       "repro_torch are compiled on first use")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src).hexdigest()[:12]
    return _build_dir() / f"lib{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile the named kernels (default: all) in parallel; returns paths.

    Libraries already built from the same source are reused.
    """
    names = list(SOURCES if names is None else names)
    out = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    nvcc = _nvcc()
    _build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".tmp{os.getpid()}")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
               str(_CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{log}")
        else:
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        for fn, argtypes in SOURCES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream
