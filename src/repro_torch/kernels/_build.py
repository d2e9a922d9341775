"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` named in :data:`SOURCES` has a plain C interface
(``csrc/sm90_common.cu`` holds Hopper helpers that four of them include,
and is not built on its own) and is compiled on first use with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own
shared library under ``build/repro_torch_kernels/`` at the root of the
checkout (``REPRO_TORCH_BUILD_DIR`` overrides it), then loaded with
``ctypes``.  The library name carries a hash of its source, of the
files it includes and of the compiler flags (:data:`NVCC_FLAGS`), so an
edited source is rebuilt.  Nothing is linked beyond the CUDA runtime:
the tensor maps of the TMA loads come from libcuda's
``cuTensorMapEncodeTiled``, looked up with ``dlsym``.  :func:`build`
starts one ``nvcc`` per source at once.  ``-Xptxas -v`` reports each
kernel's registers and spills; the report is kept beside the library,
and :func:`ptxas_info` reads it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises on a nonzero code.  A failed build raises: nothing
falls back to the plain PyTorch path.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

__all__ = ["SOURCES", "NVCC_FLAGS", "build", "load", "ptxas_info", "check", "stream_ptr",
           "alignment"]

_CSRC = Path(__file__).resolve().parent / "csrc"
_REPO_ROOT = Path(__file__).resolve().parents[3]

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# kernel name → C entry points and their argument types
SOURCES: Dict[str, Dict[str, List]] = {
    "flash_attention": {
        # q, k, v, o, B, Sq, Skv, Hq, Hkv, hd, causal, window, scale, stream
        "fa_fwd_bf16": [P, P, P, P, I, I, I, I, I, I, I, I, F, P],
        "fa_fwd_f32": [P, P, P, P, I, I, I, I, I, I, I, I, F, P],
        # q, k, v, o, B, S, Hq, Hkv, hd, window, scale, rows, keys, pack, stream
        "fa_fwd_bf16_wgmma": [P, P, P, P, I, I, I, I, I, I, F, I, I, I, P],
    },
    "block_sparse_matmul": {
        # x, w_comp, idx, y, B, K, Gn, L, cluster, stream
        "bsm_bf16_decode": [P, P, P, P, I, I, I, I, I, P],
        "bsm_bf16_prefill": [P, P, P, P, I, I, I, I, I, P],
        # x, w_comp, idx, y, B, K, Gn, L, bm, bn, stream
        "bsm_bf16_general": [P, P, P, P, I, I, I, I, I, I, P],
        "bsm_f32": [P, P, P, P, I, I, I, I, I, I, P],
    },
    "block_importance": {
        # w, out, M, N, bm, bn, criterion (0 = l1, 1 = l2), stream
        "bi_bf16": [P, P, I, I, I, I, I, P],
        "bi_f32": [P, P, I, I, I, I, I, P],
        # w, out, M, N, criterion, stream
        "bi_bf16_strip": [P, P, I, I, I, P],
        "bi_f32_strip": [P, P, I, I, I, P],
    },
    "intrablock_matmul": {
        # x, w_comp, row_idx, y, B, K, Kc, N, ldw (w_comp's row stride), cluster, stream
        "igm_bf16_decode": [P, P, P, P, I, I, I, I, I, I, P],
        # x, w_comp, row_idx, x-gather scratch, y, B, K, Kc, Kp, N, ldw, cluster, stream
        "igm_bf16_prefill": [P, P, P, P, P, I, I, I, I, I, I, I, P],
        # x, w_comp, row_idx, y, B, K, Kc, N, ldw, stream
        "igm_bf16_general": [P, P, P, P, I, I, I, I, I, P],
        "igm_f32": [P, P, P, P, I, I, I, I, I, P],
    },
    "bitserial_profile": {
        # q, counter (8 bytes scratch), out (int32[2]), V, K, group_rows, n_bits, stream
        "bsp_count": [P, P, P, I, I, I, I, P],
        # q, accumulator (8 bytes, zero between calls), out, V, K, group_rows, n_bits, grid,
        # stream
        "bsp_count_strip": [P, P, P, I, I, I, I, I, P],
        # x, amin, amax (or null, null), scale, accumulator, out, V, K, group_rows, n_bits,
        # grid, stream
        "bsp_fused_bf16": [P, P, P, F, P, P, I, I, I, I, I, P],
        "bsp_fused_f32": [P, P, P, F, P, P, I, I, I, I, I, P],
    },
    "decode_attention": {
        # q, k_new, v_new, K, V, pos, pos_stride, scratch, tickets, out, B, Smax, Hkv, G,
        # chunk, nsplit, scale, stream
        "da_decode_bf16": [P, P, P, P, P, P, I, P, P, P, I, I, I, I, I, I, F, P],
    },
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LIBS: Dict[str, ctypes.PyDLL] = {}


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


def _source_bytes(path: Path) -> bytes:
    """A source with the files it includes from ``csrc`` (``#include "..."``)."""
    src = path.read_bytes()
    parts = [src]
    for inc in re.findall(rb'^#include "([^"]+)"', src, flags=re.M):
        parts.append(_source_bytes(_CSRC / inc.decode()))
    return b"".join(parts)


def _lib_path(name: str) -> Path:
    src = _source_bytes(_CSRC / f"{name}.cu") + " ".join(NVCC_FLAGS).encode()
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
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
    errors = []
    for n, (tmp, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed for {n}.cu (rc {p.returncode}):\n{log}")
        else:
            out[n].with_suffix(".ptxas.txt").write_text(log)
            os.replace(tmp, out[n])
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.PyDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        # PyDLL keeps the GIL held during a call: a launch is short, and the
        # tensor-map tables of the libraries rely on one caller at a time
        lib = ctypes.PyDLL(str(build([name])[name]))
        for fn, argtypes in SOURCES[name].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def ptxas_info(name: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name) of library ``name``, as ptxas reported it
    when the library was built: ``registers`` a thread, ``stack`` frame,
    ``spill_stores`` and ``spill_loads`` bytes.  Builds the library first
    if needed."""
    log = build([name])[name].with_suffix(".ptxas.txt").read_text()
    info: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            info.setdefault(fn, {}).update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                                           spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            info.setdefault(fn, {})["registers"] = int(m.group(1))
            fn = None
    return info


def check(rc: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on ``device``, as a pointer-sized int."""
    return torch.cuda.current_stream(device).cuda_stream


def alignment(*ptrs: int) -> int:
    """The largest power of two (at most 256) that divides every address."""
    a = 256
    for p in ptrs:
        while p % a:
            a //= 2
    return a
