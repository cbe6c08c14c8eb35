"""Build and load the port's CUDA kernels (``nextsearch_tpu_torch/csrc/heavy.cu``).

The source is compiled by nvcc (sm_90a) into a shared library with a plain
C interface and loaded with ctypes, at first use, into
``nextsearch_tpu_torch/build/`` (gitignored), keyed on a hash of the source
and flags, so a fresh checkout builds it once and later processes reuse it.
Nothing here runs at import time: the CPU tests import every module and
never build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "heavy.cu"
_BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_vp, _ci, _cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C entry point -> argtypes; every entry returns a cudaError_t
_SIGNATURES = {
    "ns_mix_lists": [_vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _vp, _ci, _vp],
    # the mix lists' arguments (count, cols, vals, L, bf16 mix, its columns)
    # sit together in each product entry
    "ns_heavy_fused3": [_vp, _vp, _ci, _ci, _ci, _vp, _vp, _vp, _ci, _vp, _ci,
                        _vp, _vp, _vp, _ci, _ci, _cll, _vp],
    "ns_unified_fused": [_vp, _vp, _ci, _ci, _vp, _vp, _vp, _ci, _vp, _ci, _vp,
                         _vp, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _cll, _vp],
    "ns_heavy_variant": [_vp, _vp, _ci, _ci, _ci, _ci, _vp, _vp, _vp, _ci, _vp,
                         _ci, _vp, _vp, _vp, _vp, _vp, _ci, _ci, _cll, _vp],
    "ns_gather_rows": [_vp, _vp, _ci, _vp, _ci, _ci, _ci, _cll, _vp],
    "ns_per_query_topk": [_vp, _vp, _cll, _ci, _ci, _vp, _vp, _vp],
    "ns_score_epilogue": [_vp, _vp, _ci, _ci, _cll, _cll, _vp, _vp, _ci, _vp],
    "ns_probe_nt_dot": [_vp, _vp, _vp, _ci, _ci, _ci, _vp],
    "ns_probe_row_copy": [_vp, _vp, _vp, _ci, _ci, _ci, _vp],
    "ns_probe_window_op": [_vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp],
    "ns_probe_copy": [_vp, _vp, _cll, _vp],
    "ns_probe_transpose": [_vp, _vp, _ci, _ci, _vp],
}

_lock = threading.Lock()
_lib = None
# Filled by the first build in this process: seconds spent, the library,
# and nvcc's -Xptxas -v report (registers, shared memory, spills per kernel).
BUILD_INFO: dict = {}


def _nvcc() -> str:
    """Path of nvcc: PATH first, then the toolkit PyTorch itself found."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source has none."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        src = _SRC.read_bytes()
        key = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()
        so = _BUILD_DIR / f"libheavy_{key[:16]}.so"
        t0 = time.perf_counter()
        log = ""
        if not so.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            log = proc.stderr
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = _ci
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, library=str(so), ptxas=log,
        )
        _lib = lib
        return lib


def build() -> dict:
    """Build and load the kernels now (normally done at first launch)."""
    library()
    return dict(BUILD_INFO)


# Every kernel wrapper's launch counter, as (object, attribute): each module
# of wrappers registers its own with counted(). A graph replay
# (ops/graphs.py) advances each by what its capture recorded.
COUNTERS: list = []


def counted(*objs, attr: str = "launches") -> None:
    """Register the launch counters objs.<attr>, each starting at 0."""
    for obj in objs:
        setattr(obj, attr, 0)
        COUNTERS.append((obj, attr))


def check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def check_aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
