"""Heavy-term kernels of the sparse path: K1 (fused matmul + selection
epilogue) and K2/K3 (row gathers), as hand-written CUDA for Hopper.

Each public wrapper checks its arguments, runs the plain PyTorch version
when the tensors lie on the CPU (the CPU tests), and launches its CUDA
kernel when they lie on a CUDA device, raising if the launch fails. There is
no switch that routes a CUDA tensor to the plain version. Each wrapper
counts its own kernel launches in ``<wrapper>.launches``.

The kernels live in ``nextsearch_tpu_torch/csrc/heavy.cu``. They are built at
first use with nvcc (sm_90a, plain C interface, loaded with ctypes) into
``nextsearch_tpu_torch/build/``, keyed on a hash of the source and flags, so a
fresh checkout builds them once and later processes reuse the library.

Layouts: the dense table is ``[rows, n_slots]`` and H is ``[Q, n_slots]``
(the JAX package's 3D ``[.., n_slots/128, 128]`` layouts are free views of
these). smax ``[tiles_pad * 16, Q]`` and cnt ``[tiles_pad, Q]`` keep the JAX
layouts, with tiles_pad = round_up(n_slots / 2048, 8).
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

TILE = 2048  # docs per count tile (cnt rows)
CSUB = 128  # docs per selection sub-block (smax rows)
_CPT = TILE // CSUB

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "heavy.cu"
_BUILD_DIR = _PKG / "build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lib_lock = threading.Lock()
_lib = None
# Filled by the first build in this process: seconds spent and nvcc's
# -Xptxas -v report (registers, shared memory, spills per kernel).
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


def _load_library():
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lib_lock:
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
        vp, ci, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ns_heavy_fused3.argtypes = [
            vp, vp, ci, ci, vp, vp, vp, ci, ci, cll, vp,
        ]
        lib.ns_heavy_fused3.restype = ci
        lib.ns_gather_rows.argtypes = [vp, vp, vp, ci, ci, ci, cll, vp]
        lib.ns_gather_rows.restype = ci
        BUILD_INFO.update(
            seconds=time.perf_counter() - t0, library=str(so), ptxas=log,
        )
        _lib = lib
        return lib


def build() -> dict:
    """Build and load the kernels now (normally done at first launch)."""
    _load_library()
    return dict(BUILD_INFO)


def _check_rc(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {rc})")


def _check_aligned(*tensors) -> None:
    for t in tensors:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")


def _stream(device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _pads(n_slots: int):
    n_tiles = n_slots // TILE
    tiles_pad = ((n_tiles + 7) // 8) * 8
    return n_tiles, tiles_pad, tiles_pad * _CPT


def reset_launch_counts() -> None:
    for fn in (heavy_fused3, gather_rows, gather_rows_bf16):
        fn.launches = 0


# ---------------------------------------------------------------- K1


def heavy_fused3_ref(mix: torch.Tensor, table: torch.Tensor, *, fast: bool):
    """Plain PyTorch version of heavy_fused3 (the JAX heavy_fused3_xla).

    fast rounds both operands to bf16 (round-to-nearest-even) first, as the
    TPU's one-pass DEFAULT dot does; the product then runs in f32. TF32 is
    off (torch.backends.cuda.matmul.allow_tf32 = False) so exact mode is a
    true fp32 product on a card as well.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    if fast:
        a = mix.to(torch.bfloat16).float()
        b = table.to(torch.bfloat16).float()
    else:
        a, b = mix, table.float()
    h = a @ b
    q, n_slots = h.shape
    n_tiles, tiles_pad, sub_pad = _pads(n_slots)
    n_sub = n_slots // CSUB
    smax = torch.full(
        (sub_pad, q), float("-inf"), dtype=torch.float32, device=h.device
    )
    smax[:n_sub] = h.view(q, n_sub, CSUB).amax(dim=2).T
    cnt = torch.zeros((tiles_pad, q), dtype=torch.float32, device=h.device)
    cnt[:n_tiles] = (h.view(q, n_tiles, TILE) > 0).sum(dim=2).T.float()
    return h, smax, cnt


def heavy_fused3(mix: torch.Tensor, table: torch.Tensor, *, fast: bool):
    """H = mix @ table, per-128-doc sub-block max and per-tile count of H > 0.

    Replaces nextsearch_tpu/ops/heavy_pallas.py heavy_fused3_pallas (K1).
    mix f32 [Q, ND]; table f32 or bf16 [ND, n_slots], n_slots % 2048 == 0.
    Returns (H f32 [Q, n_slots], smax f32 [tiles_pad*16, Q] padded with
    -inf, cnt f32 [tiles_pad, Q] padded with 0). fast=True is the guarded
    one-pass mode (bf16 operands, f32 accumulation); fast=False is fp32.
    """
    if mix.dim() != 2 or table.dim() != 2:
        raise ValueError("heavy_fused3: mix and table must be 2D")
    if mix.dtype != torch.float32:
        raise TypeError(f"heavy_fused3: mix must be float32, got {mix.dtype}")
    if table.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"heavy_fused3: table dtype {table.dtype}")
    q, nd = mix.shape
    if table.shape[0] != nd:
        raise ValueError(f"heavy_fused3: mix {tuple(mix.shape)} vs table "
                         f"{tuple(table.shape)}")
    n_slots = table.shape[1]
    if n_slots % TILE or q == 0 or nd == 0:
        raise ValueError(f"heavy_fused3: bad shapes Q={q} ND={nd} "
                         f"n_slots={n_slots}")
    if mix.device != table.device:
        raise ValueError("heavy_fused3: mix and table on different devices")
    if not (mix.is_contiguous() and table.is_contiguous()):
        raise ValueError("heavy_fused3: operands must be contiguous")
    if table.device.type == "cpu":
        return heavy_fused3_ref(mix, table, fast=fast)
    if table.device.type != "cuda":
        raise ValueError(f"heavy_fused3: unsupported device {table.device}")
    _check_aligned(mix, table)
    lib = _load_library()
    dev = table.device
    _n_tiles, tiles_pad, sub_pad = _pads(n_slots)
    h = torch.empty((q, n_slots), dtype=torch.float32, device=dev)
    smax = torch.full((sub_pad, q), float("-inf"), dtype=torch.float32,
                      device=dev)
    cnt = torch.zeros((tiles_pad, q), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ns_heavy_fused3(
            mix.data_ptr(), table.data_ptr(),
            int(table.dtype == torch.bfloat16), int(bool(fast)),
            h.data_ptr(), smax.data_ptr(), cnt.data_ptr(),
            q, nd, n_slots, _stream(dev),
        )
    _check_rc(rc, "heavy_fused3")
    heavy_fused3.launches += 1
    return h, smax, cnt


# ---------------------------------------------------------------- K2 / K3


def gather_rows_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows."""
    return table[ids]


def gather_rows_bf16_ref(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of gather_rows_bf16."""
    return table[ids].to(torch.bfloat16)


def _gather(ids, table, out_dtype, name, fn):
    if ids.dim() != 1 or ids.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"{name}: ids must be a 1D integer tensor")
    if table.dim() != 2 or table.dtype != torch.float32:
        raise TypeError(f"{name}: table must be 2D float32")
    if ids.device != table.device:
        raise ValueError(f"{name}: ids and table on different devices")
    if not table.is_contiguous():
        raise ValueError(f"{name}: table must be contiguous")
    if table.device.type == "cpu":
        ref = gather_rows_bf16_ref if out_dtype == torch.bfloat16 else gather_rows_ref
        return ref(ids, table)
    if table.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {table.device}")
    n_rows, n_slots = table.shape
    if n_slots % 4 or ids.numel() == 0 or n_rows == 0:
        raise ValueError(f"{name}: bad shapes ids={ids.numel()} "
                         f"table={tuple(table.shape)}")
    _check_aligned(table)
    lib = _load_library()
    dev = table.device
    ids32 = ids.to(torch.int32).contiguous()
    out = torch.empty((ids.numel(), n_slots), dtype=out_dtype, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ns_gather_rows(
            ids32.data_ptr(), table.data_ptr(), out.data_ptr(),
            int(out_dtype == torch.bfloat16), ids.numel(), n_rows, n_slots,
            _stream(dev),
        )
    _check_rc(rc, name)
    fn.launches += 1
    return out


def gather_rows(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[ids] as f32 whole-row copies.

    Replaces nextsearch_tpu/ops/heavy_pallas.py gather_rows_pallas (K3).
    ids int [uc] (clipped to the table's rows by the caller, clamped again
    by the kernel); table f32 [rows, n_slots] -> f32 [uc, n_slots].
    """
    return _gather(ids, table, torch.float32, "gather_rows", gather_rows)


def gather_rows_bf16(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """table[ids] rounded to bf16 (round-to-nearest-even) in the same pass.

    Replaces nextsearch_tpu/ops/heavy_pallas.py gather_rows_bf16_pallas
    (K2): the compact table of the guarded fast launch.
    """
    return _gather(ids, table, torch.bfloat16, "gather_rows_bf16",
                   gather_rows_bf16)


reset_launch_counts()
