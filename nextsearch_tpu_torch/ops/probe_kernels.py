"""Lowering probes P1-P5 as hand-written CUDA kernels, with plain versions.

Replace the five kernels of nextsearch_tpu's benchmarks/mosaic_probe.py,
which checked what Mosaic could lower for the TPU's unified kernel (K5): an
NT dot, a row copy at an index read on the device, the one-hot window op (a
scatter-add), a reshape and a transpose. They run on no serving path;
nextsearch_tpu_torch/benchmarks/kernel_probe.py runs each against its plain
version.

Each wrapper checks its arguments, runs the plain PyTorch version for CPU
tensors, and otherwise launches its kernel from
``nextsearch_tpu_torch/csrc/heavy.cu`` (built by ops/cuda_build.py),
raising if the launch fails; launches are counted in ``<wrapper>.launches``.
"""

from __future__ import annotations

import torch

from .cuda_build import check_aligned, check_rc, library, stream


def reset_launch_counts() -> None:
    for fn in (nt_dot, row_copy, window_op, reshape_copy, transpose):
        fn.launches = 0


def _f32_2d(name: str, *ts: torch.Tensor) -> None:
    for t in ts:
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise TypeError(f"{name}: operands must be contiguous 2D float32")
        if t.device != ts[0].device:
            raise ValueError(f"{name}: operands on different devices")
        if t.device.type not in ("cpu", "cuda"):
            raise ValueError(f"{name}: unsupported device {t.device}")


def _launch(fn, name, entry, *args, dev):
    lib = library()
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(*args, stream(dev))
    check_rc(rc, name)
    fn.launches += 1


# ---------------------------------------------------------------- P1


def nt_dot_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of nt_dot (true fp32: TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    return a @ b.T


def nt_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """o = a @ b.T for a f32 [Q, W] and b f32 [T, W] (mosaic_probe t1)."""
    _f32_2d("nt_dot", a, b)
    if a.shape[1] != b.shape[1]:
        raise ValueError(f"nt_dot: {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.device.type == "cpu":
        return nt_dot_ref(a, b)
    (q, w), t = a.shape, b.shape[0]
    o = torch.empty((q, t), dtype=torch.float32, device=a.device)
    _launch(nt_dot, "nt_dot", "ns_probe_nt_dot", a.data_ptr(), b.data_ptr(),
            o.data_ptr(), q, t, w, dev=a.device)
    return o


# ---------------------------------------------------------------- P2


def row_copy_ref(e: torch.Tensor, off: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain version of row_copy."""
    r = off[:1].long().clamp(0, e.shape[0] - 1)
    return e.index_select(0, r).expand(rows, -1) * 2.0


def row_copy(e: torch.Tensor, off: torch.Tensor, rows: int) -> torch.Tensor:
    """[rows, W] copies of 2 * e[off[0]], the row index read on the device
    (mosaic_probe t2: a dynamic-offset row DMA from a scalar-prefetched
    index; clamped to e's rows here)."""
    _f32_2d("row_copy", e)
    if off.dim() != 1 or off.numel() < 1 or off.dtype not in (torch.int32,
                                                               torch.int64):
        raise TypeError("row_copy: off must be a 1D integer tensor")
    if off.device != e.device:
        raise ValueError("row_copy: e and off on different devices")
    if e.device.type == "cpu":
        return row_copy_ref(e, off, rows)
    n_rows, w = e.shape
    off32 = off.to(torch.int32).contiguous()
    o = torch.empty((rows, w), dtype=torch.float32, device=e.device)
    _launch(row_copy, "row_copy", "ns_probe_row_copy", e.data_ptr(),
            off32.data_ptr(), o.data_ptr(), n_rows, rows, w, dev=e.device)
    return o


# ---------------------------------------------------------------- P3

WINDOW_MAX = 1024  # entries the kernel stages in shared memory


def window_op_ref(wq: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor, *,
                  q: int, tile: int) -> torch.Tensor:
    """Plain version of window_op: a scatter-add (index_put_ accumulate)."""
    o = torch.zeros((q, tile), dtype=torch.float32, device=wv.device)
    return o.index_put_((wq.long(), wd.long()), wv, accumulate=True)


def window_op(wq: torch.Tensor, wv: torch.Tensor, wd: torch.Tensor, *,
              q: int, tile: int) -> torch.Tensor:
    """The one-hot window op of mosaic_probe t3: o f32 [q, tile] with
    o[wq[w], wd[w]] += wv[w] for each of the W entries (wq, wd int in
    range, wv f32; W <= 1024), entries of one cell added in entry order."""
    if not (wq.dim() == wv.dim() == wd.dim() == 1
            and wq.shape == wv.shape == wd.shape):
        raise ValueError("window_op: wq, wv, wd must be 1D of one length")
    if wv.dtype != torch.float32 or wq.dtype not in (torch.int32, torch.int64) \
            or wd.dtype not in (torch.int32, torch.int64):
        raise TypeError("window_op: int wq/wd and float32 wv required")
    if not (wq.device == wv.device == wd.device):
        raise ValueError("window_op: entries on different devices")
    if wv.numel() > WINDOW_MAX:
        raise ValueError(f"window_op: at most {WINDOW_MAX} entries")
    if wv.device.type == "cpu":
        return window_op_ref(wq, wv, wd, q=q, tile=tile)
    wq32 = wq.to(torch.int32).contiguous()
    wd32 = wd.to(torch.int32).contiguous()
    wv = wv.contiguous()
    o = torch.empty((q, tile), dtype=torch.float32, device=wv.device)
    _launch(window_op, "window_op", "ns_probe_window_op", wq32.data_ptr(),
            wv.data_ptr(), wd32.data_ptr(), o.data_ptr(), q, tile, wv.numel(),
            dev=wv.device)
    return o


# ---------------------------------------------------------------- P4 / P5


def reshape_copy_ref(a: torch.Tensor, shape) -> torch.Tensor:
    """Plain version of reshape_copy."""
    return a.reshape(shape).clone()


def reshape_copy(a: torch.Tensor, shape) -> torch.Tensor:
    """a reshaped to `shape` into new memory (mosaic_probe t4's
    (4, 128, Q) -> (512, Q)): a row-major reshape is a copy."""
    if a.dtype != torch.float32 or not a.is_contiguous():
        raise TypeError("reshape_copy: a must be contiguous float32")
    out_shape = torch.Size(shape)
    if out_shape.numel() != a.numel():
        raise ValueError(f"reshape_copy: {tuple(a.shape)} -> {tuple(shape)}")
    if a.device.type == "cpu":
        return reshape_copy_ref(a, shape)
    if a.numel() % 4:
        raise ValueError("reshape_copy: size must be a multiple of 4")
    check_aligned(a)
    o = torch.empty(out_shape, dtype=torch.float32, device=a.device)
    _launch(reshape_copy, "reshape_copy", "ns_probe_copy", a.data_ptr(),
            o.data_ptr(), a.numel(), dev=a.device)
    return o


def transpose_ref(a: torch.Tensor) -> torch.Tensor:
    """Plain version of transpose."""
    return a.T.contiguous()


def transpose(a: torch.Tensor) -> torch.Tensor:
    """a.T into new memory, a f32 [R, C] (mosaic_probe t5: [1, 128] ->
    [128, 1])."""
    _f32_2d("transpose", a)
    if a.device.type == "cpu":
        return transpose_ref(a)
    r, c = a.shape
    o = torch.empty((c, r), dtype=torch.float32, device=a.device)
    _launch(transpose, "transpose", "ns_probe_transpose", a.data_ptr(),
            o.data_ptr(), r, c, dev=a.device)
    return o


reset_launch_counts()
