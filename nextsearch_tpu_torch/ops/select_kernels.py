"""Per-query windowed top-k selection (K4) as a hand-written CUDA kernel.

Replaces nextsearch_tpu/ops/select_pallas.py per_query_topk_pallas. The
light-totals stream of the packed path is sorted by (q, doc), so each
query's candidates are one contiguous window of it; the kernel selects each
window's top k2 in place instead of re-sorting the whole stream.

The wrapper runs the plain PyTorch version for CPU tensors (the CPU tests)
and launches the kernel (``ns_per_query_topk`` in
``nextsearch_tpu_torch/csrc/heavy.cu``, built by ops/cuda_build.py) for CUDA
tensors, raising if the launch fails; it counts
launches in ``per_query_topk.launches``. The kernel is a one-pass threshold
select (a radix select of the k2-th largest value, then the ties in window
order).
"""

from __future__ import annotations

import torch

from .bm25 import f32_order_key
from .cuda_build import check_rc, counted, library, stream


K2_MAX = 1024  # winners the kernel holds in shared memory (the TPU kernel's: 128)


def reset_launch_counts() -> None:
    per_query_topk.launches = 0


def per_query_topk_ref(scores: torch.Tensor, bounds: torch.Tensor, k2: int):
    """Plain PyTorch version of per_query_topk (per_query_topk_xla_ref's
    semantics): the flat array ordered by (query, score desc, index asc),
    then each query's first k2 live entries."""
    n = scores.numel()
    q_count = bounds.numel() - 1
    dev = scores.device
    if n == 0:
        return (torch.zeros((q_count, k2), dtype=torch.float32, device=dev),
                torch.zeros((q_count, k2), dtype=torch.int64, device=dev))
    gi = torch.arange(n, dtype=torch.int64, device=dev)
    seg = torch.searchsorted(bounds.to(torch.int64), gi, right=True) - 1
    live = (scores > 0) & (seg >= 0) & (seg < q_count)
    seg = torch.where(live, seg, torch.full_like(seg, q_count))
    neg = torch.where(live, -scores, torch.full_like(scores, float("inf")))
    # (query, score desc) key; the stable sort keeps index order among ties
    order = torch.sort((seg << 32) | f32_order_key(neg), stable=True).indices
    first = torch.searchsorted(
        seg[order], torch.arange(q_count + 1, dtype=torch.int64, device=dev))
    idx = first[:-1, None] + torch.arange(k2, dtype=torch.int64, device=dev)
    ok = idx < first[1:, None]
    pick = order[idx.clamp(max=n - 1)]
    vals = torch.where(ok, scores[pick], torch.zeros((), device=dev))
    gidx = torch.where(ok, pick, torch.zeros_like(pick))
    return vals, gidx


def per_query_topk(scores: torch.Tensor, bounds: torch.Tensor, k2: int):
    """Each query's top-k2 entries of its window of a flat array.

    scores f32 [N]; bounds int [Q+1], query q's window is
    scores[bounds[q]:bounds[q+1]] (non-decreasing bounds, bounds[0] = 0 in
    the packed path). Returns (vals
    f32 [Q, k2], gidx int64 [Q, k2]): the k2 largest positive values, exact,
    in descending order with the lowest flat index first among equal values,
    and their global flat indices; slots past a query's live entries (value
    <= 0) are 0 / 0. Any window length gives the exact result; 1 <= k2 <=
    K2_MAX.
    """
    if scores.dim() != 1 or scores.dtype != torch.float32:
        raise TypeError("per_query_topk: scores must be 1D float32")
    if bounds.dim() != 1 or bounds.numel() < 1 or \
            bounds.dtype not in (torch.int32, torch.int64):
        raise TypeError("per_query_topk: bounds must be a 1D integer tensor")
    if not 1 <= k2 <= K2_MAX:
        raise ValueError(f"per_query_topk: k2={k2} outside [1, {K2_MAX}]")
    if scores.device != bounds.device:
        raise ValueError("per_query_topk: scores and bounds on different devices")
    if scores.device.type == "cpu":
        return per_query_topk_ref(scores, bounds, k2)
    if scores.device.type != "cuda":
        raise ValueError(f"per_query_topk: unsupported device {scores.device}")
    lib = library()
    dev = scores.device
    q_count = bounds.numel() - 1
    scores = scores.contiguous()
    b64 = bounds.to(torch.int64).contiguous()
    vals = torch.empty((q_count, k2), dtype=torch.float32, device=dev)
    gidx = torch.empty((q_count, k2), dtype=torch.int64, device=dev)
    if q_count == 0:
        return vals, gidx
    with torch.cuda.device(dev):
        rc = lib.ns_per_query_topk(
            scores.data_ptr(), b64.data_ptr(), scores.numel(), q_count, k2,
            vals.data_ptr(), gidx.data_ptr(), stream(dev),
        )
    check_rc(rc, "per_query_topk")
    per_query_topk.launches += 1
    return vals, gidx


counted(per_query_topk)
