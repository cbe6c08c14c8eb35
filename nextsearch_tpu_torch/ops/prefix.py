"""Prefix-range top-k for autocomplete: the port of
nextsearch_tpu/ops/prefix.py.

Terms live in a sorted table; a prefix maps to a contiguous index range
[lo, hi) found by binary search on the host, and the device ranks the range
by score with a masked top-k. The order is lax.top_k's: score descending,
then the lower index (the lexicographically smaller term), matching the
reference trie's (score desc, term asc) (src/api_autocomplete.cpp:48-51).
torch.topk promises no order among ties, so both functions take the top L
of a unique int64 key, score * 2^32 + (T - 1 - index).
"""

from __future__ import annotations

import torch


def _topk_by_key(vals: torch.Tensor, L: int):
    """(values int32 [Q, L], positions int64 [Q, L]) of each row's L largest
    int32 values, equal values by ascending position."""
    n = vals.shape[1]
    inv = (n - 1) - torch.arange(n, dtype=torch.int64, device=vals.device)
    key = vals.to(torch.int64) * (1 << 32) + inv
    top, _ = torch.topk(key, L, dim=1)
    pos = (n - 1) - (top & 0xFFFFFFFF)
    return torch.gather(vals, 1, pos), pos


def prefix_range_topk(scores: torch.Tensor, lo: torch.Tensor,
                      hi: torch.Tensor, *, L: int):
    """Top-L (score desc, index asc) within [lo, hi) per query, over the
    whole table: the fallback for ranges wider than every window.

    scores int32 [T] (summed df, sorted-term order), lo/hi int32 [Q].
    Returns (vals int32 [Q, L], idx int32 [Q, L]); slots past the range
    size carry val = -1 (real terms score >= 1)."""
    T = scores.shape[0]
    idx = torch.arange(T, dtype=torch.int32, device=scores.device)[None, :]
    mask = (idx >= lo[:, None]) & (idx < hi[:, None])
    masked = torch.where(mask, scores[None, :], torch.full_like(scores, -1))
    vals, pos = _topk_by_key(masked, L)
    return vals, pos.to(torch.int32)


def prefix_window_topk(scores: torch.Tensor, lo: torch.Tensor,
                       hi: torch.Tensor, *, L: int, W: int):
    """Top-L within [lo, hi) through a gathered W-wide window per query
    (hi - lo <= W): Q * W work instead of Q * T."""
    T = scores.shape[0]
    offs = torch.arange(W, dtype=torch.int32, device=scores.device)[None, :]
    idx = lo[:, None] + offs  # [Q, W]
    valid = idx < hi[:, None]
    vals = torch.where(valid, scores[idx.clamp(0, T - 1).long()],
                       torch.full_like(idx, -1))
    v, pos = _topk_by_key(vals, min(L, W))
    out_idx = lo[:, None] + pos.to(torch.int32)
    if L > W:  # degenerate; pad (callers keep L <= 10)
        v = torch.nn.functional.pad(v, (0, L - W), value=-1)
        out_idx = torch.nn.functional.pad(out_idx, (0, L - W))
    return v, out_idx
