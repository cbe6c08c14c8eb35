"""Torch counterparts of the two nextsearch_tpu/ops/bm25.py helpers the
sparse path uses: chunk expansion and the canonical (score desc, doc asc)
candidate order."""

from __future__ import annotations

import torch

PAD_DOC = 2**30  # dead candidate slot (sorts after every real doc)


def f32_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key in [0, 2^32) whose integer order is x's float order
    (-inf < ... < -0.0 < +0.0 < ... < +inf); NaN is never passed here."""
    b = x.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b) + (1 << 31)


def expand_chunks(starts, dfs, weights, *, C: int, block: int):
    """Expand (query, term-slot) posting ranges into C fixed-size chunks.

    Port of nextsearch_tpu/ops/bm25.py expand_chunks: returns (chunk_start,
    chunk_len, chunk_q, chunk_w); chunks past the live total have length 0
    and owner row Q. Index arithmetic runs in int64.
    """
    q, t = starts.shape
    s_flat = starts.reshape(-1).to(torch.int64)
    df_flat = dfs.reshape(-1).to(torch.int64)
    w_flat = weights.reshape(-1)
    n = q * t
    reps = (df_flat + (block - 1)) // block
    cum = torch.cumsum(reps, 0)
    total = cum[-1]
    cidx = torch.arange(C, dtype=torch.int64, device=starts.device)
    owner = torch.searchsorted(cum, cidx, right=True)
    ownerc = owner.clamp(0, n - 1)
    within = cidx - (cum[ownerc] - reps[ownerc])
    live = cidx < total
    chunk_start = s_flat[ownerc] + within * block
    chunk_len = torch.where(
        live,
        torch.minimum(torch.full_like(within, block), df_flat[ownerc] - within * block),
        torch.zeros_like(within),
    )
    chunk_q = torch.where(live, ownerc // t, torch.full_like(ownerc, q))
    chunk_w = w_flat[ownerc]
    return chunk_start, chunk_len, chunk_q, chunk_w


def canonical_sort(scores: torch.Tensor, docs: torch.Tensor):
    """Order each row by (score desc, doc slot asc); dead slots last.

    Port of nextsearch_tpu/ops/bm25.py canonical_sort (a 2-key lax.sort):
    one int64 key per element, the float order of -score above the doc.
    Returns (vals, docs)."""
    live = scores > 0
    neg = torch.where(live, -scores, torch.full_like(scores, float("inf")))
    docs = docs.to(torch.int64)
    sdoc = torch.where(live, docs, torch.full_like(docs, PAD_DOC))
    key = (f32_order_key(neg) << 31) | sdoc
    key_s, order = torch.sort(key, dim=-1, stable=True)
    return torch.gather(scores, -1, order), (key_s & ((1 << 31) - 1)).to(torch.int32)
