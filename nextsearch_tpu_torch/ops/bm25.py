"""Batched BM25 scoring and fused top-k in PyTorch: the port of
nextsearch_tpu/ops/bm25.py.

BM25 per-posting contributions are precomputed at build time, so query-time
work is: gather posting windows, accumulate weighted contributions into
per-doc scores, take the top k. Three modes share the pieces here:

  exact  (bm25_topk_exact) term slots accumulate one after another, and
         within a slot a doc appears at most once, so the f32 accumulation
         order equals the C++ engine's term-at-a-time order: bit-exact
         scores, and the same bits on every run.
  fast   (bm25_topk_fast) all (slot, window) chunks go through one
         scatter-add. The adds land in any order (atomics on a card), so a
         score can differ in the last ULP when several terms hit one doc.
  fused  (bm25_topk_fused, bm25_search_packed; the library default) pass 1
         is the fast scatter over the light terms plus one dense product
         for the heavy terms' precomputed rows (heavy_scores: a row gather
         through the K3 kernel, then torch.matmul), added into the scores
         by score_epilogue (ops/score_kernels.py: one CUDA pass that also
         counts found and takes tiled_topk's tile maxima, as XLA fuses
         the reference's passes); pass 2 rescores the top K2 candidates
         exactly, in term-slot order, so reported scores are bit-exact,
         and re-ranks them by (score desc, doc slot asc).

Every function returns (or packs) vals f32 [Q, K], idx int32 [Q, K] global
doc slots and found int32 [Q], the count of docs with score > 0 (counted by
score_epilogue in every mode). Padded or absent slots carry df = 0 and
weight = 0. Ties break by lowest doc slot.

Where the JAX functions send invalid lanes to an out-of-range index and
rely on mode="drop", these add them (as zeros) into sacrificial elements
past the score array (one per lane of a posting window, so that the dead
lanes' atomic adds do not all queue on one address), which are sliced off:
a CUDA scatter asserts on an out-of-range index. Where they rely on
lax.top_k preferring the lower index among equal values, these take the top
k of unique int64 keys (value bits above the inverted index), since
torch.topk promises no order among ties.
Index arithmetic runs in int64. Products and sums stay separate ops (no FMA
contraction), and the rescore accumulates in a loop over term slots.
"""

from __future__ import annotations

import torch

from .heavy_kernels import gather_bf16_rows, gather_rows
from .score_kernels import score_epilogue

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


def topk_low_index(scores: torch.Tensor, k: int):
    """(values, int64 indices) of each row's k largest entries, descending,
    equal values ordered by ascending index: lax.top_k's order. scores f32
    or bf16 [Q, N], N < 2^31, no NaN."""
    n = scores.shape[1]
    inv = (n - 1) - torch.arange(n, dtype=torch.int64, device=scores.device)
    key = (f32_order_key(scores.float()) << 31) | inv
    top, _ = torch.topk(key, k, dim=1)
    idx = (n - 1) - (top & ((1 << 31) - 1))
    return torch.gather(scores, 1, idx), idx


def _window_cells(post_doc, post_score, start, length, w, offs):
    """One [R, B] window of posting lanes: (valid, doc int64, contrib) for
    rows with posting offset `start`, live length `length` and weight `w`
    (each [R, 1]) at lane offsets `offs` [1 or R, B]."""
    p = post_doc.shape[0]
    valid = offs < length
    idx = (start + offs).clamp(0, max(p - 1, 0))
    contrib = torch.where(valid, w * post_score[idx],
                          torch.zeros((), dtype=torch.float32,
                                      device=post_doc.device))
    return valid, post_doc[idx].to(torch.int64), contrib


def _score_buffer(q: int, n_slots: int, block: int, dtype, device):
    """Flat zeroed [Q * n_slots + block] scores: the [Q, n_slots] array and
    one sacrificial element per window lane behind it."""
    return torch.zeros(q * n_slots + block, dtype=dtype, device=device)


def _add_cells(buf, qrow, doc, contrib, live, offs, n_slots: int):
    """buf += contrib at cell (qrow, doc) where live; every other lane adds
    (a zero) into the sacrificial element of its lane offset."""
    dead = buf.shape[0] - offs.shape[1] + offs % offs.shape[1]
    flat = torch.where(live, qrow * n_slots + doc, dead)
    buf.index_add_(0, flat.reshape(-1), contrib.to(buf.dtype).reshape(-1))


def scatter_scores(post_doc, post_score, chunk_start, chunk_len, chunk_q,
                   chunk_w, *, Q: int, n_slots: int, block: int,
                   dtype=torch.float32):
    """Pass 1: one scatter-add of all posting chunks into dense [Q, n_slots]
    scores (port of nextsearch_tpu/ops/bm25.py scatter_scores).

    chunk_* are expand_chunks' (or the host chunk plan's) arrays; a chunk
    whose owner row is Q is dropped. dtype bfloat16 halves the score array;
    `found` stays exact, since no positive f32 contribution rounds to a
    bf16 zero. The result is a view of a buffer `block` elements longer."""
    dev = post_doc.device
    offs = torch.arange(block, dtype=torch.int64, device=dev)[None, :]
    cq = chunk_q.to(torch.int64)[:, None]
    valid, doc, contrib = _window_cells(
        post_doc, post_score, chunk_start.to(torch.int64)[:, None],
        chunk_len.to(torch.int64)[:, None], chunk_w[:, None], offs)
    buf = _score_buffer(Q, n_slots, block, dtype, dev)
    _add_cells(buf, cq, doc, contrib, valid & (cq < Q) & (cq >= 0), offs,
               n_slots)
    return buf[: Q * n_slots].view(Q, n_slots)


def bm25_topk_fast(post_doc, post_score, chunk_start, chunk_len, chunk_q,
                   chunk_w, *, n_slots: int, K: int, Q: int,
                   block: int = 4096):
    """One scatter over host-planned chunks, no rescore (port of
    bm25_topk_fast). Returns (vals, idx int32, found)."""
    scores = scatter_scores(post_doc, post_score, chunk_start, chunk_len,
                            chunk_q, chunk_w, Q=Q, n_slots=n_slots,
                            block=block)
    found, _ = score_epilogue(scores, tiles=False)
    vals, idx = topk_low_index(scores, K)
    return vals, idx.to(torch.int32), found


def score_only_exact(post_doc, post_score, starts, dfs, weights, *,
                     n_slots: int, block: int = 4096, max_df=None):
    """Exact-mode dense scores [Q, n_slots] (port of score_only_exact): term
    slots one after another, each in windows of `block` postings. Within a
    window a (query, doc) cell receives at most one contribution, and every
    dead lane adds a zero into a sacrificial element, so the result does not
    depend on the order of the adds. max_df: each slot's largest df as T
    host ints, which a caller that planned on the host has; None reads them
    from `dfs`, which on a card waits for the stream."""
    q, t = starts.shape
    dev = post_doc.device
    offs = torch.arange(block, dtype=torch.int64, device=dev)[None, :]
    q_rows = torch.arange(q, dtype=torch.int64, device=dev)[:, None]
    buf = _score_buffer(q, n_slots, block, torch.float32, dev)
    if max_df is None:
        max_df = dfs.amax(dim=0).tolist()
    for ti in range(t):
        start = starts[:, ti:ti + 1].to(torch.int64)
        df = dfs[:, ti:ti + 1].to(torch.int64)
        w = weights[:, ti:ti + 1]
        for wi in range((int(max_df[ti]) + block - 1) // block):
            valid, doc, contrib = _window_cells(
                post_doc, post_score, start, df, w, offs + wi * block)
            _add_cells(buf, q_rows, doc, contrib, valid, offs, n_slots)
    return buf[: q * n_slots].view(q, n_slots)


def bm25_topk_exact(post_doc, post_score, starts, dfs, weights, *,
                    n_slots: int, K: int, block: int = 4096, max_df=None):
    """The parity mode: sequential per-term-slot scatters, then top-k (port
    of bm25_topk_exact; max_df as score_only_exact's). Returns (vals, idx
    int32, found)."""
    scores = score_only_exact(post_doc, post_score, starts, dfs, weights,
                              n_slots=n_slots, block=block, max_df=max_df)
    found, _ = score_epilogue(scores, tiles=False)
    vals, idx = topk_low_index(scores, K)
    return vals, idx.to(torch.int32), found


def exact_rescore(post_doc, post_score, starts, dfs, weights, cand, *,
                  bs_steps: int = 24):
    """Pass 2: bit-exact term-slot-order rescore of candidate doc slots
    (port of exact_rescore). A lower_bound over each (query, term slot)'s
    doc-sorted posting range finds the candidate's posting; contributions
    accumulate in slot order, the C++ engine's f32 sum. cand int [Q, k2]
    -> f32 [Q, k2]."""
    q, t = starts.shape
    k2 = cand.shape[1]
    p = post_doc.shape[0]
    dev = post_doc.device
    s = starts[:, :, None].to(torch.int64)
    d = dfs[:, :, None].to(torch.int64)
    w = weights[:, :, None]
    c = cand[:, None, :].to(torch.int64)
    lo = torch.zeros((q, t, k2), dtype=torch.int64, device=dev)
    hi = d.expand(q, t, k2)
    for _ in range(bs_steps):
        mid = (lo + hi) // 2
        go_right = post_doc[(s + mid).clamp(0, max(p - 1, 0))] < c
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    pos = (s + lo).clamp(0, max(p - 1, 0))
    hit = (lo < d) & (post_doc[pos] == c) & (w != 0.0)
    term = torch.where(hit, w * post_score[pos],
                       torch.zeros((), dtype=torch.float32, device=dev))
    acc = torch.zeros((q, k2), dtype=torch.float32, device=dev)
    for ti in range(t):
        acc = acc + term[:, ti, :]
    return acc


def heavy_scores(dense_rows, unique_rows, mix, dtype=torch.float32):
    """Dense-row contribution: gather the batch's unique heavy rows, then one
    product (port of heavy_scores).

    dense_rows f32 or bf16 [H + 1, n_slots] (row H and the padding rows are
    zero), unique_rows int [U], mix f32 [Q, U]: summed query weights per
    unique row. Returns [Q, n_slots] in `dtype`. The gather is the K3
    kernel (heavy_kernels.gather_rows; gather_bf16_rows over bf16 rows),
    its plain version for CPU tensors. The product is torch.matmul with
    mix cast to the rows' type and f32 accumulation; bf16 operands are
    widened first, which keeps their products exact. On a card it needs
    true f32 products: TF32 is off by PyTorch's default, TorchIndex turns
    it off when it is built, and this raises if something turned it on."""
    if dense_rows.dtype == torch.bfloat16:
        d_sub = gather_bf16_rows(unique_rows, dense_rows).float()
        mix = mix.to(torch.bfloat16).float()
    else:
        d_sub = gather_rows(unique_rows, dense_rows)
    if d_sub.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("heavy_scores: torch.backends.cuda.matmul."
                           "allow_tf32 is on; the product must be f32")
    return torch.matmul(mix, d_sub).to(dtype)


def tiled_topk(scores, k2: int, tile: int = 2048, tile_max=None):
    """Exact top-k2 over a wide doc axis via tile-max prefiltering (port of
    tiled_topk): a doc in the true top k2 lies in one of the k2 tiles with
    the largest maxima, so top-k inside those tiles, taken in slot order, is
    exact while scanning k2 * tile instead of n_slots entries. tile_max:
    the [Q, n_slots // tile] maxima where the caller has them
    (score_epilogue's), else taken here. Returns (vals, doc slots int32)."""
    q, ns = scores.shape
    if ns % tile != 0 or ns <= k2 * tile:
        vals, idx = topk_low_index(scores, k2)
        return vals, idx.to(torch.int32)
    n_tiles = ns // tile
    tiles = scores.view(q, n_tiles, tile)
    if tile_max is None:
        tile_max = tiles.amax(dim=2)
    _tv, tidx = topk_low_index(tile_max, k2)
    # slot-ascending tile order keeps the doc-ascending tie-break of the
    # flat top-k below
    tidx, _ = torch.sort(tidx, dim=1)
    cand = torch.gather(tiles, 1, tidx[:, :, None].expand(q, k2, tile))
    vals, pos = topk_low_index(cand.reshape(q, k2 * tile), k2)
    base = torch.gather(tidx, 1, pos // tile) * tile
    return vals, (base + pos % tile).to(torch.int32)


def _fused_tail(post_doc, post_score, scores, tile_max, starts, dfs,
                weights, *, n_slots: int, K: int, K2: int, bs_steps: int):
    """The exact rescore and canonical order of the top K2 candidates of
    pass-1 scores (tile_max: their tile maxima, or None). Returns (vals
    [Q, K], docs int32)."""
    _fv, cand = tiled_topk(scores, min(K2, n_slots), tile_max=tile_max)
    exact = exact_rescore(post_doc, post_score, starts, dfs, weights, cand,
                          bs_steps=bs_steps)
    sval, sdoc = canonical_sort(exact, cand)
    return sval[:, :K], sdoc[:, :K]


def _fused_scores(post_doc, post_score, dense_rows, starts, light_dfs,
                  weights, unique_heavy, heavy_mix, *, n_slots: int, C: int,
                  block: int, dtype):
    """Pass 1 of the fused mode: the light terms' scatter, then the heavy
    rows' f32 product added into it in place by score_epilogue, which
    rounds it to `dtype` as heavy_scores(..., dtype) would, counts found
    and takes the tile maxima in the same pass. Returns (scores, found,
    tile_max)."""
    chunks = expand_chunks(starts, light_dfs, weights, C=C, block=block)
    scores = scatter_scores(post_doc, post_score, *chunks, Q=starts.shape[0],
                            n_slots=n_slots, block=block, dtype=dtype)
    found, tile_max = score_epilogue(
        scores, heavy_scores(dense_rows, unique_heavy, heavy_mix))
    return scores, found, tile_max


def bm25_topk_fused(post_doc, post_score, dense_rows, starts, dfs, weights,
                    light_dfs, unique_heavy, heavy_mix, *, n_slots: int,
                    K: int, K2: int, C: int, block: int = 2048,
                    bs_steps: int = 24):
    """Fused scatter plus exact candidate rescore (port of bm25_topk_fused).

    starts/dfs/weights [Q, T] hold all term slots (the rescore's), light_dfs
    the dfs with heavy slots zeroed (the scatter's), unique_heavy int [U]
    the batch's dense-row ids and heavy_mix f32 [Q, U] the summed weights
    per row. Pass 1 may add in any order; pass 2 rescores the top K2
    exactly and orders them (score desc, doc slot asc). `found` is exact in
    any order: every contribution is positive. Returns (vals f32 [Q, K],
    idx int32 [Q, K], found int32 [Q])."""
    scores, found, tile_max = _fused_scores(
        post_doc, post_score, dense_rows, starts, light_dfs, weights,
        unique_heavy, heavy_mix, n_slots=n_slots, C=C, block=block,
        dtype=torch.float32)
    vals, docs = _fused_tail(post_doc, post_score, scores, tile_max, starts,
                             dfs, weights, n_slots=n_slots, K=K, K2=K2,
                             bs_steps=bs_steps)
    return vals, docs, found


def bm25_search_packed(post_doc, post_score, dense_rows, plan_ints, plan_f32,
                       *, n_slots: int, K: int, K2: int, C: int,
                       block: int = 2048, bs_steps: int = 24,
                       scores_bf16: bool = False):
    """bm25_topk_fused with the plan in two arrays and the result in one
    (port of bm25_search_packed).

    plan_ints int32 [3, Q, T]: starts / dfs / light_dfs. plan_f32 f32
    [Q + 1, T + U]: rows [weights | heavy_mix]; the last row's U columns
    hold the unique heavy row ids as exact f32 values (ids < 2^24). Returns
    f32 [Q, 2K + 1]: columns [vals (K) | doc slots (K) | found], the ints as
    exact f32 values. scores_bf16 keeps the pass-1 score array in bf16
    (reported scores stay bit-exact through the f32 rescore)."""
    starts, dfs, light_dfs = plan_ints[0], plan_ints[1], plan_ints[2]
    q, t = starts.shape
    weights = plan_f32[:q, :t].contiguous()
    heavy_mix = plan_f32[:q, t:].contiguous()
    unique_heavy = plan_f32[q, t:].to(torch.int32)
    scores, found, tile_max = _fused_scores(
        post_doc, post_score, dense_rows, starts, light_dfs, weights,
        unique_heavy, heavy_mix, n_slots=n_slots, C=C, block=block,
        dtype=torch.bfloat16 if scores_bf16 else torch.float32)
    vals, docs = _fused_tail(
        post_doc, post_score, scores, tile_max, starts, dfs, weights,
        n_slots=n_slots, K=K, K2=K2, bs_steps=bs_steps)
    return torch.cat([vals, docs.to(torch.float32),
                      found[:, None].to(torch.float32)], dim=1)
