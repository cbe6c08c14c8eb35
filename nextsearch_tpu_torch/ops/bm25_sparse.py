"""Sparse-light BM25 execution in PyTorch: the port of
nextsearch_tpu/ops/bm25_sparse.py's packed pipeline (``_packed_impl``).

One batch is one call of ``packed_impl`` on the int32 ``[7, Q, T]`` plan that
``DeviceIndex.plan_sparse`` builds. The heavy terms go through the CUDA
kernels of ops/heavy_kernels.py (K2/K3 row gather, K1 fused matmul with its
selection epilogue); everything else is torch ops on the same device, in the
reference's order:

  light totals  posting windows expanded, stably sorted by (q, doc), summed
                per group in term-slot order (bounded left fold)
  found         heavy tile counts + light-only docs (exact at any precision)
  candidates    top-K2 light docs by (light total + H) and top-K2 heavy docs
                from the sub-block maxima; the guarded fast mode merges them
                into one K2-wide pool and emits a per-query proof column
  rescore       bit-exact f32 re-accumulation in term-slot order
                (exact_rescore_v5, or v4 when H2 is unset; v2, a binary
                search over the heavy and light bucket tables, when the
                dense rows are bf16), then canonical order and dedup

With NEXTSEARCH_SELECT_PALLAS's window bound (w_max > 0) the light
candidates come from the windowed selection kernel K4
(ops/select_kernels.py) instead of a re-sort of the light stream.
``unified_impl`` is the port of bm25_search_sparse_unified: the light
entries are folded into the heavy product by K5 and one candidate pool is
read off the summed totals.

Ties are broken as the reference's XLA ops break them: every lax.sort
becomes a stable torch.sort on one int64 composite key (or two stable
passes), and lax.top_k (lowest index first among ties) becomes a stable
descending sort and a slice. Multiplies and adds that the reference keeps
separately rounded stay separate torch ops (eager torch does not contract
them into FMAs).

``prof_skip`` drops named stages for stage attribution
(nextsearch_tpu_torch/benchmarks/profile_serving.py); its results are
wrong by design. NEXTSEARCH_SORT2_2LEVEL=1 takes the reference's 2-level
reduction of the guarded fast path's selection sort
(``topk_quantized_reduce``), off by default as there. The launch functions
take it as ``two_level``; None reads the variable at the call, and the
index's launches pass it read, so that it keys their graphs
(ops/graphs.py).
"""

from __future__ import annotations

import os

import torch

from .bm25 import PAD_DOC, canonical_sort, expand_chunks, f32_order_key
from .cuda_build import counted
from .heavy_kernels import (
    CSUB, TILE, gather_bf16_rows, gather_rows, gather_rows_bf16, heavy_fused3,
    unified_fused,
)
from .select_kernels import per_query_topk

BUCKET_LOG2 = 3  # nextsearch_tpu/ops/bm25_sparse.py BUCKET_LOG2 (heavy table)
LIGHT_BUCKET_LOG2 = 9  # nextsearch_tpu/ops/bm25_sparse.py LIGHT_BUCKET_LOG2
# Largest window bound for which the reference selects light candidates
# with K4 (bm25_sparse.py:1211); above it the flat sort runs, as there.
SELECT_W_MAX = 32768


def _round_up_16(n: int) -> int:
    return ((n + 15) // 16) * 16


def _shift1(x: torch.Tensor, fill) -> torch.Tensor:
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device), x[:-1]])


def _stable_topk(x: torch.Tensor, k: int):
    """lax.top_k along the last axis: the k largest, lowest index first
    among equal values (a stable descending sort keeps index order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def segmented_cumsum_bounded(vals, first, tmax: int):
    """Inclusive segmented cumsum for segments of <= tmax lanes, in exact
    left-fold (lane) order: out[i] = s_o[i], o = lane offset in segment.
    Lanes deeper than tmax into a segment get the tmax-lane fold (callers
    mask them out). Port of _segmented_cumsum_bounded."""
    out = vals
    s = vals
    m = ~first
    for _ in range(max(tmax - 1, 0)):
        s = _shift1(s, 0.0) + vals
        out = torch.where(m, s, out)
        m = m & _shift1(m, False)
    return out


def light_entries(post_doc, post_score, starts, light_dfs, weights, *,
                  C: int, block: int, n_slots: int):
    """The light postings of a plan as flat [C * block] lanes (doc, chunk
    query row, contribution w * score); dead lanes carry doc = n_slots and
    contribution 0, and their query row is the chunk's (Q past the live
    chunks)."""
    cs, cl, cq, cw = expand_chunks(starts, light_dfs, weights, C=C, block=block)
    P = post_doc.shape[0]
    offs = torch.arange(block, dtype=torch.int64, device=starts.device)[None, :]
    valid = offs < cl[:, None]
    idx = (cs[:, None] + offs).clamp(0, max(P - 1, 0))
    doc = torch.where(valid, post_doc[idx].to(torch.int64),
                      torch.full_like(idx, n_slots))
    contrib = torch.where(valid, cw[:, None] * post_score[idx],
                          torch.zeros((), dtype=torch.float32, device=idx.device))
    return doc.reshape(-1), cq[:, None].expand(-1, block).reshape(-1), \
        valid.reshape(-1), contrib.reshape(-1)


def light_totals(post_doc, post_score, starts, light_dfs, weights, *, C: int,
                 block: int, Q: int, n_slots: int, skip_sort: bool = False,
                 skip_segsum: bool = False):
    """Flat per-(query, doc) light-term totals via sort + segmented sum.

    Returns (sq, sd, stot, last) sorted by (q, doc); stot at `last` lanes is
    the f32 sum of that (q, doc)'s light contributions in term-slot order
    (the stable sort keeps expansion order inside a group). Invalid lanes
    carry q = Q, doc = n_slots and sort to the end. skip_sort and
    skip_segsum (stage attribution only; results are wrong) drop the sort
    or the segmented sum, as the reference's prof_skip "lsort"/"segsum"."""
    doc, cq, valid, contrib = light_entries(
        post_doc, post_score, starts, light_dfs, weights,
        C=C, block=block, n_slots=n_slots,
    )
    qrow = torch.where(valid, cq, torch.full_like(cq, Q))
    if skip_sort:
        sq, sd, sc = qrow, doc, contrib
    else:
        shift = max(int(n_slots).bit_length(), 1)
        skey, order = torch.sort((qrow << shift) | doc, stable=True)
        sc = contrib[order]
        sq = skey >> shift
        sd = skey & ((1 << shift) - 1)
    change = (sq[1:] != sq[:-1]) | (sd[1:] != sd[:-1])
    one = torch.ones((1,), dtype=torch.bool, device=sq.device)
    first = torch.cat([one, change])
    last = torch.cat([change, one])
    stot = sc if skip_segsum else segmented_cumsum_bounded(
        sc, first, starts.shape[1])
    return sq, sd, stot, last


def per_query_counts(sq, indicator, Q: int):
    """Sum `indicator` per query over a q-sorted flat array (no scatter)."""
    cs = torch.cumsum(indicator.to(torch.int64), 0)
    bounds = torch.searchsorted(
        sq, torch.arange(Q + 1, dtype=sq.dtype, device=sq.device)
    )
    csz = torch.cat([torch.zeros((1,), dtype=torch.int64, device=sq.device), cs])
    return csz[bounds[1:]] - csz[bounds[:-1]]


def _per_query_window(q2, n: int, Q: int, k2: int):
    """Flat positions of each query's first k2 lanes in a q-sorted stream,
    and whether each position still lies inside that query's run."""
    ar = torch.arange(Q + 1, dtype=q2.dtype, device=q2.device)
    bounds = torch.searchsorted(q2, ar)
    idx = bounds[:Q, None] + torch.arange(k2, dtype=torch.int64,
                                          device=q2.device)[None, :]
    in_q = idx < bounds[1:, None]
    return idx.clamp(0, max(n - 1, 0)), in_q


def topk_quantized_reduce(comp, sq, Q: int, k2: int, sent):
    """The exact 2-level reduction of the quantized selection sort (port of
    _topk_quantized_reduce): the composite keys of a (q, doc)-sorted flat
    stream (n a multiple of 128; every in-run lane keeps its query id, so
    each 128-lane row's query groups keep their (q, doc) lane counts) cut
    to fewer lanes that hold every query's top-k2 unchanged:

      1. sort each 128-lane row on its own and keep its first k2 lanes:
         they cover every query that is its row's first group;
      2. for the one row per query whose run starts mid-row, gather the
         k2-wide window of the sorted stream from the run's start, masked
         to lanes past the row's first k2 (no duplicate lane), inside the
         run and inside the row (the run's next row is covered by 1);
         masked lanes carry the sentinel `sent`.

    The caller's flat sort over the result gives each query the pool of
    the one-level sort, lane for lane."""
    n = comp.shape[0]
    rows = torch.sort(comp.view(n // 128, 128), dim=1).values
    red = rows[:, :k2].reshape(-1)
    bounds = torch.searchsorted(
        sq, torch.arange(Q + 1, dtype=sq.dtype, device=sq.device))
    start = bounds[:Q, None]
    j = torch.arange(k2, dtype=torch.int64, device=sq.device)[None, :]
    pos = start + j
    g = start & 127
    row_end = (start | 127) + 1
    ok = (g + j >= k2) & (pos < row_end) & (pos < bounds[1:, None])
    ex = torch.where(ok, rows.view(-1)[pos.clamp(0, n - 1)],
                     torch.full_like(pos, sent))
    return torch.cat([red, ex.reshape(-1)])


# launches that took the 2-level branch
counted(topk_quantized_reduce, attr="calls")


def two_level_sort2() -> bool:
    """The NEXTSEARCH_SORT2_2LEVEL switch, as a launch's two_level."""
    return os.environ.get("NEXTSEARCH_SORT2_2LEVEL", "0") == "1"


def per_query_topk_flat(sq, score, payload, Q: int, k2: int, *,
                        quantized: bool = False, two_level=None):
    """Top-k2 payloads per query by (score desc, payload asc) from a flat
    q-sorted list; returns (docs, vals) with vals 0 / docs PAD_DOC at dead
    slots. Port of per_query_topk_flat.

    quantized=False keeps full f32 keys (the exact path). quantized=True
    (guarded fast path only) keeps the reference's packed uint32 key, q in
    the high bits over the top (32 - qbits) bits of the score pattern, and
    returns each key's dequantized floor, which feeds the guard's tau.
    two_level (None: two_level_sort2()) lets a long quantized stream take
    the 2-level reduction first (topk_quantized_reduce)."""
    n = sq.shape[0]
    sq = sq.to(torch.int64)
    live_sc = score > 0
    pay = torch.where(live_sc, payload.to(torch.int64),
                      torch.full_like(sq, PAD_DOC))
    if quantized:
        qbits = (Q + 1).bit_length()
        shift = 32 - qbits
        max_sc = (1 << shift) - 1
        bits = score.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        sc_hi = torch.where(live_sc, bits >> qbits, torch.zeros_like(bits))
        qv = torch.where(sq < Q, sq, torch.full_like(sq, Q))
        key = (qv << shift) | (max_sc - sc_hi)
        comp = (key << 31) | pay  # the reference's (key, pay) sort order
        if (
            n >= 32768
            and n % 128 == 0
            and k2 <= 128
            and (two_level_sort2() if two_level is None else two_level)
        ):
            sent = (((Q << shift) | max_sc) << 31) | PAD_DOC
            comp = topk_quantized_reduce(comp, sq, Q, k2, sent)
            topk_quantized_reduce.calls += 1
        key2 = torch.sort(comp).values  # values only: ties are equal
        kq = key2 >> 31
        pay2 = key2 & ((1 << 31) - 1)
        q2 = kq >> shift
        sc2 = max_sc - (kq & max_sc)
        idx, in_q = _per_query_window(q2, key2.shape[0], Q, k2)
        sc_at = sc2[idx]
        live = in_q & (sc_at > 0)
        docs = torch.where(live, pay2[idx], torch.full_like(idx, PAD_DOC))
        deq = (sc_at << qbits).to(torch.int32).view(torch.float32)
        vals = torch.where(live, deq, torch.zeros_like(deq))
        return docs, vals
    neg = torch.where(live_sc, -score, torch.full_like(score, float("inf")))
    # lexicographic (sq, neg, pay): stable pass on pay, then on (sq, neg)
    o1 = torch.sort(pay, stable=True).indices
    k1 = (sq[o1] << 32) | f32_order_key(neg[o1])
    o2 = torch.sort(k1, stable=True).indices
    order = o1[o2]
    q2 = sq[order]
    neg2 = neg[order]
    pay2 = pay[order]
    invalid = ~(neg2 < float("inf"))
    idx, in_q = _per_query_window(q2, n, Q, k2)
    live = in_q & ~invalid[idx]
    docs = torch.where(live, pay2[idx], torch.full_like(idx, PAD_DOC))
    vals = torch.where(live, -neg2[idx], torch.zeros_like(neg2[idx]))
    return docs, vals


def heavy_candidates(H, smax_sq, k2: int, Q: int, n_slots: int):
    """Top-k2 doc slots per query from the per-sub-block maxima: a top
    doc's own sub-block max >= its score, so its sub-block is among the
    top-k2 sub-blocks. H f32 or bf16 [Q, n_slots] (bf16 values widen to f32
    exactly, as the reference's bit unpacking does). Returns (vals f32,
    docs)."""
    n_sub = n_slots // CSUB
    smax = smax_sq.T[:, :n_sub]
    kt = min(k2, n_sub)
    _tv, tidx = _stable_topk(smax, kt)
    tidx = torch.sort(tidx, dim=1).values  # doc-ascending tie order
    tiles = H.view(Q, n_sub, CSUB)
    cand = torch.gather(tiles, 1, tidx[:, :, None].expand(-1, -1, CSUB))
    flat = cand.reshape(Q, kt * CSUB).float()
    vals, pos = _stable_topk(flat, min(k2, kt * CSUB))
    base = torch.gather(tidx, 1, pos // CSUB) * CSUB
    docs = torch.where(vals > 0, base + pos % CSUB, torch.full_like(pos, PAD_DOC))
    return vals, docs


def _compact_pairs(flat_live, cap: int):
    """Row-major compaction index of live (query, slot) pairs into a
    [cap + 1] block: live pair j -> min(j, cap), dead -> cap (sentinel)."""
    idx = torch.cumsum(flat_live.to(torch.int64), 0) - 1
    return torch.where(flat_live, idx.clamp(max=cap), torch.full_like(idx, cap))


def _scatter_set(size: int, fill: int, idx, vals):
    """torch.full(size, fill) with out[idx] = vals. Every idx is in range
    (compacted ids or the sentinel); duplicates land only on the sentinel,
    whose value the caller overwrites or discards, so their order is
    immaterial."""
    out = torch.full((size,), fill, dtype=vals.dtype, device=vals.device)
    out[idx] = vals
    return out


def _light_values(post_doc, post_score, light_bucket_pos, starts,
                  slot_light, weights, cand, *, bs_steps: int, nl: int,
                  L2: int, lb_log2: int):
    """[Q, T, kc] exact eager scores of the candidates for the light
    (query, slot) pairs, 0 elsewhere: the live light pairs are compacted to
    [L2 + 1] (row-major (q, t) order) and binary-search their posting range
    through the light bucket table (v4's and v5's light side)."""
    Q, T = starts.shape
    dev = cand.device
    P = post_doc.shape[0]
    qgrid = torch.arange(Q, dtype=torch.int64, device=dev)[:, None].expand(Q, T).reshape(-1)
    lflat = ((slot_light < nl) & (weights != 0.0)).reshape(-1)
    lidx = _compact_pairs(lflat, L2)
    lp_start = _scatter_set(L2 + 1, 0, lidx, starts.reshape(-1).to(torch.int64))
    lp_row = _scatter_set(L2 + 1, nl, lidx, slot_light.reshape(-1).to(torch.int64))
    lp_q = _scatter_set(L2 + 1, 0, lidx, qgrid)
    cl = cand[lp_q.clamp(0, Q - 1)]  # [L2+1, kc]
    s = lp_start[:, None]
    cbl = cl >> lb_log2
    lrow = lp_row[:, None].clamp(0, nl)
    lo = light_bucket_pos[lrow, cbl].to(torch.int64)
    hi0 = light_bucket_pos[lrow, cbl + 1].to(torch.int64)
    hi = hi0
    for _ in range(bs_steps):
        mid = (lo + hi) // 2
        v = post_doc[(s + mid).clamp(0, max(P - 1, 0))]
        go_right = v < cl
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    pos = (s + lo).clamp(0, max(P - 1, 0))
    lhit = (lo < hi0) & (post_doc[pos] == cl)
    v_light = torch.where(lhit, post_score[pos], torch.zeros((), dtype=torch.float32, device=dev))
    v_light[L2] = 0.0  # sentinel row: heavy/padding pairs
    return v_light[lidx].reshape(Q, T, -1)


def _accumulate(slot_dense, weights, dv, vl, nd: int):
    """Each term's contribution w * v rounded, then added to the running
    f32 sum in term-slot order, as the reference's C++ engine accumulates
    (separate multiply and add ops: eager torch contracts no FMA)."""
    Q, T = slot_dense.shape
    w = weights[:, :, None]
    v = torch.where((slot_dense < nd)[:, :, None], dv, vl)
    hit = (v > 0.0) & (w != 0.0)
    term = torch.where(hit, torch.abs(w * v), torch.zeros((), dtype=torch.float32, device=v.device))
    acc = torch.zeros((Q, v.shape[2]), dtype=torch.float32, device=v.device)
    for t in range(T):
        acc = acc + term[:, t]
    return acc


def exact_rescore_v4(post_doc, post_score, dense_rows, light_bucket_pos,
                     starts, slot_dense, slot_light, weights, cand, *,
                     bs_steps: int, nd: int, nl: int, L2: int,
                     lb_log2: int = LIGHT_BUCKET_LOG2):
    """Bit-exact term-slot-order rescore of candidates (port of
    exact_rescore_v4): heavy lanes read dense_rows[row, cand] over the
    whole [Q, T, kc] grid, non-heavy slots reading row nd (the zero row);
    light pairs as in v5."""
    row = torch.where(slot_dense < nd, slot_dense.to(torch.int64),
                      torch.full_like(slot_dense, nd, dtype=torch.int64))
    dv = dense_rows[row[:, :, None], cand[:, None, :]]
    vl = _light_values(post_doc, post_score, light_bucket_pos, starts,
                       slot_light, weights, cand, bs_steps=bs_steps, nl=nl,
                       L2=L2, lb_log2=lb_log2)
    return _accumulate(slot_dense, weights, dv, vl, nd)


def exact_rescore_v5(post_doc, post_score, dense_rows, light_bucket_pos,
                     starts, slot_dense, slot_light, weights, cand, *,
                     bs_steps: int, nd: int, nl: int, L2: int, H2: int,
                     lb_log2: int = LIGHT_BUCKET_LOG2):
    """Bit-exact term-slot-order rescore of candidates (port of
    exact_rescore_v5). Heavy pairs are compacted to [H2 + 1] and read their
    exact eager score off the f32 dense rows; light pairs binary-search
    their posting range through the light bucket table."""
    Q, T = starts.shape
    dev = cand.device
    qgrid = torch.arange(Q, dtype=torch.int64, device=dev)[:, None].expand(Q, T).reshape(-1)
    hflat = ((slot_dense < nd) & (weights != 0.0)).reshape(-1)
    hidx = _compact_pairs(hflat, H2)
    sd_flat = slot_dense.reshape(-1).to(torch.int64)
    hp_row = _scatter_set(H2 + 1, nd, hidx,
                          torch.where(hflat, sd_flat, torch.full_like(sd_flat, nd)))
    hp_q = _scatter_set(H2 + 1, 0, hidx, qgrid)
    chv = cand[hp_q.clamp(0, Q - 1)]  # [H2+1, kc]
    dvc = dense_rows[hp_row.clamp(0, nd)[:, None], chv]
    dvc[H2] = 0.0  # sentinel row: light/padding pairs
    dv = dvc[hidx].reshape(Q, T, -1)
    vl = _light_values(post_doc, post_score, light_bucket_pos, starts,
                       slot_light, weights, cand, bs_steps=bs_steps, nl=nl,
                       L2=L2, lb_log2=lb_log2)
    return _accumulate(slot_dense, weights, dv, vl, nd)


def exact_rescore_v2(post_doc, post_score, bucket_pos, light_bucket_pos,
                     starts, slot_dense, slot_light, weights, cand, *,
                     bs_steps: int, nd: int, nl: int,
                     lb_log2: int = LIGHT_BUCKET_LOG2):
    """Bit-exact term-slot-order rescore of candidates (port of
    exact_rescore_v2, the rescore of the bf16-dense-rows configuration):
    every (query, term slot), heavy and light alike, binary-searches the
    candidate in its doc-sorted posting range and reads the host f32 eager
    score off the postings. The search starts from the candidate's bucket:
    heavy slots through bucket_pos [ND+1, NBh+1] at 2^BUCKET_LOG2 doc
    slots, light slots through light_bucket_pos at 2^lb_log2; bs_steps
    covers the larger table's bucket occupancy."""
    Q, T = starts.shape
    P = post_doc.shape[0]
    c = cand[:, None, :].to(torch.int64)
    s = starts[:, :, None].to(torch.int64)
    is_heavy = slot_dense[:, :, None] < nd
    row = torch.where(is_heavy, slot_dense[:, :, None].to(torch.int64),
                      torch.full_like(s, nd))
    lrow = slot_light[:, :, None].to(torch.int64).clamp(0, nl)
    cb = c >> BUCKET_LOG2
    cbl = c >> lb_log2
    lo = torch.where(is_heavy, bucket_pos[row, cb],
                     light_bucket_pos[lrow, cbl]).to(torch.int64)
    hi0 = torch.where(is_heavy, bucket_pos[row, cb + 1],
                      light_bucket_pos[lrow, cbl + 1]).to(torch.int64)
    hi = hi0
    for _ in range(bs_steps):
        mid = (lo + hi) // 2
        v = post_doc[(s + mid).clamp(0, max(P - 1, 0))]
        go_right = v < c
        lo, hi = torch.where(go_right, mid + 1, lo), torch.where(go_right, hi, mid)
    pos = (s + lo).clamp(0, max(P - 1, 0))
    w = weights[:, :, None]
    hit = (lo < hi0) & (post_doc[pos] == c) & (w != 0.0)
    term = torch.where(hit, torch.abs(w * post_score[pos]),
                       torch.zeros((), dtype=torch.float32, device=c.device))
    acc = torch.zeros((Q, cand.shape[1]), dtype=torch.float32, device=c.device)
    for t in range(T):
        acc = acc + term[:, t]
    return acc


def _rescore(post_doc, post_score, dense_rows, bucket_pos, light_bucket_pos,
             plan, cand, *, n_slots: int, bs_steps: int, nd: int, nl: int,
             L2: int, H2: int, lb_log2: int, heavy_direct: bool):
    """Exact scores of the candidate slots (PAD_DOC -> 0), by the rescore
    the reference chooses: v5, or v4 when H2 is unset, off the f32 dense
    rows (heavy_direct); v2 over the bucket tables otherwise. Returns
    (exact, safe_cand)."""
    weights = plan[5].contiguous().view(torch.float32)
    safe_cand = cand.clamp(0, n_slots - 1)
    if heavy_direct:
        if L2 <= 0:
            raise ValueError("heavy_direct rescore requires L2 > 0")
        args = (post_doc, post_score, dense_rows, light_bucket_pos, plan[0],
                plan[2], plan[3], weights, safe_cand)
        if H2 > 0:
            exact = exact_rescore_v5(*args, bs_steps=bs_steps, nd=nd, nl=nl,
                                     L2=L2, H2=H2, lb_log2=lb_log2)
        else:
            exact = exact_rescore_v4(*args, bs_steps=bs_steps, nd=nd, nl=nl,
                                     L2=L2, lb_log2=lb_log2)
    else:
        if bucket_pos is None:
            raise ValueError("exact_rescore_v2 needs the heavy bucket table "
                             "(bucket_pos)")
        exact = exact_rescore_v2(
            post_doc, post_score, bucket_pos, light_bucket_pos, plan[0],
            plan[2], plan[3], weights, safe_cand, bs_steps=bs_steps, nd=nd,
            nl=nl, lb_log2=lb_log2,
        )
    exact = torch.where(cand < n_slots, exact,
                        torch.zeros((), dtype=torch.float32, device=cand.device))
    return exact, safe_cand


def dedup_sorted(vals, docs):
    """Kill duplicate docs in a (score desc, doc asc)-sorted candidate list."""
    dup = torch.cat(
        [torch.zeros((vals.shape[0], 1), dtype=torch.bool, device=vals.device),
         docs[:, 1:] == docs[:, :-1]], dim=1,
    ) & (docs < PAD_DOC)
    vals = torch.where(dup, torch.zeros_like(vals), vals)
    docs = torch.where(dup, torch.full_like(docs, PAD_DOC), docs)
    return canonical_sort(vals, docs)


def heavy_operands(plan, rows: int, *, nd: int, U: int, use_compact: bool):
    """The heavy matmul's operands for one plan: (mix f32 [Q, cols], ids).

    Compact (use_compact): ids are the batch's U distinct dense rows padded
    with the zero row nd to uc = round_up16(U + 1), and mix columns index
    them (column U is the zero column). Full table: ids is None and mix
    columns index the table's rows (column nd is zero). Weights are added
    in term-slot order (no scatter-add: its atomics reorder the sums)."""
    dev = plan.device
    Q, T = plan.shape[1:]
    weights = plan[5].contiguous().view(torch.float32)
    ids = None
    if use_compact:
        m = min(U, Q * T)
        uc = _round_up_16(U + 1)
        ids = torch.cat([
            plan[6].reshape(-1)[:m].to(torch.int64),
            torch.full((uc - m,), nd, dtype=torch.int64, device=dev),
        ]).clamp(0, rows - 1)
        sid, zero_col, mix_cols = plan[4], U, uc
    else:
        sid, zero_col, mix_cols = plan[2], nd, rows
    iota = torch.arange(mix_cols, dtype=sid.dtype, device=dev)[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    mix = torch.zeros((Q, mix_cols), dtype=torch.float32, device=dev)
    for t in range(T):
        mix = mix + torch.where(sid[:, t:t + 1] == iota, weights[:, t:t + 1], zero)
    mix[:, zero_col] = 0.0
    return mix, ids


def _guard_column(sval, tau, K: int, eps: float):
    """1.0 where the guarded fast launch proved its top K, else 0.0: every
    excluded doc's true score is <= (1 + eps) * tau, so a K-th rescored
    score above that bound cannot be displaced. Strict > keeps boundary ties
    (broken doc-ascending) on the relaunch path. The factor is rounded to
    f32 before the multiply, as JAX's weak-typed scalar is."""
    scale = torch.full((), 1.0 + eps, dtype=torch.float32, device=sval.device)
    ok = (sval[:, K - 1] > scale * tau) | (tau <= 0.0)
    return ok.to(torch.float32)[:, None]


def _windowed(w_max: int) -> bool:
    """Whether the light candidates come from the windowed selection
    kernel K4."""
    return 0 < w_max <= SELECT_W_MAX


# stage names prof_skip takes (the reference's, bm25_sparse.py:1017-1023,
# and the three inside the light chain)
PROF_STAGES = ("rowgather", "heavy_mm", "light", "hgather", "sort2",
               "cand_heavy", "rescore", "lsort", "segsum", "lcount")


def _compact_table(ids, dense_rows, *, fast: bool):
    """The compact heavy table: K2 (f32 rows to bf16) for the fast launch,
    K3 otherwise, over f32 or bf16 rows in their own type."""
    if dense_rows.dtype == torch.bfloat16:
        return gather_bf16_rows(ids, dense_rows)
    return gather_rows_bf16(ids, dense_rows) if fast else gather_rows(ids, dense_rows)


def packed_impl(post_doc, post_score, dense_rows, light_bucket_pos, plan, *,
                n_slots: int, K: int, K2: int, C: int, block: int,
                bs_steps: int, nd: int, nl: int, U: int,
                use_compact: bool = False, heavy_direct: bool = True,
                fast_heavy: bool = False, guard_eps: float = 2e-3,
                w_max: int = 0, h_bf16: bool = False,
                lb_log2: int = LIGHT_BUCKET_LOG2, L2: int = 0, H2: int = 0,
                prof_skip: tuple = (), bucket_pos=None, two_level=None):
    """One sparse batch; returns packed f32 [Q, 2K+1] (vals | doc slots |
    found), plus the guard column ([Q, 2K+2]) when fast_heavy.

    Port of nextsearch_tpu/ops/bm25_sparse.py _packed_impl with
    use_pallas=True's kernel choices: the compact launch gathers the
    batch's U distinct dense rows (K2 to bf16 under fast_heavy over f32
    rows, else K3 in the rows' own type) and runs K1 over them; the
    full-table launch runs K1 over the stored table. 0 < w_max <= 32768
    (the batch's window bound, set under NEXTSEARCH_SELECT_PALLAS=1)
    selects the light candidates with K4, whose values are exact; otherwise
    a flat sort does (quantized keys under fast_heavy). fast_heavy is the
    guarded one-pass mode: guard column 0 means the caller must relaunch
    exactly (TorchIndex does). h_bf16 under fast_heavy stores H as bf16
    rounded up, which every reader widens back to f32 exactly.
    two_level: per_query_topk_flat's, for the quantized selection sort.
    heavy_direct=False (bf16 dense rows) rescores with exact_rescore_v2
    over bucket_pos. prof_skip names stages of PROF_STAGES to drop (stage
    attribution only: the results are wrong); each dropped stage yields
    what the reference yields in its place.

    post_doc int32 [P], post_score f32 [P], dense_rows f32 or bf16
    [rows, n_slots], light_bucket_pos int32 [NL+1, NBl+1], plan int32
    [7, Q, T] (rows: starts, light dfs, slot_dense, slot_light,
    slot_compact, weight bits, unique dense row ids), bucket_pos int32
    [ND+1, NBh+1] or None."""
    unknown = set(prof_skip) - set(PROF_STAGES)
    if unknown:
        raise ValueError(f"prof_skip: unknown stages {sorted(unknown)}")
    dev = plan.device
    starts = plan[0]
    light_dfs = plan[1]
    weights = plan[5].contiguous().view(torch.float32)
    Q = starts.shape[0]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    h_dtype = torch.bfloat16 if (fast_heavy and h_bf16) else torch.float32

    mix, ids = heavy_operands(plan, dense_rows.shape[0], nd=nd, U=U,
                              use_compact=use_compact)
    if "heavy_mm" in prof_skip:
        tiles_pad = (n_slots // TILE + 7) // 8 * 8
        H = torch.zeros((Q, n_slots), dtype=h_dtype, device=dev)
        smax_sq = torch.zeros((tiles_pad * (TILE // CSUB), Q),
                              dtype=torch.float32, device=dev)
        heavy_found = torch.zeros((Q,), dtype=torch.int64, device=dev)
    else:
        if use_compact:
            if "rowgather" in prof_skip:
                table = torch.zeros((ids.numel(), n_slots),
                                    dtype=dense_rows.dtype, device=dev)
            else:
                table = _compact_table(ids, dense_rows, fast=fast_heavy)
        else:
            table = dense_rows
        H, smax_sq, cnt_tq = heavy_fused3(mix, table, fast=fast_heavy,
                                          h_dtype=h_dtype)
        heavy_found = cnt_tq.sum(dim=0).to(torch.int64)

    if "light" in prof_skip:
        found = heavy_found
        ldocs = torch.full((Q, K2), PAD_DOC, dtype=torch.int64, device=dev)
        lvals = torch.zeros((Q, K2), dtype=torch.float32, device=dev)
    else:
        sq, sd, stot, last = light_totals(
            post_doc, post_score, starts, light_dfs, weights,
            C=C, block=block, Q=Q, n_slots=n_slots,
            skip_sort="lsort" in prof_skip, skip_segsum="segsum" in prof_skip,
        )
        sd_clip = sd.clamp(0, n_slots - 1)
        if "hgather" in prof_skip:
            hval = torch.zeros(sq.shape, dtype=torch.float32, device=dev)
        else:
            hval = H[sq.clamp(0, Q - 1), sd_clip].float()
        valid_last = last & (sq < Q)
        light_only = valid_last & (hval == 0.0)
        if "lcount" in prof_skip:
            found = heavy_found
        else:
            found = heavy_found + per_query_counts(sq, light_only, Q)
        sel_score = torch.where(valid_last, stot + hval, zero)
        if "sort2" in prof_skip:
            ldocs = torch.full((Q, K2), PAD_DOC, dtype=torch.int64, device=dev)
            lvals = torch.zeros((Q, K2), dtype=torch.float32, device=dev)
        elif _windowed(w_max):
            # each query's lanes are one window of the (q, doc)-sorted
            # stream, doc-ascending inside it: K4's lowest-index tie rule is
            # the sort path's (score desc, doc asc)
            bounds = torch.searchsorted(
                sq, torch.arange(Q + 1, dtype=sq.dtype, device=dev))
            lvals, gidx = per_query_topk(sel_score, bounds, K2)
            ldocs = torch.where(lvals > 0, sd[gidx], torch.full_like(gidx, PAD_DOC))
        else:
            ldocs, lvals = per_query_topk_flat(
                sq, sel_score, sd, Q, K2, quantized=fast_heavy,
                two_level=two_level,
            )
    if "cand_heavy" in prof_skip:
        hdocs = torch.full((Q, K2), PAD_DOC, dtype=torch.int64, device=dev)
        hvals = torch.zeros((Q, K2), dtype=torch.float32, device=dev)
    else:
        hvals, hdocs = heavy_candidates(H, smax_sq, K2, Q, n_slots)
    if fast_heavy:
        allv = torch.cat([lvals, hvals], dim=1)
        alld = torch.cat([ldocs, hdocs], dim=1)
        mvals, midx = _stable_topk(allv, K2)
        cand = torch.gather(alld, 1, midx)
        tau = torch.maximum(
            torch.maximum(lvals[:, K2 - 1], hvals[:, K2 - 1]), mvals[:, K2 - 1]
        )
    else:
        cand = torch.cat([ldocs, hdocs], dim=1)
    cand = torch.where(cand >= n_slots, torch.full_like(cand, PAD_DOC), cand)

    if "rescore" in prof_skip:
        safe_cand = cand.clamp(0, n_slots - 1)
        exact = (cand < n_slots).to(torch.float32)
    else:
        exact, safe_cand = _rescore(
            post_doc, post_score, dense_rows, bucket_pos, light_bucket_pos,
            plan, cand, n_slots=n_slots, bs_steps=bs_steps, nd=nd, nl=nl,
            L2=L2, H2=H2, lb_log2=lb_log2, heavy_direct=heavy_direct,
        )
    sval, sdoc = canonical_sort(exact, safe_cand)
    sval, sdoc = dedup_sorted(sval, sdoc)

    cols = [
        sval[:, :K],
        sdoc[:, :K].to(torch.float32),
        found[:, None].to(torch.float32),
    ]
    if fast_heavy:
        # eps composes the one-pass dot's bound with the quantized
        # selection key's truncation (2^-(22 - qbits)), as the reference
        # does; K4's values are exact and add no term, and the bf16 H store
        # rounds up, so its values bound the f32 sums and add none either
        qbits = (Q + 1).bit_length()
        e2 = 0.0 if _windowed(w_max) else 2.0 ** -(22 - qbits)
        cols.append(_guard_column(sval, tau, K, guard_eps + e2 * (1.0 + guard_eps)))
    return torch.cat(cols, dim=1)


def unified_entries(post_doc, post_score, plan, *, C: int, block: int,
                    n_slots: int):
    """The light entries of a plan as (doc, q, value) streams sorted by
    (doc, q), the order K5 takes them in: one stable sort of an int64
    (doc << qshift) | q key (the reference packs the same order into
    uint32 where it fits). Dead lanes carry doc = n_slots and sort last."""
    Q = plan.shape[1]
    weights = plan[5].contiguous().view(torch.float32)
    doc, cq, _valid, contrib = light_entries(
        post_doc, post_score, plan[0], plan[1], weights,
        C=C, block=block, n_slots=n_slots,
    )
    qshift = max((Q - 1).bit_length(), 1)
    key = (doc << qshift) | cq.clamp(0, Q - 1)
    skey, order = torch.sort(key, stable=True)
    return skey >> qshift, skey & ((1 << qshift) - 1), contrib[order]


def unified_impl(post_doc, post_score, dense_rows, light_bucket_pos, plan, *,
                 n_slots: int, K: int, K2: int, C: int, block: int,
                 bs_steps: int, nd: int, nl: int, U: int,
                 heavy_direct: bool = True, fast_heavy: bool = False,
                 guard_eps: float = 2e-3, L2: int = 0, bucket_pos=None):
    """One sparse batch through the unified-totals pipeline; packed output
    as packed_impl's ([Q, 2K+1], plus the guard column under fast_heavy).

    Port of nextsearch_tpu/ops/bm25_sparse.py bm25_search_sparse_unified
    with use_pallas=True's kernel choices: the compact table by K2 (bf16,
    fast, over f32 rows) or K3 (the rows' own type), the light entries
    sorted by (doc, q) and folded into the product by K5, whose tile counts
    give `found` exactly; ONE K2-wide candidate pool off the totals'
    sub-block maxima; the v4 rescore (v2 over bucket_pos when heavy_direct
    is off, as with bf16 dense rows) and the canonical order (no dedup: a
    doc enters the one pool once). Under fast_heavy a trip means the caller
    relaunches the exact packed kernel. The light bucket granularity is the
    default one."""
    Q = plan.shape[1]
    mix, ids = heavy_operands(plan, dense_rows.shape[0], nd=nd, U=U,
                              use_compact=True)
    table = _compact_table(ids, dense_rows, fast=fast_heavy)
    sd, sq, sv = unified_entries(post_doc, post_score, plan, C=C,
                                 block=block, n_slots=n_slots)
    totals, smax_sq, cnt_tq = unified_fused(mix, table, sd, sq, sv,
                                            fast=fast_heavy)
    del table, sd, sq, sv
    found = cnt_tq.sum(dim=0)
    pool_vals, cand = heavy_candidates(totals, smax_sq, K2, Q, n_slots)
    del totals
    cand = torch.where(cand >= n_slots, torch.full_like(cand, PAD_DOC), cand)
    exact, safe_cand = _rescore(
        post_doc, post_score, dense_rows, bucket_pos, light_bucket_pos, plan,
        cand, n_slots=n_slots, bs_steps=bs_steps, nd=nd, nl=nl, L2=L2, H2=0,
        lb_log2=LIGHT_BUCKET_LOG2, heavy_direct=heavy_direct,
    )
    sval, sdoc = canonical_sort(exact, safe_cand)
    cols = [
        sval[:, :K],
        sdoc[:, :K].to(torch.float32),
        found[:, None].to(torch.float32),
    ]
    if fast_heavy:
        cols.append(_guard_column(sval, pool_vals[:, K2 - 1], K, guard_eps))
    return torch.cat(cols, dim=1)


def packed_multi(post_doc, post_score, dense_rows, light_bucket_pos, plans,
                 **statics):
    """G block-diagonal sub-batches ([G, 7, Q, T] plans), one after
    another; outputs stacked to [G*Q, cols]. Port of
    bm25_search_sparse_packed_multi (one XLA program there, a loop here:
    eager torch needs no program boundary)."""
    return torch.cat([
        packed_impl(post_doc, post_score, dense_rows, light_bucket_pos,
                    plans[g], **statics)
        for g in range(plans.shape[0])
    ], dim=0)
