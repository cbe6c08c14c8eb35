"""SparsePlanner: the host (numpy) half of the sparse-mode index.

A copy of the planning half of nextsearch_tpu/index/segment.py's
DeviceIndex, with its device uploads and launches left out: the 1-term
shortcut tables (row top-k from host postings, light top-k), the merged
lexicon table, the workload probe and shape pins, plan_sparse and the
multi-launch group plans, plan and plan_full (the fused, exact and fast
modes' plan; plan_sparse and plan_full each fill their arrays in one flat
pass over the batch), the host chunk plan of the fast mode, the static
budgets (C, L2, H2, W), the host-oracle rescue of guard-tripped queries
with its memo, and the slot -> document mapping.
nextsearch_tpu_torch/index/segment.py's TorchIndex builds the lexicons and
device tables and subclasses this; every method here keeps the JAX
package's behavior bit for bit (tests/test_torch_host.py). Two additions
of the port change no result: pin_shapes(scope_q=True) also keeps its pins
for the probe's (Q, T) envelope, which a batch of that T takes first; and
a tripped query of one df-head term beside rare ones is rescued from the
row top-k table (_head_answer), as the oracle would answer it.

Planning is numpy only; a query is planned host-side into fixed-shape
packed plan arrays, then executed by the port's ops/bm25_sparse.py (sparse
mode) or ops/bm25.py (fused, exact, fast).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.floatops import logf_exact
from ..utils.logging import log
from ..utils.profiling import GLOBAL_TRACER
from .builder import eager_scores_at
from .oracle import oracle_search_vec

WeightedTerm = Tuple[str, float]

def _bucket(n: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1] if n <= buckets[-1] else n


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _deal_sorted(order: np.ndarray, g: int) -> np.ndarray:
    """Deal a sorted query order round-robin into the multi-launch groups.

    `order` is the window-sorted index order; the group path slices the
    permuted list into consecutive blocks of `g` (last block = remainder).
    Dealing assigns sorted element i to the next non-full group in
    rotation, so each group's block stays internally sorted (a stride of
    a sorted list is sorted — the selection kernel's clustering invariant)
    while window/posting mass balances across groups. Without this the
    global sort concentrates the big windows into the LAST group and its
    inflated C/L2 budgets tax every group (all groups share one kernel
    shape, the max over groups)."""
    nq = int(order.shape[0])
    gn = -(-nq // g)
    sizes = [g] * (gn - 1) + [nq - g * (gn - 1)]
    groups: list = [[] for _ in range(gn)]
    j = 0
    for idx in order:
        while len(groups[j % gn]) >= sizes[j % gn]:
            j += 1
        groups[j % gn].append(idx)
        j += 1
    return np.concatenate(
        [np.asarray(gq, dtype=order.dtype) for gq in groups]
    )


def _pick_shape(
    n: int,
    buckets: Sequence[int],
    pin: Optional[int] = None,
    warn_tag: str = "",
) -> int:
    """Static kernel shape for a batch-varying size.

    pinned: return the pin; overflow escapes to the next multiple of the
    pin (bounded distinct shapes), counted (planner.escapes) and logged
    with a warning — recompile flapping
    mid-serving is THE throughput killer (measured: an unpinned static U
    collapsed serving to 141 QPS), so escapes must be rare and loud.
    unpinned: bucket ladder; overflow past the ladder rounds up to
    multiples of the LARGEST bucket (previously the smallest, which
    generated unboundedly many shapes just past the ladder).
    """
    n = max(n, 1)
    if pin:
        if n <= pin:
            return pin
        v = _round_up(n, pin)
        GLOBAL_TRACER.count("planner.escapes")
        if warn_tag:
            log(
                "shapes",
                f"{warn_tag}={n} exceeds pinned {pin}; taking a "
                f"{v}-shape escape (a launch of a new shape captures "
                f"its CUDA graph once)",
                level="warning",
            )
        return v
    # NB: must compare against the LADDER TOP, not _bucket's return —
    # _bucket returns raw n past the ladder, so `n > b` was dead code and
    # every off-ladder size compiled its own shape. Measured in serving:
    # engine cache hits shrink each batch's pending count differently
    # (512 -> 460 -> 422 -> ...), and each count became a fresh ~25s XLA
    # compile of the packed kernel.
    if n > buckets[-1]:
        return _round_up(n, buckets[-1])
    return _bucket(n, buckets)


_EMPTY_I64 = np.empty(0, np.int64)


def _ranges(counts: np.ndarray) -> np.ndarray:
    """Concatenated [0..c) ranges for each c in counts (vectorized)."""
    total = int(counts.sum())
    if total == 0:
        return _EMPTY_I64
    out = np.arange(total, dtype=np.int64)
    ends = np.cumsum(counts)
    out -= np.repeat(ends - counts, counts)
    return out


def _probe_queries_flat(slices, queries):
    """Merged-lexicon row indices and repeated weights of a batch: one
    dict probe per (query, term); occurrences expand to consecutive table
    rows in ONE numpy expansion for the whole batch (a per-query
    list-of-arrays probe costs ~10 small numpy calls per query — ~20 ms of
    serial host time at batch 512, measured).

    Returns (rows_flat int64, ws_flat f32, q_lens int64[len(queries)]):
    merged-table row ids and weights in (query, term-occurrence) order,
    plus per-query row counts.
    """
    offs: List[int] = []
    cnts: List[int] = []
    ws: List[float] = []
    q_lens = np.zeros(len(queries), np.int64)
    for qi, terms in enumerate(queries):
        tot = 0
        for term, w in terms:
            oc = slices.get(term)
            if oc is not None:
                offs.append(oc[0])
                cnts.append(oc[1])
                ws.append(w)
                tot += oc[1]
        q_lens[qi] = tot
    cnts_a = np.asarray(cnts, np.int64)
    rows = np.repeat(np.asarray(offs, np.int64), cnts_a) + _ranges(cnts_a)
    ws_flat = np.repeat(np.asarray(ws, np.float32), cnts_a)
    return rows, ws_flat, q_lens


@dataclass
class QueryResult:
    """One query's hits as global doc slots (segment/docId via locate())."""

    scores: np.ndarray  # f32 [<=k]
    doc_slots: np.ndarray  # int32 [<=k]
    found: int


class ResultColumns(Sequence[QueryResult]):
    """One batch's hits as flat arrays, query after query: query i's hits,
    in rank order, are scores[offsets[i]:offsets[i + 1]] and the same
    slice of doc_slots, and it found found[i] documents. It reads as the
    batch's sequence of QueryResults, whose arrays are views of these, so
    a change made in place to a QueryResult's arrays is a change to the
    columns."""

    def __init__(self, scores, doc_slots, offsets, found):
        self.scores = scores  # f32 [n hits]
        self.doc_slots = doc_slots  # int32 [n hits]
        self.offsets = offsets  # int64 [nq + 1]
        self.found = found  # int32 [nq]

    @classmethod
    def build(cls, vals, slots, found, perm=None, fills=None):
        """The columns of a launch's top-w (vals, int32 slots, found) in
        launch row order: a hit is a positive score; row j answers the
        batch's query perm[j] where the launch was permuted; fills
        ({query: QueryResult}, answered on the host) replace their rows."""
        mask = vals > 0.0
        if perm is not None:
            rows = (vals, slots, mask, found)
            vals, slots, mask, found = (np.empty_like(a) for a in rows)
            for dst, src in zip((vals, slots, mask, found), rows):
                dst[perm] = src
        if fills:
            w = max([vals.shape[1]] + [len(f.scores) for f in fills.values()])
            pad = ((0, 0), (0, w - vals.shape[1]))
            # copies: the launch's own arrays are left as they came
            vals, slots, mask = (np.pad(a, pad) for a in (vals, slots, mask))
            found = np.array(found, np.int32)
            for qi, f in fills.items():
                n = len(f.scores)
                vals[qi, :n] = f.scores
                slots[qi, :n] = f.doc_slots
                mask[qi] = False
                mask[qi, :n] = True
                found[qi] = f.found
        offsets = np.zeros(len(mask) + 1, np.int64)
        np.cumsum(mask.sum(axis=1), out=offsets[1:])
        return cls(vals[mask], slots[mask], offsets,
                   np.asarray(found, np.int32))

    @classmethod
    def from_rows(cls, results: Sequence[QueryResult]) -> "ResultColumns":
        """The columns of a batch given as one QueryResult a query."""
        offsets = np.zeros(len(results) + 1, np.int64)
        np.cumsum([len(r.scores) for r in results], out=offsets[1:])
        return cls(
            np.concatenate([np.asarray(r.scores, np.float32) for r in results]
                           + [np.empty(0, np.float32)]),
            np.concatenate([np.asarray(r.doc_slots, np.int32)
                            for r in results] + [np.empty(0, np.int32)]),
            offsets, np.array([int(r.found) for r in results], np.int32))

    def __len__(self) -> int:
        return len(self.found)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = range(len(self))[i]
        a, b = int(self.offsets[i]), int(self.offsets[i + 1])
        return QueryResult(self.scores[a:b], self.doc_slots[a:b],
                           int(self.found[i]))

    def __iter__(self):
        offs = self.offsets.tolist()
        for a, b, f in zip(offs, offs[1:], self.found.tolist()):
            yield QueryResult(self.scores[a:b], self.doc_slots[a:b], f)


def _log_build_phases(phases) -> None:
    """One-line cold-start attribution (VERDICT r3 item 5)."""
    log("build", "phases: " + " ".join(
        f"{n}={s:.1f}s" for n, s in phases if s >= 0.05
    ))


class SparsePlanner:
    """The host planner of an immutable multi-segment sparse index.

    A subclass builds, before planning: segments, seg_names, doc_bases,
    n_docs, n_slots, n_dense, n_light, lex, _light_row, _seg_pbase, _gdf,
    _merged_heavy, _heavy_direct, _sparse, host_only, config and the
    memo/pin dicts; then _row_topk (via _row_topk_host), _light_topk (via
    _build_light_topk) and the merged lexicon (_build_merged_lex)."""

    T_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
    Q_BUCKETS = (1, 8, 16, 32, 64, 128)
    K_BUCKETS = (10, 32, 100)
    # Static compact light-pair count for the v4 rescore (live light
    # (query, slot) pairs per launch; pinned like C).
    L_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    # Static compact heavy-pair count for the v5 rescore (live heavy
    # (query, slot) pairs per launch; pinned like L).
    HP_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    # Selection-window envelope (ops/select_pallas.py): max entries of one
    # query's contiguous run of the flat light array = that query's summed
    # light dfs. Scan volume scales with the bucket, so serving pins it to
    # the measured workload (p100 of probe batches) instead of the
    # theoretical T * max-light-df bound (4096 at the 1M serving point,
    # ~10x the typical query - measured as a selection kernel that cost as
    # much as the sort it replaced).
    W_BUCKETS = (512, 1024, 2048, 4096, 8192, 16384, 32768)

    def _row_topk_host(self, n: int, k: int, post_doc, post_score):
        """Exact canonical top-k of the df-head rows from host postings.

        A dense row's nonzero values ARE the term's eager posting scores
        (merged across segments), so np.argpartition over each head
        term's posting lanes + one canonical sort of the k survivors
        reproduces the device row sort bit-for-bit at a fraction of the
        cost (device path measured 60-150s for 256 rows at 1M slots;
        this is ~1-2s of numpy). Device path kept behind
        NEXTSEARCH_ROW_TOPK_BUILD=device and the parity tests compare
        both against the oracle."""
        vals = np.zeros((n, k), np.float32)
        slots = np.full((n, k), 2**30, np.int32)
        # head terms by dense row id: row_id < n. Collect each row's
        # (start, df, segment) posting ranges from the per-segment lex.
        row_ranges: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
        for lex in self.lex:
            for _t, (start, df, row_id) in lex.items():
                if 0 <= row_id < n and df > 0:
                    row_ranges[row_id].append((start, df))
        for row_id, ranges in enumerate(row_ranges):
            if not ranges:
                continue
            sc_parts = [post_score[s:s + d] for s, d in ranges]
            doc_parts = [post_doc[s:s + d] for s, d in ranges]
            sc = sc_parts[0] if len(sc_parts) == 1 else np.concatenate(sc_parts)
            doc = doc_parts[0] if len(doc_parts) == 1 else np.concatenate(doc_parts)
            if sc.shape[0] > k:
                part = np.argpartition(-sc, k - 1)[:k]
                sc = sc[part]
                doc = doc[part]
            order = np.lexsort((doc, -sc))
            m = order.shape[0]
            vals[row_id, :m] = sc[order]
            slots[row_id, :m] = doc[order]
        return vals, slots

    def _build_light_topk(self, post_doc_parts, post_score_parts) -> None:
        """Precompute exact canonical top-k per LIGHT (term, segment)
        posting range (host-side; the per-segment posting arrays are in
        hand at build either way).

        A 1-term light query is a pure function of its posting list(s),
        so search_batch answers it host-side like the heavy row-topk —
        and pin_shapes' workload probe skips eligible queries, shrinking
        the C/L2 budgets (light gather/sort volume IS wall time) by those
        queries' postings. Canonical (score desc, slot asc) tie order is
        exact via one uint64 key (score_bits << 24 | ~slot): positive f32
        bit patterns are order-isomorphic to uint32 and global slots fit
        24 bits (the packed result transport already requires that)."""
        self._light_topk = None
        dcfg = self.config.device
        kl = dcfg.light_topk_k
        if (
            not self._sparse
            or self.host_only
            or kl <= 0
            or self.n_light == 0
            or self.n_slots >= 1 << 24
        ):
            return
        kl = min(kl, self.n_slots)
        vals = np.zeros((self.n_light, kl), np.float32)
        slots = np.full((self.n_light, kl), 2**30, np.int32)
        for seg_i, lmap in enumerate(self._light_row):
            if not lmap:
                continue
            lex = self.lex[seg_i]
            pb = self._seg_pbase[seg_i]
            items = sorted(lmap.items(), key=lambda kv: kv[1])  # row asc
            rows_arr = np.asarray([r for _t, r in items], np.int64)
            starts = np.asarray(
                [lex[t][0] - pb for t, _r in items], np.int64
            )
            dfs = np.asarray([lex[t][1] for t, _r in items], np.int64)
            total = int(dfs.sum())
            if total == 0:
                continue
            cum = np.cumsum(dfs)
            rep = np.repeat(np.arange(len(items), dtype=np.int64), dfs)
            pos = (
                np.arange(total, dtype=np.int64)
                - np.repeat(cum - dfs, dfs)
                + starts[rep]
            )
            sc = np.ascontiguousarray(
                post_score_parts[seg_i][pos], dtype=np.float32
            )
            doc = post_doc_parts[seg_i][pos]  # global slots
            # One uint64 key + stable radix argsort instead of the old
            # 2-key lexsort (measured 42s -> ~5s on the 50M-lane 1M-doc
            # corpus): row in the high bits, INVERTED positive-f32 score
            # pattern below (ascending ~bits = score desc). Ties keep
            # stream order, and postings are doc-ascending within a row,
            # so canonical (score desc, slot asc) order is preserved
            # bit-for-bit — the same order the old slot-bearing key gave.
            key2 = (rep.astype(np.uint64) << np.uint64(32)) | (
                ~sc.view(np.uint32)
            ).astype(np.uint64)
            order = np.argsort(key2, kind="stable")  # row asc, key desc
            off = cum - dfs
            take = np.minimum(dfs, kl)
            sel_rows = np.repeat(np.arange(len(items)), take)
            within = np.arange(int(take.sum())) - np.repeat(
                np.cumsum(take) - take, take
            )
            src = order[off[sel_rows] + within]
            vals[rows_arr[sel_rows], within] = sc[src]
            slots[rows_arr[sel_rows], within] = doc[src]
        self._light_topk = (vals, slots)

    def _shortcut_single_heavy(self, queries, k: int):
        """Answer 1-term queries from precomputed tables, host-side.

        Heavy terms (merged dense row inside the row-topk head) read the
        row's canonical prefix; light terms merge their per-(term,
        segment) posting-prefix top-ks (exact: docs live in one segment,
        and a global top-k member is inside its own segment's top-k, so
        k <= light_topk_k keeps every candidate within the prefixes).

        Returns (queries, fills): shortcut queries are replaced with []
        (their plan slots empty out; the batch envelope is unchanged so
        no shape flap) and fills maps their ORIGINAL batch index to the
        finished QueryResult, applied after gather un-permutes. Exact:
        the reference accumulates score = w * eager_score once per doc
        for a 1-term query, and the stored prefixes are already canonical
        (score desc, slot asc); w != 1 re-sorts after the multiply and an
        INCOMPLETE prefix must keep its k-th value strictly above the
        stored tail (else a doc outside could tie in — fall back to the
        kernel). Duplicate-term queries accumulate twice and never
        shortcut.

        w == 1 results (the entire organic 1-term stream: expansion
        produces multi-term queries, so off-1 weights never reach here)
        are memoized per (term, k) — Zipf query streams repeat head
        terms constantly, and the memo turns the numpy merge into one
        dict probe per query. QueryResults are shared across hits; they
        are read-only downstream.
        """
        lt = getattr(self, "_light_topk", None)
        if self._row_topk is None and lt is None:
            return queries, None
        memo = self._shortcut_memo
        fills = {}
        out = None
        for qi, terms in enumerate(queries):
            if len(terms) != 1:
                continue
            t, w = terms[0]
            w32 = np.float32(w)
            if not (w32 > 0) or not np.isfinite(w32):
                continue
            if w32 == np.float32(1.0):
                key = (t, k)
                res = memo.get(key, False)
                if res is False:
                    res = self._shortcut_compute(t, w32, k, lt)
                    if len(memo) >= 200_000:
                        memo.clear()
                    memo[key] = res
            else:
                res = self._shortcut_compute(t, w32, k, lt)
            if res is None:
                continue
            if out is None:
                out = list(queries)
            fills[qi] = res
            out[qi] = []
        return (out, fills) if fills else (queries, None)

    def _shortcut_compute(self, t, w32, k, lt):
        """One term's host-side 1-term answer, or None for the kernel
        path (see _shortcut_single_heavy for the exactness rules)."""
        oc = self._lex_slices.get(t)
        if oc is None:
            return None
        ent_all = self._lex_table[oc[0] : oc[0] + oc[1]]
        if (
            oc[1] == 1
            and ent_all[0, 2] >= 0
            and self._row_topk is not None
        ):
            ent = ent_all[0]
            vals_t, slots_t = self._row_topk
            kp = vals_t.shape[1]
            row = int(ent[2])
            if k > kp or row >= vals_t.shape[0]:
                return None
            vals = vals_t[row]
            slots = slots_t[row]
            if w32 != np.float32(1.0):
                sv = w32 * vals
                if not sv[min(k, kp) - 1] > sv[-1]:
                    return None  # multiply collapsed the prefix boundary
                order = np.lexsort((slots, -sv))
                sv = sv[order]
                slots = slots[order]
            else:
                sv = vals
            found = int(ent[1])
        elif lt is not None and (ent_all[:, 2] < 0).all():
            vals_l, slots_l = lt
            kl = vals_l.shape[1]
            if k > kl or (ent_all[:, 5] >= self.n_light).any():
                return None
            sv_all = []
            gs_all = []
            found = 0
            for ent in ent_all:
                row = int(ent[5])
                df = int(ent[1])
                sv1 = (
                    vals_l[row]
                    if w32 == np.float32(1.0)
                    else w32 * vals_l[row]
                )
                if (
                    df > kl
                    and w32 != np.float32(1.0)
                    and not sv1[min(k, kl) - 1] > sv1[-1]
                ):
                    return None  # collapsed incomplete-prefix boundary
                sv_all.append(sv1)
                gs_all.append(slots_l[row])
                found += df
            if len(sv_all) == 1 and w32 == np.float32(1.0):
                sv, slots = sv_all[0], gs_all[0]
            else:
                sv = np.concatenate(sv_all)
                slots = np.concatenate(gs_all)
                order = np.lexsort((slots, -sv))
                sv = sv[order]
                slots = slots[order]
        else:
            return None
        live = sv > 0
        return QueryResult(
            scores=sv[live][:k].astype(np.float32),
            doc_slots=slots[live][:k].astype(np.int32),
            found=found,
        )

    def _build_merged_lex(self) -> None:
        """Merge per-segment lexicons into one packed table for planning.

        _lex_slices: term -> (offset, count) into _lex_table, whose rows are
        (global posting start, df, dense_row_id, idf_bits, avgdl_bits,
        light_row_id) — one row per (term, segment) occurrence, segments
        ascending (preserving the canonical term-major/segment-ascending
        slot order). idf/avgdl are f32 bit patterns (idf via the platform
        logf, utils/floatops.py) so sparse-mode planning never recomputes
        them; light_row_id indexes light_bucket_pos (n_light for heavy
        slots / non-sparse mode). Querying costs ONE dict probe per
        (query, term) plus NumPy gathers, instead of a Python loop over
        every segment (VERDICT r1 item 7).
        """
        light_maps = getattr(self, "_light_row", None)
        merged = getattr(self, "_merged_heavy", False)
        occ: Dict[str, List[Tuple[int, int, int, int, int, int]]] = {}
        for seg_i, lex in enumerate(self.lex):
            seg = self.segments[seg_i]
            avgdl_bits = int(
                np.float32(seg.avgdl).view(np.uint32)
            )
            lmap = light_maps[seg_i] if light_maps else {}
            # vectorized idf for this segment's lexicon, in lex order
            items = [(t, v) for t, v in lex.items() if v[1] > 0]
            if items:
                dfs = np.asarray([v[1] for _t, v in items], np.uint32)
                num = (np.uint32(seg.N) - dfs).astype(np.float32) + np.float32(0.5)
                den = dfs.astype(np.float32) + np.float32(0.5)
                idf = logf_exact(num / den + np.float32(1.0))
                idf_bits = idf.view(np.uint32)
                nl = getattr(self, "n_light", 0)
                for (t, v), ib in zip(items, idf_bits):
                    if merged and v[2] >= 0:
                        # merged dense row: ONE planning slot per heavy
                        # term across all segments (df = global df; the
                        # posting start is meaningless and unused — the
                        # direct rescore reads scores off the row)
                        if t not in occ:
                            occ[t] = [
                                (0, self._gdf[t], v[2], int(ib),
                                 avgdl_bits, nl)
                            ]
                        continue
                    occ.setdefault(t, []).append(
                        (v[0], v[1], v[2], int(ib), avgdl_bits,
                         lmap.get(t, nl))
                    )
        n_rows = sum(len(v) for v in occ.values())
        table = np.zeros((max(n_rows, 1), 6), np.int64)
        slices: Dict[str, Tuple[int, int]] = {}
        pos = 0
        for t, vs in occ.items():
            slices[t] = (pos, len(vs))
            for v in vs:
                table[pos] = v
                pos += 1
        self._lex_table = table
        self._lex_slices = slices

    # ---------------- common index interface ----------------
    # (shared with parallel.sharded.ShardedIndex so Engine/HybridIndex code
    #  works against either)

    def iter_lexicons(self):
        """Yield every per-segment lexicon dict (term -> (start, df, dense))."""
        return iter(self.lex)

    @property
    def slot_capacity(self) -> int:
        """Size of the global doc-slot space (doc_slots index into this)."""
        return self.n_slots

    def segment_slot_bases(self) -> List[int]:
        """Global doc-slot base per segment, aligned with self.segments."""
        return list(self.doc_bases)

    # ---------------- shape pinning ----------------

    def probe_workload(
        self, batches: Sequence[Sequence[Sequence[WeightedTerm]]],
        shortcut_k: int = 10,
    ) -> Dict[str, int]:
        """Max static-shape drivers over a sample workload (host-only).

        Returns {"T": max term slots per query, "Q": max batch size,
        "C": max live posting chunks per batch, "U": max unique dense
        rows per batch, "W": max summed light dfs of one query (the
        selection-window driver), "L": max live light (query, slot)
        pairs per batch (the v4 compact-rescore block), "HP": max live
        heavy (query, slot) pairs per batch (the v5 compact heavy-value
        gather)} — the inputs pin_shapes() freezes. Costs one lexicon probe per (query, term);
        no device work.

        The probe applies the 1-term shortcut (row/light top-k tables) at
        `shortcut_k` first, exactly as serving does, so the pinned C/L2
        budgets exclude host-answered queries' postings. A serving
        request with k above the precomputed table width falls back to
        the kernel and takes a bounded, logged escape shape.
        """
        block = self.config.device.posting_block
        table = self._lex_table
        t = q = c = u = w = li = hp = 1
        for b in batches:
            q = max(q, len(b))
            b, _f = self._shortcut_single_heavy(b, shortcut_k)
            rows, _ws, q_lens = _probe_queries_flat(self._lex_slices, b)
            if not rows.shape[0]:
                continue
            t = max(t, int(q_lens.max()))
            ent = table[rows]
            dense = ent[:, 2]
            light = dense < 0
            # each query's summed light dfs, over its q_lens segment
            starts = (np.cumsum(q_lens) - q_lens)[q_lens > 0]
            w = max(w, int(np.add.reduceat(np.where(light, ent[:, 1], 0),
                                           starts).max()))
            light_df = ent[light, 1]
            c = max(c, int(np.sum((light_df + block - 1) // block)))
            u = max(u, int(np.unique(dense[dense >= 0]).shape[0]))
            li = max(li, int(light.sum()))
            hp = max(hp, int((dense >= 0).sum()))
        return {"T": t, "Q": q, "C": c, "U": u, "W": w, "L": li, "HP": hp}

    def pin_shapes(
        self,
        probe_batches=None,
        *,
        T: Optional[int] = None,
        Q: Optional[int] = None,
        C: Optional[int] = None,
        U: Optional[int] = None,
        W: Optional[int] = None,
        L: Optional[int] = None,
        HP: Optional[int] = None,
        c_pad: int = 128,
        u_pad: int = 16,
        scope_q: bool = False,
    ) -> Dict[str, int]:
        """Freeze the batch-varying static kernel shapes for serving.

        Any batch within the pinned envelope then compiles to ONE kernel
        shape; mid-serving recompiles (bucket flapping — the failure class
        the serving rules forbid) become impossible for covered workloads, and
        overflow escapes are bounded (multiples of the pin) and logged.

        Sizes come from `probe_batches` (a sample workload; see
        probe_workload) and/or explicit keyword pins, which win. Returns
        the active pin dict. Replaces the ad-hoc probe-then-pin dances
        bench.py / benchmarks/eval_configs.py used to hand-roll.

        scope_q=True pins {C, U, W} for the probe's Q ENVELOPE only (the
        Q bucket those batches compile under), leaving other batch sizes
        on their own scopes/ladders. A server whose batching queue emits
        mixed sizes calls this once per expected size (see Engine.warmup)
        so a 1-query request neither pads to the max-batch C/U/W envelope
        nor flaps the big batches' shapes. T is NOT scoped: a probe that
        under-represents term counts (e.g. before semantic expansion)
        would seed more escape shapes than the bounded T ladder. Scoped
        pins win over global ones; requires probe_batches.

        The same pins are also kept for the probe's (Q, T) envelope (T the
        bucket of its longest query's term slots), and a batch whose plan
        has that T takes them first: a server that probes short and long
        queries apart (Engine.warmup) gives each T envelope its own
        shapes, so long queries neither escape the short queries' pins nor
        pad the short queries' launches to their own.
        """
        if scope_q:
            if probe_batches is None:
                raise ValueError("scope_q=True requires probe_batches")
            m = self.probe_workload(probe_batches)
            qb = _pick_shape(m["Q"], self.Q_BUCKETS, self._pins.get("Q"))
            scope = self._qpins.setdefault(qb, {})
            for k, v in (
                ("C", C or _round_up(m["C"], c_pad)),
                ("U", U or _round_up(m["U"] + 1, u_pad)),
                ("W", W or _bucket(m["W"], self.W_BUCKETS)),
                ("L", L or _bucket(m["L"], self.L_BUCKETS)),
                ("HP", HP or _bucket(m["HP"], self.HP_BUCKETS)),
            ):
                scope[k] = int(v)
            self._tpins[(qb, _bucket(m["T"], self.T_BUCKETS))] = dict(scope)
            return {qb: dict(scope)}
        if probe_batches is not None:
            m = self.probe_workload(probe_batches)
            T = T or _bucket(m["T"], self.T_BUCKETS)
            Q = Q or _bucket(m["Q"], self.Q_BUCKETS)
            C = C or _round_up(m["C"], c_pad)
            U = U or _round_up(m["U"] + 1, u_pad)
            W = W or _bucket(m["W"], self.W_BUCKETS)
            L = L or _bucket(m["L"], self.L_BUCKETS)
            HP = HP or _bucket(m["HP"], self.HP_BUCKETS)
        for k, v in (
            ("T", T), ("Q", Q), ("C", C), ("U", U), ("W", W), ("L", L),
            ("HP", HP),
        ):
            if v:
                self._pins[k] = int(v)
        return dict(self._pins)

    def _pin(self, key: str, qb: Optional[int] = None,
             t: Optional[int] = None) -> Optional[int]:
        """Effective pin for `key`: the pin scoped to this batch's (Q, T)
        envelope, then the Q-scoped pin for its Q envelope (both from
        pin_shapes(scope_q=True)), win over the global pin.

        A Q envelope with NO scoped pin borrows the nearest LARGER warmed
        envelope's pin (else the largest). Unpinned budgets re-derive
        C/L2/H2/W from each batch's own workload, so successive batches
        flap static shapes and EVERY batch pays a fresh XLA compile —
        measured served QPS 9.5 (one ~39s compile per 256-query batch,
        device exec 62 ms) when the dispatcher emitted a batch size warmup
        had not pinned. Borrowed pins over-pad smaller batches (bounded
        waste) but guarantee one compiled shape per Q bucket."""
        if qb is not None:
            v = self._tpins.get((qb, t), {}).get(key)
            if v:
                return v
            v = self._qpins.get(qb, {}).get(key)
            if v:
                return v
            # Borrow ONLY from larger envelopes: a smaller envelope's pin
            # would under-budget this batch and flap escape shapes instead.
            # (Warmup always pins the max_batch envelope, so every serving
            # batch has a larger-or-equal warmed scope to borrow.)
            larger = [q for q in self._qpins if q > qb]
            if larger:
                v = self._qpins[min(larger)].get(key)
                if v:
                    return v
        return self._pins.get(key)

    # ---------------- query planning ----------------

    def plan(
        self, queries: Sequence[Sequence[WeightedTerm]]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pack weighted term lists into padded (starts, dfs, weights).

        Slot order is term-major, segment ascending; inactive slots carry
        df=0/weight=0 and are no-ops in the kernel.
        """
        starts, dfs, weights, _l, _u, _m = self.plan_full(queries)
        return starts, dfs, weights

    def plan_full(self, queries: Sequence[Sequence[WeightedTerm]]):
        """plan() + hybrid split: light dfs and the unique-heavy-row mix
        (the fused, exact and fast modes' plan).

        One flat pass over the batch: one _lex_slices probe per (query,
        term), one gather from the merged _lex_table and scatter writes by
        (query, term slot) fill the padded plan arrays, as plan_sparse
        does. The heavy mix adds in query-major, term order, so its
        float32 sums are the reference's bit for bit.
        """
        table = self._lex_table
        rows_all, ws_all, q_lens = _probe_queries_flat(
            self._lex_slices, queries
        )
        t_max = int(q_lens.max()) if q_lens.size else 0

        Qb = _pick_shape(
            len(queries), self.Q_BUCKETS, self._pins.get("Q"), "Q"
        )
        T = _pick_shape(t_max, self.T_BUCKETS, self._pin("T", Qb), "T")

        starts = np.zeros((Qb, T), np.int32)
        dfs = np.zeros((Qb, T), np.int32)
        weights = np.zeros((Qb, T), np.float32)
        light_dfs = np.zeros((Qb, T), np.int32)
        # T >= every query's row count (_pick_shape escapes past a pin),
        # so each query's rows fit its row of the plan whole.
        n_uniq = 0
        if rows_all.size:
            qi = np.repeat(np.arange(len(queries), dtype=np.int64), q_lens)
            ti = _ranges(q_lens)
            ent = table[rows_all]  # [n, 6]
            dense = ent[:, 2]
            light = dense < 0
            starts[qi, ti] = ent[:, 0]
            dfs[qi, ti] = ent[:, 1]
            weights[qi, ti] = ws_all
            light_dfs[qi, ti] = np.where(light, ent[:, 1], 0)
            heavy = ~light
            uniq_ids, inv = np.unique(dense[heavy], return_inverse=True)
            n_uniq = uniq_ids.shape[0]
        hb = self.config.device.heavy_buckets
        U = _pick_shape(n_uniq, hb, self._pin("U", Qb, T), "U")
        unique_heavy = np.full(U, self.n_dense, np.int32)  # pad -> zero row
        heavy_mix = np.zeros((Qb, U), np.float32)
        if n_uniq:
            unique_heavy[:n_uniq] = uniq_ids
            np.add.at(heavy_mix, (qi[heavy], inv), ws_all[heavy])
        return starts, dfs, weights, light_dfs, unique_heavy, heavy_mix

    def plan_sparse(
        self,
        queries: Sequence[Sequence[WeightedTerm]],
        q_override: Optional[int] = None,
        t_override: Optional[int] = None,
    ):
        """Sparse-mode plan: packed int/f32 plan blocks for
        ops/bm25_sparse.bm25_search_sparse_packed.

        q_override/t_override force the Qb/T envelope (multi-launch groups
        must stack into one [G, 7, Qb, T] block; _pick_shape treats them
        like pins, so an overflowing group still escapes loudly).

        Returns (plan int32 [7, Qb, T], U) — one device upload:
          rows: starts / light_dfs (0 for heavy: excluded from chunk
                expansion) / slot_dense (n_dense = light) / slot_light
                (light_bucket_pos row id; n_light = heavy/padding) /
                slot_compact (compact unique-row id; U = light/padding) /
                weight f32 bit patterns (pure bitcast; weights are normal
                floats, never denormal) / the U unique dense row ids this
                batch touches (row-major, U <= Qb*T by construction;
                unused entries = n_dense -> zero row)
          U:    static compact-table size (bucketed via heavy_buckets)
        """
        table = self._lex_table
        rows_all, ws_all, q_lens = _probe_queries_flat(
            self._lex_slices, queries
        )
        t_max = int(q_lens.max()) if q_lens.size else 0

        Qb = _pick_shape(
            len(queries), self.Q_BUCKETS,
            q_override or self._pins.get("Q"), "Q",
        )
        T = _pick_shape(
            t_max, self.T_BUCKETS, t_override or self._pin("T", Qb), "T"
        )
        plan_ints = np.zeros((7, Qb, T), np.int32)
        plan_ints[2] += np.int32(self.n_dense)  # default: light/padding
        plan_ints[3] += np.int32(self.n_light)  # default: sentinel row
        weights = np.zeros((Qb, T), np.float32)
        # Flat vectorized fill: the per-query Python loop this replaces
        # cost ~22 ms per 512-query batch (measured) — serial host time
        # that caps serving QPS no matter how fast the device is.
        ti_all = _ranges(q_lens)
        keep = ti_all < T  # clip each query's rows to the T envelope
        total = int(keep.sum())
        if total:
            rows_flat = rows_all[keep]
            ws_flat = ws_all[keep]
            qi_flat = np.repeat(
                np.arange(len(queries), dtype=np.int64), q_lens
            )[keep]
            ti_flat = ti_all[keep]
            ent = table[rows_flat]  # [total, 6]
            dense = ent[:, 2]
            light = dense < 0
            plan_ints[0, qi_flat, ti_flat] = ent[:, 0]
            plan_ints[1, qi_flat, ti_flat] = np.where(light, ent[:, 1], 0)
            plan_ints[2, qi_flat, ti_flat] = np.where(
                light, self.n_dense, dense
            )
            plan_ints[3, qi_flat, ti_flat] = np.where(
                light, ent[:, 5], self.n_light
            )
            weights[qi_flat, ti_flat] = ws_flat
            hm = ~light
            ids = dense[hm]
        else:
            ids = _EMPTY_I64

        # Compact heavy-row table for this batch (kernel gathers these rows
        # and runs the MXU mix over compact ids instead of the full table).
        if ids.size:
            uniq, inv = np.unique(ids, return_inverse=True)
            n_uniq = uniq.shape[0]
        else:
            uniq = _EMPTY_I64
            inv = _EMPTY_I64
            n_uniq = 0
        hb = self.config.device.heavy_buckets
        U = _pick_shape(n_uniq, hb, self._pin("U", Qb, T), "U")
        plan_ints[4] = np.int32(U)  # default: light/padding -> zero row
        if n_uniq:
            plan_ints[4, qi_flat[hm], ti_flat[hm]] = inv
        plan_ints[5] = weights.view(np.int32)
        idbuf = np.full(Qb * T, self.n_dense, np.int32)
        idbuf[:n_uniq] = uniq
        plan_ints[6] = idbuf.reshape(Qb, T)
        return plan_ints, U

    # ---------------- execution ----------------

    def _plan_groups(self, queries, g: int):
        """Plan G block-diagonal sub-batches with ONE [G, 7, Qb, T] shape.

        Qb is forced to the group size; T starts at the pin (or group 1's
        envelope) and the loop restarts if a later group overflows it —
        rare, and the escape is already logged by _pick_shape. U is the
        max over groups: a plan built under a smaller U stays valid in a
        larger-U kernel (its padding slots point at zero dense rows).
        """
        n = len(queries)
        gn = -(-n // g)
        t_ov = self._pin("T", g)
        while True:
            plans = []
            us = []
            for gi in range(gn):
                p, u = self.plan_sparse(
                    queries[gi * g : (gi + 1) * g],
                    q_override=g, t_override=t_ov,
                )
                if t_ov is None:
                    t_ov = p.shape[2]
                elif p.shape[2] != t_ov:
                    t_ov = max(t_ov, p.shape[2])
                    break
                plans.append(p)
                us.append(u)
            else:
                return np.stack(plans), max(us)

    def search_batch(
        self, queries: Sequence[Sequence[WeightedTerm]], k: int
    ) -> List[QueryResult]:
        """Run one batched BM25 top-k kernel for all queries (blocking)."""
        return list(self.search_batch_gather(
            self.search_batch_async(queries, k)))

    def _light_budget(self, plan_ints) -> int:
        """Static live light-pair count L2 for the v4 compact rescore.

        plan_ints is one sparse plan [7, Qb, T] (or one group of the
        multi-launch block). Pairs are (query, slot) with a live light
        row and a nonzero weight; bucketed/pinned like C so serving keeps
        one compiled shape."""
        pairs = int(
            ((plan_ints[3] < self.n_light) & (plan_ints[5] != 0)).sum()
        )
        return _pick_shape(
            max(pairs, 1), self.L_BUCKETS,
            self._pin("L", *map(int, plan_ints.shape[-2:])), "L",
        )

    def _heavy_budget(self, plan_ints) -> int:
        """Static live heavy-pair count H2 for the v5 compact rescore.

        Pairs are (query, slot) with a live dense row and a nonzero
        weight; bucketed/pinned like L so serving keeps one compiled
        shape."""
        pairs = int(
            ((plan_ints[2] < self.n_dense) & (plan_ints[5] != 0)).sum()
        )
        return _pick_shape(
            max(pairs, 1), self.HP_BUCKETS,
            self._pin("HP", *map(int, plan_ints.shape[-2:])), "HP",
        )

    def _chunk_budget(self, dfs, block) -> int:
        """Static chunk count C for this batch (device expansion never drops)."""
        total = int(np.sum((dfs.astype(np.int64) + block - 1) // block))
        return _pick_shape(
            total, self.config.device.chunk_buckets,
            self._pin("C", *map(int, dfs.shape)), "C",
        )

    def _head_answer(self, terms, K):
        """The exact top-K hits and found count of a query of one df-head
        term (a dense row inside the row top-k table) and light terms of
        few postings, from that table and those postings: (hits as the
        oracle gives them, found), or None for a query of another form.

        Such a query's top-K is the head row's canonical prefix merged with
        the light terms' documents: every other document scores its head
        score alone, so the first K + r documents of the head row (r the
        light postings) outrank it, and each candidate's score is summed
        from the f32 posting scores in term-slot order, as the exact
        rescore sums it. The guard trips on such queries where the top K
        reaches the head term's near-uniform scores (a df ~ N term beside
        a few rare ones), and the oracle would pass over every document;
        here a few binary searches do. One segment, weights 1, distinct
        terms."""
        topk = self._row_topk
        if topk is None or len(self.segments) != 1:
            return None
        vals_t, slots_t = topk
        lex = self.lex[0]
        slots, head = [], None
        for t, w in terms:
            ent = lex.get(t)
            if ent is None or ent[1] == 0:
                continue
            if np.float32(w) != np.float32(1.0):
                return None
            if ent[2] >= 0:
                if head is not None or ent[2] >= vals_t.shape[0]:
                    return None
                head = len(slots)
            slots.append(ent)
        if head is None or len({e[0] for e in slots}) != len(slots):
            return None
        light = sum(int(e[1]) for i, e in enumerate(slots) if i != head)
        need, kp = K + light, vals_t.shape[1]
        _start, h_df, row = (int(x) for x in slots[head])
        if h_df > kp and (need > kp
                          or not vals_t[row, need - 1] > vals_t[row, kp - 1]):
            return None  # the stored prefix may not hold the candidates
        seg = self.segments[0]
        prefix = slots_t[row, :min(need, kp)][vals_t[row, :min(need, kp)] > 0]
        light_docs = np.unique(np.concatenate([np.zeros(0, np.int64)] + [
            seg.post_doc[start:start + df].astype(np.int64)
            for i, (start, df, _r) in enumerate(slots) if i != head]))
        cand = np.union1d(prefix.astype(np.int64), light_docs)
        acc = np.zeros(cand.shape[0], np.float32)
        in_head = None
        for i, (start, df, _r) in enumerate(slots):
            docs = seg.post_doc[start:start + df]
            pos = np.searchsorted(docs, cand.astype(docs.dtype))
            hit = pos < df
            hit[hit] = docs[pos[hit]] == cand[hit]
            v = np.zeros(cand.shape[0], np.float32)
            v[hit] = eager_scores_at(
                seg, int(df), start + pos[hit],
                k1=self.config.bm25.k1, b=self.config.bm25.b)
            acc = acc + v
            if i == head:
                in_head = hit
        # every head document scores, and the light ones outside it
        found = h_df + int(np.count_nonzero(
            ~in_head[np.isin(cand, light_docs)]))
        order = np.lexsort((cand, -acc))[:K]
        order = order[acc[order] > 0]
        return [(float(acc[i]), 0, int(cand[i])) for i in order], found

    def _host_rescue_row(self, out, j, queries, K, answer=None):
        """Overwrite packed row j with the exact host result for
        queries[j]: `answer` (hits, found) where the caller has it
        (_head_answer), else the oracle's (guard-trip rescue;
        oracle_search_vec is bit-identical to the device's exact path).

        The result is memoized by (query terms, K): guard trips are
        query-shape-deterministic (e.g. a 2-term query of two df~N terms
        whose near-uniform sums the guard provably cannot separate — the
        tools-built corpus trips on the SAME query every time it recurs,
        40-50 ms of host oracle each). A memo hit answers the repeat at
        plan time with zero device work, like the 1-term shortcut memo."""
        hits, found = answer or oracle_search_vec(
            self._oracle_segs(), queries[j], K,
            k1=self.config.bm25.k1, b=self.config.bm25.b,
        )
        out[j, : 2 * K + 1] = 0.0
        scores = np.zeros(K, np.float32)
        slots = np.full(K, 2**30, np.int32)
        for i, (score, seg_idx, doc) in enumerate(hits[:K]):
            out[j, i] = np.float32(score)
            slot = self.doc_bases[seg_idx] + doc
            out[j, K + i] = np.float32(slot)
            scores[i] = np.float32(score)
            slots[i] = slot
        out[j, 2 * K] = np.float32(found)
        live = scores > 0
        memo = self._rescue_memo
        if len(memo) >= 100_000:
            memo.clear()
        memo[(tuple(queries[j]), K)] = QueryResult(
            scores=scores[live], doc_slots=slots[live], found=int(found)
        )

    def _oracle_segs(self):
        """Lazy host-side oracle segment views (guard-trip rescue)."""
        segs = getattr(self, "_oracle_segs_cache", None)
        if segs is None:
            segs = [s.to_oracle_segment() for s in self.segments]
            self._oracle_segs_cache = segs
        return segs

    def _query_windows(self, queries) -> np.ndarray:
        """Per-query summed light dfs (= the query's contiguous run length
        in the flat sorted light array). One lexicon probe; no device
        work."""
        rows_all, _ws, q_lens = _probe_queries_flat(
            self._lex_slices, queries
        )
        ent = self._lex_table[rows_all]
        dfs = np.where(ent[:, 2] < 0, ent[:, 1], 0).astype(np.int64)
        qi = np.repeat(np.arange(len(queries), dtype=np.int64), q_lens)
        w = np.zeros(len(queries), np.int64)
        np.add.at(w, qi, dfs)
        return w

    def _query_postings(self, queries) -> np.ndarray:
        """Per-query postings over all its (term, segment) rows, heavy and
        light: what the host oracle reads for it. One lexicon probe."""
        rows_all, _ws, q_lens = _probe_queries_flat(
            self._lex_slices, queries
        )
        qi = np.repeat(np.arange(len(queries), dtype=np.int64), q_lens)
        out = np.zeros(len(queries), np.int64)
        np.add.at(out, qi, self._lex_table[rows_all, 1].astype(np.int64))
        return out

    def _sel_window(self, light_dfs) -> int:
        """Static selection-window W for this batch (ops/select_pallas.py):
        the max over queries of summed light dfs — one query's contiguous
        run of the flat sorted array — bucketed/pinned like C so serving
        keeps one compiled shape.

        Returns 0 (kernel disabled -> flat-sort selection) unless
        NEXTSEARCH_SELECT_PALLAS=1: measured at the 1M serving point the
        kernel only MATCHES the sort it replaces (9,085 vs 9,209 QPS with
        window-ordered queries; per-iteration scalar overhead and the
        per-query DMA latency eat the scan-volume win), so the sort stays
        the default until the kernel beats it."""
        if os.environ.get("NEXTSEARCH_SELECT_PALLAS", "0") != "1":
            return 0
        w = int(light_dfs.astype(np.int64).sum(axis=-1).max(initial=0))
        return _pick_shape(
            max(w, 1), self.W_BUCKETS,
            self._pin("W", *map(int, light_dfs.shape[-2:])), "W",
        )

    def _chunk_plan(self, starts, dfs, weights, block):
        """Flatten (query, slot) pairs into fixed-size posting chunks.

        Vectorized host planning; the chunk count is padded to a bucket from
        config.device.chunk_buckets so the kernel keeps one static shape.
        """
        Qb, T = starts.shape
        qi, ti = np.nonzero(dfs)
        df = dfs[qi, ti].astype(np.int64)
        reps = (df + block - 1) // block
        total = int(reps.sum())

        C = _pick_shape(
            total, self.config.device.chunk_buckets,
            self._pin("C", Qb, T), "C",
        )

        chunk_start = np.zeros(C, np.int32)
        chunk_len = np.zeros(C, np.int32)
        chunk_q = np.full(C, Qb, np.int32)  # out-of-range row -> dropped
        chunk_w = np.zeros(C, np.float32)
        if total:
            cum = np.cumsum(reps)
            owner = np.searchsorted(cum, np.arange(total), "right")
            within = np.arange(total) - (cum[owner] - reps[owner])
            s_rep = starts[qi, ti].astype(np.int64)[owner]
            df_rep = df[owner]
            chunk_start[:total] = s_rep + within * block
            chunk_len[:total] = np.minimum(block, df_rep - within * block)
            chunk_q[:total] = qi[owner]
            chunk_w[:total] = weights[qi, ti][owner]
        return chunk_start, chunk_len, chunk_q, chunk_w

    # ---------------- result mapping ----------------

    def locate(self, doc_slot: int) -> Tuple[int, int]:
        """Global doc slot -> (segment index, local docId)."""
        seg_idx = int(np.searchsorted(self._doc_bases_np, doc_slot, "right") - 1)
        return seg_idx, int(doc_slot - self.doc_bases[seg_idx])

    @property
    def _doc_bases_np(self) -> np.ndarray:
        arr = getattr(self, "_doc_bases_arr", None)
        if arr is None or arr.shape[0] != len(self.doc_bases):
            arr = np.asarray(self.doc_bases, np.int64)
            self._doc_bases_arr = arr
        return arr

    def doc_info_batch(self, slots: np.ndarray):
        """Vectorized doc_info for one query's hit slots: list of
        (segment name, cord_uid, local docId). The per-hit locate() costs
        one array build + searchsorted each (~5120 calls per 512-query
        render at k=10 — measured as most of the 25 ms render span)."""
        slots = np.asarray(slots, np.int64)
        seg_idx = np.searchsorted(self._doc_bases_np, slots, "right") - 1
        out = []
        for si, slot in zip(seg_idx, slots):
            si = int(si)
            did = int(slot - self.doc_bases[si])
            out.append((self.seg_names[si], self.segments[si].cord_uids[did], did))
        return out

    def doc_info(self, doc_slot: int) -> Tuple[str, str, int]:
        """Global doc slot -> (segment name, cord_uid, local docId)."""
        seg_idx, doc_id = self.locate(doc_slot)
        return self.seg_names[seg_idx], self.segments[seg_idx].cord_uids[doc_id], doc_id
