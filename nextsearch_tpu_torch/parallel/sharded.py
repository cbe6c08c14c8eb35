"""Sharded multi-segment BM25 over a (dp, seg) mesh of torch devices (port
of nextsearch_tpu/parallel/sharded.py).

Segments are grouped into `seg`-axis shards, each holding its own posting
arrays, dense rows and doc slots; the query batch is split over the `dp`
axis. Each (dp group, shard) local step scores its shard with the
single-device kernels (sparse: ops/bm25_sparse.packed_impl, the production
launch; exact: score_only_exact; fused: the scatter + heavy product +
exact rescore of ops/bm25.py; both count found with score_epilogue),
takes a local top-k, and the shards' candidate lists are merged per
group: the reference's all_gather is a copy of each shard's [Qd, k2]
candidates to the group's first device and a cat, its psum of `found` a
sum and its pmin of the fast path's guard a min, followed by one
canonical (score desc, global slot asc) sort. One Python
process holds the mesh, plans each batch and launches every local step on
its device (the reference is a single controller too: one process, one
shard_map step over every device).

Doc-slot layout: global slot = shard_id * shard_capacity + local slot, with
shards holding contiguous segment ranges in order, so ties still break in
the canonical (segment asc, docId asc) order after the merge.

Device placement: shard s's tensors live on every distinct device of mesh
column s (built on the column's first device, copied to the others); the
packed result of each group lands on its first device and the groups are
concatenated on mesh.devices[0][0] (self.device), where the hybrid rerank
and the host copy read it.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..index.builder import SegmentArrays, eager_scores
from ..index.device_build import build_heavy_on_device
from ..index.oracle import oracle_search_vec
from ..index.planner import (
    QueryResult,
    SparsePlanner,
    WeightedTerm,
    _bucket,
    _pick_shape,
    _probe_queries_flat,
    _round_up,
)
from ..index.segment import _HostCopy, _upload, warm_launches
from ..ops.bm25 import (
    PAD_DOC,
    canonical_sort,
    exact_rescore,
    expand_chunks,
    heavy_scores,
    scatter_scores,
    score_only_exact,
    tiled_topk,
    topk_low_index,
)
from ..ops.bm25_sparse import LIGHT_BUCKET_LOG2, packed_impl, two_level_sort2
from ..ops.graphs import LaunchCache
from ..ops.score_kernels import score_epilogue
from ..utils.logging import log
from ..utils.profiling import GLOBAL_TRACER
from .mesh import Mesh


@dataclass
class _Tables:
    """One shard's device tensors on one device."""

    post_doc: torch.Tensor  # int32 [P_shard] shard-local doc slots
    post_score: torch.Tensor  # f32 [P_shard]
    dense_rows: torch.Tensor  # f32 or bf16 [h_rows, shard_capacity]
    bucket_pos: Optional[torch.Tensor]  # int32 [h_rows, NBh + 1] (bf16 rows)
    light_bucket_pos: Optional[torch.Tensor]  # int32 [NL + 1, NBl + 1]

    def to(self, device: torch.device) -> "_Tables":
        return _Tables(*(None if t is None else t.to(device) for t in (
            self.post_doc, self.post_score, self.dense_rows, self.bucket_pos,
            self.light_bucket_pos)))


def _on(device: torch.device):
    """Make `device` current while a local step launches (the CUDA kernels
    launch on the current device's stream)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def local_step(tab: _Tables, pi: torch.Tensor, *, mode: str, T: int, U: int,
               n_slots: int, K: int, K2: int, C: int, block: int,
               bs_steps: int, nd: int, nl: int, use_compact: bool,
               heavy_direct: bool, fast_heavy: bool, guard_eps: float,
               L2: int, H2: int, two_level: bool = False, max_df=None):
    """One (dp group, shard) step of the reference's _sharded_search_fn
    local_step: returns (vals f32 [Qd, k2], local doc slots int [Qd, k2],
    found int [Qd], the fast path's guard column f32 [Qd] or None).

    pi is the group's rows of this shard's plan, int32 [Qd, L]:
      sparse: L = 7T, packed_impl's seven plan rows per query
      exact / fused: L = 4T + 2U  starts | dfs | light_dfs | weight bits |
              heavy-mix bits | unique heavy ids (the group's first row)"""
    Qd = pi.shape[0]
    guard = None
    if mode == "sparse":
        # the shard-local step IS the single-device production launch over
        # local doc slots (the compact row gather + K1, or K1 over the full
        # table, the light chain, the compact rescore)
        plan7 = pi.reshape(Qd, 7, T).permute(1, 0, 2).contiguous()
        out = packed_impl(
            tab.post_doc, tab.post_score, tab.dense_rows,
            tab.light_bucket_pos, plan7, n_slots=n_slots, K=K, K2=K2, C=C,
            block=block, bs_steps=bs_steps, nd=nd, nl=nl, U=U,
            use_compact=use_compact, heavy_direct=heavy_direct,
            fast_heavy=fast_heavy, guard_eps=guard_eps, L2=L2, H2=H2,
            bucket_pos=tab.bucket_pos, two_level=two_level,
        )
        vals = out[:, :K]
        idx = out[:, K:2 * K].to(torch.int32)
        found = out[:, 2 * K].to(torch.int32)
        if fast_heavy:
            guard = out[:, 2 * K + 1]
        return vals, idx, found, guard
    starts = pi[:, :T]
    dfs = pi[:, T:2 * T]
    weights = pi[:, 3 * T:4 * T].contiguous().view(torch.float32)
    if mode == "exact":
        scores = score_only_exact(tab.post_doc, tab.post_score, starts, dfs,
                                  weights, n_slots=n_slots, block=block,
                                  max_df=max_df)
        found, _ = score_epilogue(scores, tiles=False)
        vals, idx = topk_low_index(scores, min(K, n_slots))
    else:
        light_dfs = pi[:, 2 * T:3 * T]
        heavy_mix = pi[:, 4 * T:4 * T + U].contiguous().view(torch.float32)
        unique_heavy = pi[0, 4 * T + U:]
        chunks = expand_chunks(starts, light_dfs, weights, C=C, block=block)
        scores = scatter_scores(tab.post_doc, tab.post_score, *chunks, Q=Qd,
                                n_slots=n_slots, block=block)
        # the add, found and the tile maxima in one pass, as the fused launch
        found, tile_max = score_epilogue(
            scores, heavy_scores(tab.dense_rows, unique_heavy, heavy_mix))
        _fv, idx = tiled_topk(scores, min(K2, n_slots), tile_max=tile_max)
        exact = exact_rescore(tab.post_doc, tab.post_score, starts, dfs,
                              weights, idx)
        vals, idx = canonical_sort(exact, idx)
    return vals, idx, found, guard


def graphed_step(pi: torch.Tensor, *, post_doc, post_score, dense_rows,
                 bucket_pos, light_bucket_pos, **statics):
    """local_step with the shard's tables given one by one and its guard
    left out where there is none: the form a launch cache keys (the tables
    by address) and captures (tensors only)."""
    out = local_step(_Tables(post_doc, post_score, dense_rows, bucket_pos,
                             light_bucket_pos), pi, **statics)
    return out if out[3] is not None else out[:3]


def _to_merge(t: torch.Tensor, dst: torch.device) -> torch.Tensor:
    """A shard's candidates on the merge device. On another card the copy
    is ordered after the source stream's work by an event (PyTorch's
    cross-device copy syncs the two current streams as well); on one card,
    or on the CPU, the tensor is already there and nothing is copied."""
    if t.device == dst:
        return t
    if t.device.type == "cuda" and dst.type == "cuda":
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        torch.cuda.current_stream(dst).wait_event(ev)
    return t.to(dst)


def merge_shards(parts, *, n_slots: int, K: int, dst: torch.device):
    """The merge of the reference's local_step over the seg axis: shard
    s's live candidates get global slots s * n_slots + local (dead ones
    2^30); with more than one shard the candidates are gathered onto `dst`,
    re-ranked canonically, `found` summed and the guard min-reduced. One
    packed f32 [Qd, 2 k_out + 1 (+ guard)] result, k_out = min(K, S * k2)."""
    S = len(parts)
    gidx = []
    for s, (vals, idx, _f, _g) in enumerate(parts):
        gidx.append(torch.where(
            vals > 0, idx.to(torch.int32) + s * n_slots,
            torch.full_like(idx, PAD_DOC, dtype=torch.int32)))
    k2 = parts[0][0].shape[1]
    guard = parts[0][3]
    if S > 1:
        cat_vals = torch.cat([_to_merge(p[0], dst) for p in parts], dim=1)
        cat_idx = torch.cat([_to_merge(g, dst) for g in gidx], dim=1)
        mvals, midx = canonical_sort(cat_vals, cat_idx)
        found = _to_merge(parts[0][2], dst)
        for p in parts[1:]:
            found = found + _to_merge(p[2], dst)
        if guard is not None:
            # each shard's guard proves its own exclusions; the merged top K
            # is proven iff every shard's guard passed
            guard = torch.stack([_to_merge(p[3], dst) for p in parts]).amin(0)
    else:
        mvals, midx, found = parts[0][0], gidx[0], parts[0][2]
    k_out = min(K, S * k2)
    cols = [mvals[:, :k_out], midx[:, :k_out].to(torch.float32),
            found[:, None].to(torch.float32)]
    if guard is not None:
        cols.append(guard[:, None])
    return torch.cat(cols, dim=1)


class ShardedIndex:
    """Multi-segment index sharded over a (dp, seg) mesh.

    Segments are assigned to seg-shards by contiguous ranges (shard i gets
    segments [cuts[i], cuts[i+1])), balanced by doc count. Every shard's
    dense table has the same row count (n_dense + 1, the sentinel row n_dense
    zero) and its light table n_light + 1 rows, so one plan's sentinels mean
    the same on every shard."""

    T_BUCKETS = (4, 8, 16, 32, 64, 128, 256)
    K_BUCKETS = (10, 32, 100)
    L_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)
    HP_BUCKETS = (128, 256, 512, 1024, 2048, 4096, 8192)

    def __init__(
        self,
        segments: Sequence[SegmentArrays],
        mesh: Mesh,
        seg_names: Optional[Sequence[str]] = None,
        config: EngineConfig = DEFAULT_CONFIG,
    ):
        dcfg = config.device
        if dcfg.mode not in ("fused", "exact", "fast", "sparse"):
            raise ValueError(f"unknown device mode {dcfg.mode!r}")
        # the heavy product and the plain kernels are f32 matmuls: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        t0 = time.perf_counter()
        self.config = config
        self.mesh = mesh
        self.device = mesh.devices[0][0]
        self.segments = list(segments)
        self.seg_names = list(seg_names) if seg_names else [
            f"seg_{i + 1:06d}" for i in range(len(self.segments))
        ]
        self.dp = mesh.shape["dp"]
        self.n_shards = mesh.shape["seg"]
        S = self.n_shards
        self.rescue_ms = 0.0
        self.rescue_trips = 0
        self.relaunches = 0  # batches re-run exactly after a guard trip
        # one launch cache per distinct mesh device: each (dp group,
        # shard) step of the sparse and fused modes replays its graph
        self.launch_caches: Dict[torch.device, LaunchCache] = {}
        for row in mesh.devices:
            for d in row:
                if d not in self.launch_caches:
                    self.launch_caches[d] = LaunchCache(d)

        # Contiguous segment ranges per shard, balanced by doc count.
        n_segs = len(self.segments)
        doc_counts = [s.N for s in self.segments]
        total_docs = sum(doc_counts)
        cuts = [0]
        acc = 0
        for i, c in enumerate(doc_counts):
            acc += c
            # close the shard when it reached its fair share (keep S ranges)
            while len(cuts) < S and acc >= total_docs * len(cuts) / S and i + 1 <= n_segs:
                cuts.append(i + 1)
        while len(cuts) < S:
            cuts.append(n_segs)
        cuts.append(n_segs)
        self.shard_seg_ranges = [(cuts[i], cuts[i + 1]) for i in range(S)]

        # Per-shard layouts. lex value: term -> (local posting start, df,
        # dense_row_id or -1)
        self.shard_doc_bases: List[List[int]] = []
        self.lex: List[List[dict]] = []
        shard_docs: List[int] = []
        for lo, hi in self.shard_seg_ranges:
            dbase = 0
            pbase = 0
            bases = []
            lexes = []
            for seg in self.segments[lo:hi]:
                bases.append(dbase)
                offs = seg.term_offsets
                lexes.append({t: (pbase + int(offs[i]), int(seg.term_df[i]), -1)
                              for i, t in enumerate(seg.terms)})
                dbase += seg.N
                pbase += seg.num_postings
            self.shard_doc_bases.append(bases)
            self.lex.append(lexes)
            shard_docs.append(dbase)

        dpad = dcfg.doc_pad
        self._sparse = dcfg.mode == "sparse"
        if self._sparse:
            # the heavy kernels tile the doc axis in 2048-doc tiles
            dpad = _round_up(dpad, 2048)
        self.shard_capacity = max(_round_up(max(shard_docs or [1], default=1), dpad), dpad)
        if S * self.shard_capacity >= 1 << 24:
            # the packed result carries global doc slots as exact f32 values
            raise ValueError(
                f"global slot space {S}x{self.shard_capacity} exceeds the "
                "2^24 exact-f32 packed-transport bound; use more/larger "
                "shards or raise doc_pad granularity"
            )

        # host postings per shard, local doc slots
        post_doc_h: List[np.ndarray] = []
        post_score_h: List[np.ndarray] = []
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            docs, scores = [], []
            for j, seg in enumerate(self.segments[lo:hi]):
                docs.append(seg.post_doc.astype(np.int64) + self.shard_doc_bases[si][j])
                sc = seg.post_score
                if sc is None:
                    sc = eager_scores(seg, k1=config.bm25.k1, b=config.bm25.b)
                scores.append(np.asarray(sc, np.float32))
            pd = np.concatenate(docs).astype(np.int32) if docs else np.zeros(0, np.int32)
            ps = np.concatenate(scores) if scores else np.zeros(0, np.float32)
            if pd.size == 0:  # a shard with no postings keeps one dead lane
                pd, ps = np.zeros(1, np.int32), np.zeros(1, np.float32)
            post_doc_h.append(pd)
            post_score_h.append(ps)

        # Dense rows for heavy terms. With f32 rows (sparse mode) the
        # rescore reads heavy scores straight off the dense rows, which
        # allows MERGED rows: classify by shard-global df and write every
        # segment's postings for the term into ONE row (a doc lives in one
        # segment; the others contribute +0.0f). bf16 rows and the other
        # modes keep one row per (term, segment).
        self.dense_threshold = (
            max(1, int(self.shard_capacity * dcfg.dense_df_ratio))
            if dcfg.dense_df_ratio > 0
            else (1 << 62)
        )
        self._heavy_direct = self._sparse and not dcfg.dense_rows_bf16
        row_bytes = (2 if dcfg.dense_rows_bf16 else 4) * self.shard_capacity
        row_cap = min(dcfg.dense_max_rows,
                      max(0, int(dcfg.dense_max_bytes // row_bytes)))
        # per shard: scatter units (row_id, seg_j, term_i), many-to-one onto
        # rows when merged
        per_shard_entries: List[List[Tuple[int, int, int]]] = []
        per_shard_rows: List[int] = []
        # shard-global df per merged heavy term (the planning table's df
        # column for merged entries, and the 1-term shortcut's `found`)
        self._gdf_shard: List[Dict[str, int]] = []
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            if self._heavy_direct:
                gdf: Dict[str, int] = {}
                where: Dict[str, List[Tuple[int, int]]] = {}
                for j, seg in enumerate(self.segments[lo:hi]):
                    for i in np.flatnonzero(seg.term_df > 0):
                        t = seg.terms[i]
                        gdf[t] = gdf.get(t, 0) + int(seg.term_df[i])
                        where.setdefault(t, []).append((j, int(i)))
                heavy_terms = sorted(
                    ((d, t) for t, d in gdf.items() if d >= self.dense_threshold),
                    reverse=True,
                )[:row_cap]
                entries = [(row_id, j, i)
                           for row_id, (_d, t) in enumerate(heavy_terms)
                           for j, i in where[t]]
                per_shard_rows.append(len(heavy_terms))
                self._gdf_shard.append({t: d for d, t in heavy_terms})
            else:
                heavy = []
                for j, seg in enumerate(self.segments[lo:hi]):
                    for i in np.flatnonzero(seg.term_df >= self.dense_threshold):
                        heavy.append((int(seg.term_df[i]), j, int(i)))
                heavy.sort(reverse=True)
                heavy = heavy[:row_cap]
                entries = [(row_id, j, i) for row_id, (_df, j, i) in enumerate(heavy)]
                per_shard_rows.append(len(heavy))
                self._gdf_shard.append({})
            per_shard_entries.append(entries)
            for row_id, j, i in entries:
                term = self.segments[lo + j].terms[i]
                start, dfv, _ = self.lex[si][j][term]
                self.lex[si][j][term] = (start, dfv, row_id)
        self.n_dense = max(per_shard_rows, default=0)
        self.per_shard_rows = per_shard_rows
        h_rows = self.n_dense + 1
        if self._sparse:
            # padded to 8 rows as TorchIndex's table is, so that the
            # full-table K1 launch meets the same table shapes on either
            # index (pad rows are zero; no plan references them)
            h_rows = _round_up(h_rows, 8)

        # light rows and their bucket counts (sparse mode)
        self._light_row: List[List[dict]] = []
        self.n_light = 0
        light_counts: List[np.ndarray] = []
        max_occ = 0
        if self._sparse:
            nbl = (self.shard_capacity + (1 << LIGHT_BUCKET_LOG2) - 1) >> LIGHT_BUCKET_LOG2
            for si in range(S):
                maps, counts = self._light_rows(si, post_doc_h[si], nbl)
                self._light_row.append(maps)
                light_counts.append(counts)
                max_occ = max(max_occ, int(counts.max(initial=0)))
            self.n_light = max((c.shape[0] for c in light_counts), default=0)

        # device tables, shard by shard, on each distinct device of its
        # mesh column
        self._tables: List[Dict[torch.device, _Tables]] = []
        bucket_occ = 0
        for si, (lo, _hi) in enumerate(self.shard_seg_ranges):
            col = []
            for g in range(self.dp):
                if mesh.devices[g][si] not in col:
                    col.append(mesh.devices[g][si])
            dev = col[0]
            pd = torch.as_tensor(post_doc_h[si], device=dev)
            ps = torch.as_tensor(post_score_h[si], device=dev)
            entries = per_shard_entries[si]
            h_starts = [self.lex[si][j][self.segments[lo + j].terms[i]][0]
                        for _r, j, i in entries]
            h_dfs = [int(self.segments[lo + j].term_df[i]) for _r, j, i in entries]
            dense, buckets, occ = build_heavy_on_device(
                pd, ps, h_starts, h_dfs, rows=[r for r, _j, _i in entries],
                n_rows_pad=h_rows, n_slots=self.shard_capacity,
                bf16=dcfg.dense_rows_bf16,
                with_buckets=self._sparse and not self._heavy_direct,
            )
            bucket_occ = max(bucket_occ, occ)
            light = None
            if self._sparse:
                table = np.zeros((self.n_light + 1, nbl + 1), np.int32)
                cnt = light_counts[si]
                if cnt.shape[0]:
                    np.cumsum(cnt, axis=1, out=table[:cnt.shape[0], 1:])
                light_counts[si] = None
                light = torch.as_tensor(table, device=dev)
            tab = _Tables(pd, ps, dense, buckets, light)
            self._tables.append({d: (tab if d == dev else tab.to(d)) for d in col})
        if self.device.type == "cuda":
            for row in mesh.devices:
                for d in set(row):
                    torch.cuda.synchronize(d)
        self._bs_depth = max(2, int(max(max_occ, bucket_occ, 1)).bit_length())
        self.n_docs = total_docs
        # Pinned static shapes (pin_shapes): {"T","Q","C","U","L","HP"}.
        self._pins: Dict[str, int] = {}
        # Per-Q-envelope pins (pin_shapes(scope_q=True)): Qb -> {C,U,L,HP}.
        self._qpins: Dict[int, Dict[str, int]] = {}
        # (Qb, T) -> pins: the planner's _pin reads it; this pin_shapes
        # scopes by Q only, so it stays empty
        self._tpins: Dict[Tuple[int, int], Dict[str, int]] = {}
        # (term, k) -> QueryResult|None for w==1 1-term shortcut answers
        self._shortcut_memo: Dict = {}
        self._build_row_topk(post_doc_h, post_score_h, per_shard_entries)
        self._build_light_topk(post_doc_h, post_score_h)
        self._build_merged_lex()
        log("sharded", f"mesh {self.dp}x{S}: shards {self.shard_seg_ranges} "
            f"capacity {self.shard_capacity} n_dense {per_shard_rows} "
            f"n_light {self.n_light} built in {time.perf_counter() - t0:.1f}s")

    def _light_rows(self, si: int, post_doc: np.ndarray, nbl: int):
        """Shard si's light rows: one per (segment, term) with df > 0 and no
        dense row, numbered in (segment, term) order. Returns ([segment's
        term -> row], posting counts int32 [rows, nbl] per 2^9-slot bucket)."""
        lo, hi = self.shard_seg_ranges[si]
        maps = []
        parts = []
        base_row = 0
        pbase = 0
        for j, seg in enumerate(self.segments[lo:hi]):
            lex = self.lex[si][j]
            dense_ids = np.asarray([lex[t][2] for t in seg.terms], np.int64)
            lt_idx = np.flatnonzero((seg.term_df > 0) & (dense_ids < 0))
            term_row = np.full(len(seg.terms), -1, np.int64)
            term_row[lt_idx] = np.arange(lt_idx.shape[0])
            maps.append({seg.terms[i]: base_row + int(term_row[i]) for i in lt_idx})
            cnt = np.zeros((lt_idx.shape[0], nbl), np.int32)
            if lt_idx.shape[0]:
                row_of_post = np.repeat(term_row, seg.term_df.astype(np.int64))
                valid = row_of_post >= 0
                bucket = post_doc[pbase:pbase + seg.num_postings][valid].astype(
                    np.int64) >> LIGHT_BUCKET_LOG2
                # (row, bucket) keys are non-decreasing: counts are run
                # lengths
                key = row_of_post[valid] * nbl + bucket
                if key.size:
                    change = np.flatnonzero(key[1:] != key[:-1])
                    first = np.concatenate(([0], change + 1))
                    ends = np.concatenate((change + 1, [key.size]))
                    cnt.reshape(-1)[key[first]] = (ends - first).astype(np.int32)
            parts.append(cnt)
            base_row += lt_idx.shape[0]
            pbase += seg.num_postings
        counts = (np.concatenate(parts, axis=0) if parts
                  else np.zeros((0, nbl), np.int32))
        return maps, counts

    def _build_row_topk(self, post_doc_h, post_score_h, per_shard_entries) -> None:
        """Exact canonical top-k of the df-head dense rows, per shard, from
        the shard's host postings (a merged row's nonzero values ARE its
        term's posting scores across the shard's segments).

        A 1-term query on a term that is heavy in EVERY shard it touches is
        a pure function of its rows, answered host-side with no device work
        and no fast-path guard trips. Canonical (score desc, slot asc) tie
        order is exact: positive f32 score bit patterns are order-isomorphic
        to uint32, and local slots fit 24 bits, so one uint64 key
        (score_bits << 24 | ~slot) makes the top k tie-free. Rows with
        fewer than k postings pad with score 0 and slot 2^30."""
        self._row_topk = None
        dcfg = self.config.device
        if not (self._sparse and self._heavy_direct):
            return
        k = min(dcfg.row_topk_k, self.shard_capacity)
        if dcfg.row_topk_rows <= 0 or k <= 0:
            return
        slot_mask = np.uint64((1 << 24) - 1)
        per_shard: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
        for si, entries in enumerate(per_shard_entries):
            n = min(self.per_shard_rows[si], dcfg.row_topk_rows)
            if n <= 0:
                per_shard.append(None)
                continue
            lo = self.shard_seg_ranges[si][0]
            ranges: List[List[Tuple[int, int]]] = [[] for _ in range(n)]
            for row_id, j, i in entries:
                if row_id < n:
                    seg = self.segments[lo + j]
                    ranges[row_id].append((self.lex[si][j][seg.terms[i]][0],
                                           int(seg.term_df[i])))
            vals = np.zeros((n, k), np.float32)
            slots = np.full((n, k), PAD_DOC, np.int32)
            for row_id, rr in enumerate(ranges):
                pos = np.concatenate([np.arange(s, s + d, dtype=np.int64)
                                      for s, d in rr])
                sc = post_score_h[si][pos]
                doc = post_doc_h[si][pos].astype(np.uint64)
                key = (sc.view(np.uint32).astype(np.uint64) << np.uint64(24)) | (
                    slot_mask - doc)
                if key.shape[0] > k:
                    part = np.argpartition(key, key.shape[0] - k)[-k:]
                    key, sc, doc = key[part], sc[part], doc[part]
                order = np.argsort(key)[::-1]  # key desc = canonical
                m = order.shape[0]
                vals[row_id, :m] = sc[order]
                slots[row_id, :m] = doc[order].astype(np.int32)
            per_shard.append((vals, slots))
        if any(p is not None for p in per_shard):
            self._row_topk = per_shard

    def _build_light_topk(self, post_doc_h, post_score_h) -> None:
        """Exact canonical top-k per light (term, segment) posting range,
        per shard, slots stored LOCAL (globalized when served). One uint64
        key per posting, row above the inverted positive-f32 score bits,
        and a stable sort: ties keep posting order, doc ascending within a
        row, so the order is canonical (score desc, slot asc)."""
        self._light_topk = None
        dcfg = self.config.device
        kl = dcfg.light_topk_k
        if not self._sparse or kl <= 0 or self.n_light == 0:
            return
        kl = min(kl, self.shard_capacity)
        vals = np.zeros((self.n_shards, self.n_light, kl), np.float32)
        slots = np.full((self.n_shards, self.n_light, kl), PAD_DOC, np.int32)
        for si in range(self.n_shards):
            items = []  # (row, local start, df)
            for j, lmap in enumerate(self._light_row[si]):
                lex = self.lex[si][j]
                items.extend((row, lex[t][0], lex[t][1]) for t, row in lmap.items())
            if not items:
                continue
            items.sort()
            arr = np.asarray(items, np.int64)
            rows_arr, starts, dfs = arr[:, 0], arr[:, 1], arr[:, 2]
            total = int(dfs.sum())
            if total == 0:
                continue
            cum = np.cumsum(dfs)
            rep = np.repeat(np.arange(len(items), dtype=np.int64), dfs)
            pos = np.arange(total, dtype=np.int64) - np.repeat(cum - dfs, dfs) + starts[rep]
            sc = np.ascontiguousarray(post_score_h[si][pos], np.float32)
            doc = post_doc_h[si][pos]
            key = (rep.astype(np.uint64) << np.uint64(32)) | (
                ~sc.view(np.uint32)).astype(np.uint64)
            order = np.argsort(key, kind="stable")  # row asc, score desc
            take = np.minimum(dfs, kl)
            sel_rows = np.repeat(np.arange(len(items)), take)
            within = np.arange(int(take.sum())) - np.repeat(np.cumsum(take) - take, take)
            src = order[(cum - dfs)[sel_rows] + within]
            vals[si, rows_arr[sel_rows], within] = sc[src]
            slots[si, rows_arr[sel_rows], within] = doc[src]
        self._light_topk = (vals, slots)

    # The 1-term shortcut's loop over queries, the pin lookup, the oracle
    # views and the blocking search are the single-device planner's own.
    _shortcut_single_heavy = SparsePlanner._shortcut_single_heavy
    _pin = SparsePlanner._pin
    _oracle_segs = SparsePlanner._oracle_segs
    search_batch = SparsePlanner.search_batch

    def _shortcut_compute(self, t, w32, k, lt):
        """One term's host-side 1-term answer from the per-shard tables, or
        None for the kernel path.

        Eligible terms are heavy (merged dense row inside the precomputed
        head) in EVERY shard occurrence, or light in every one (exact for k
        <= light_topk_k); mixed terms keep the kernel path. `found` is the
        sum of shard-global dfs (a doc lives in one shard). The merged
        top-k of per-shard canonical prefixes stays exact and canonical:
        scores merge by (score desc, GLOBAL slot asc), the merge's tie
        order. For w != 1 the multiply may collapse distinct f32 values;
        an incomplete prefix must then keep its k-th value strictly above
        its stored tail."""
        rt = self._row_topk
        oc = self._lex_slices.get(t)
        if oc is None:
            return None
        cap = self.shard_capacity
        ent = self._lex_table[oc[0]: oc[0] + oc[1]]
        d3 = ent[:, 3]
        heavy_all = bool((d3 >= 0).all())
        light_all = not heavy_all and bool((d3 < 0).all())
        if not ((heavy_all and rt is not None) or (light_all and lt is not None)):
            return None  # mixed classification -> kernel path
        sv_all = []
        gs_all = []
        found = 0
        for si, _st, df, row, lrow in ent:
            if heavy_all:
                pt = rt[si]
                if pt is None or row >= pt[0].shape[0]:
                    return None
                vals, slots = pt[0][row], pt[1][row]
                df_cover = 0  # row prefix may be incomplete either way
            else:
                vals_l, slots_l = lt
                if lrow >= self.n_light:
                    return None
                vals, slots = vals_l[si, lrow], slots_l[si, lrow]
                df_cover = int(df)  # df <= width => prefix complete
            kp = vals.shape[0]
            if k > kp:
                return None
            sv = vals if w32 == np.float32(1.0) else w32 * vals
            if (
                w32 != np.float32(1.0)
                and not 0 < df_cover <= kp
                and not sv[min(k, kp) - 1] > sv[-1]
            ):
                return None  # multiply collapsed the prefix boundary
            sv_all.append(sv)
            gs_all.append(slots if si == 0 else slots.astype(np.int64) + si * cap)
            found += int(df)
        if len(sv_all) == 1 and w32 == np.float32(1.0):
            # a single stored prefix is already canonical
            sv, gs = sv_all[0], gs_all[0]
        else:
            sv = np.concatenate(sv_all)
            gs = np.concatenate(gs_all)
            order = np.lexsort((gs, -sv))
            sv = sv[order]
            gs = gs[order]
        live = sv > 0
        return QueryResult(
            scores=sv[live][:k].astype(np.float32),
            doc_slots=gs[live][:k].astype(np.int32),
            found=found,
        )

    def _build_merged_lex(self) -> None:
        """Merge all shard lexicons into one packed planning table.

        _lex_slices: term -> (offset, count) into _lex_table rows of
        (shard, local posting start, df, dense_row_id, light_row_id),
        ordered (shard asc, segment asc) per term, matching the canonical
        slot order. light_row_id indexes the shard's light table rows
        (n_light for heavy slots / non-sparse). Planning then costs one
        dict probe per (query, term) plus numpy gathers."""
        nl = self.n_light
        merged = self._heavy_direct
        occ: Dict[str, List[Tuple[int, int, int, int, int]]] = {}
        for si, shard_lexes in enumerate(self.lex):
            lmaps = self._light_row[si] if self._light_row else None
            seen_heavy: set = set()
            for j, lex in enumerate(shard_lexes):
                lmap = lmaps[j] if lmaps else {}
                for t, v in lex.items():
                    if v[1] > 0:
                        df = v[1]
                        if merged and v[2] >= 0:
                            # merged dense row: ONE planning slot per (term,
                            # shard), whose df column carries the shard-global
                            # df (the kernel never reads heavy dfs)
                            if t in seen_heavy:
                                continue
                            seen_heavy.add(t)
                            df = self._gdf_shard[si].get(t, df)
                        occ.setdefault(t, []).append(
                            (si, v[0], df, v[2], lmap.get(t, nl)))
        n_rows = sum(len(v) for v in occ.values())
        table = np.zeros((max(n_rows, 1), 5), np.int64)
        slices: Dict[str, Tuple[int, int]] = {}
        pos = 0
        for t, vs in occ.items():
            slices[t] = (pos, len(vs))
            table[pos:pos + len(vs)] = vs
            pos += len(vs)
        self._lex_table = table
        self._lex_slices = slices

    # ---------------- common index interface ----------------
    # (shared with index.segment.TorchIndex so Engine/HybridIndex code works
    #  against either)

    def iter_lexicons(self):
        """Yield every per-segment lexicon dict across all shards."""
        for shard_lexes in self.lex:
            yield from shard_lexes

    @property
    def slot_capacity(self) -> int:
        """Size of the global doc-slot space (shard-major layout)."""
        return self.n_shards * self.shard_capacity

    def segment_slot_bases(self) -> List[int]:
        """Global doc-slot base per segment, aligned with self.segments."""
        bases = [0] * len(self.segments)
        for si, (lo, hi) in enumerate(self.shard_seg_ranges):
            for j in range(hi - lo):
                bases[lo + j] = si * self.shard_capacity + self.shard_doc_bases[si][j]
        return bases

    # ---------------- planning ----------------

    def _flatten_probe(self, queries):
        """Shared vectorized front half of both planners.

        Returns (ent, w, qi, slot, T, Qb) over ALL (query, term-slot,
        shard-occurrence) triples flattened: ent = merged-table rows [n, 5],
        w = weights, qi = query index, slot = per-(query, shard) term-slot
        rank (term order then shard-asc occurrence order, the canonical slot
        layout), T/Qb the static plan shapes."""
        S = self.n_shards
        rows, w, q_lens = _probe_queries_flat(self._lex_slices, queries)
        qi = np.repeat(np.arange(len(queries), dtype=np.int64), q_lens)
        ent = self._lex_table[rows]
        sid = ent[:, 0]

        # rank within each (query, shard) group, preserving flat order
        key = qi * S + sid
        order = np.argsort(key, kind="stable")
        ks = key[order]
        grp_first = np.concatenate([[True], ks[1:] != ks[:-1]])
        grp_start = np.where(grp_first, np.arange(ks.shape[0]), 0)
        np.maximum.accumulate(grp_start, out=grp_start)
        slot = np.empty(ks.shape[0], np.int64)
        slot[order] = np.arange(ks.shape[0]) - grp_start

        t_max = int(slot.max()) + 1 if slot.shape[0] else 1
        Qb = _round_up(max(len(queries), 1), self.dp)
        if self._pins.get("Q"):
            Qb = _round_up(max(Qb, 1), self._pins["Q"])
        T = _pick_shape(t_max, self.T_BUCKETS, self._pin("T", Qb), "T")
        # occurrences past T slots are dropped
        keep = slot < T
        if not keep.all():
            ent, w, qi, slot = ent[keep], w[keep], qi[keep], slot[keep]
        return ent, w, qi, slot, T, Qb

    def plan(self, queries: Sequence[Sequence[WeightedTerm]]):
        """Per-shard padded term-slot plans + hybrid split.

        Returns (starts, dfs, weights, light_dfs) of shape [S, Qb, T] plus
        (unique_heavy [S, DP, U], heavy_mix [S, DP, Qd, U]) with dp-LOCAL
        query rows (the Qb axis splits into DP contiguous groups)."""
        S = self.n_shards
        ent, w, qi, slot, T, Qb = self._flatten_probe(queries)
        Qd = Qb // self.dp
        sid = ent[:, 0]

        starts = np.zeros((S, Qb, T), np.int32)
        dfs = np.zeros((S, Qb, T), np.int32)
        weights = np.zeros((S, Qb, T), np.float32)
        light_dfs = np.zeros((S, Qb, T), np.int32)
        dense = ent[:, 3]
        light = dense < 0
        starts[sid, qi, slot] = ent[:, 1]
        dfs[sid, qi, slot] = ent[:, 2]
        weights[sid, qi, slot] = w
        light_dfs[sid, qi, slot] = np.where(light, ent[:, 2], 0)

        hb = self.config.device.heavy_buckets
        hm = ~light
        h_si = sid[hm]
        h_g, h_lq = np.divmod(qi[hm], Qd)
        h_id = ent[hm, 3]
        h_w = w[hm]
        if h_id.shape[0]:
            # unique dense ids per (shard, group), ranked within the group
            key = (h_si * self.dp + h_g) * (self.n_dense + 1) + h_id
            uniq_key, inv = np.unique(key, return_inverse=True)
            uk_sg, uk_id = divmod(uniq_key, self.n_dense + 1)
            grp_first = np.concatenate([[True], uk_sg[1:] != uk_sg[:-1]])
            grp_start = np.where(grp_first, np.arange(uk_sg.shape[0]), 0)
            np.maximum.accumulate(grp_start, out=grp_start)
            u_slot = np.arange(uniq_key.shape[0]) - grp_start
            u_max = int(u_slot.max()) + 1
        else:
            u_max = 0
        U = _pick_shape(u_max, hb, self._pin("U", Qb), "U")
        unique_heavy = np.full((S, self.dp, U), self.n_dense, np.int32)
        heavy_mix = np.zeros((S, self.dp, Qd, U), np.float32)
        if h_id.shape[0]:
            uk_s, uk_g = divmod(uk_sg, self.dp)
            unique_heavy[uk_s, uk_g, u_slot] = uk_id
            np.add.at(heavy_mix, (h_si, h_g, h_lq, u_slot[inv]), h_w)
        return starts, dfs, weights, light_dfs, unique_heavy, heavy_mix

    def plan_sparse(self, queries: Sequence[Sequence[WeightedTerm]]):
        """Sparse-mode per-shard plan in the single-device row layout.

        Returns (plan [S, Qb, 7T] int32, U). Per query the 7 contiguous
        T-column sections are the single-device plan rows: starts /
        light_dfs / slot_dense (n_dense = light/padding) / slot_light
        (light table row; n_light = heavy/padding) / slot_compact (compact
        mix column; U = light/padding) / weight f32 bit patterns / unique
        dense row ids (row-major, the first n_uniq of each (shard, dp
        group)'s [Qd, T] block; sentinel n_dense), so the local step runs
        the single-device packed_impl. U is the static compact-table size:
        max unique dense rows over (shard, dp group), sized by the
        heavy_buckets ladder / the "U" pin."""
        S = self.n_shards
        ent, w, qi, slot, T, Qb = self._flatten_probe(queries)
        sid = ent[:, 0]
        Qd = Qb // self.dp
        nd = self.n_dense

        starts = np.zeros((S, Qb, T), np.int32)
        light_dfs = np.zeros((S, Qb, T), np.int32)
        slot_dense = np.full((S, Qb, T), nd, np.int32)
        slot_light = np.full((S, Qb, T), self.n_light, np.int32)
        wbits = np.zeros((S, Qb, T), np.int32)
        dense = ent[:, 3]
        light = dense < 0
        starts[sid, qi, slot] = ent[:, 1]
        light_dfs[sid, qi, slot] = np.where(light, ent[:, 2], 0)
        slot_dense[sid, qi, slot] = np.where(light, nd, dense)
        slot_light[sid, qi, slot] = np.where(light, ent[:, 4], self.n_light)
        wbits[sid, qi, slot] = w.view(np.int32)

        # compact heavy-row table per (shard, dp group)
        hm = ~light
        h_id = dense[hm]
        if h_id.shape[0]:
            h_si = sid[hm]
            h_g = qi[hm] // Qd
            key = (h_si * self.dp + h_g) * (nd + 1) + h_id
            uniq_key, inv = np.unique(key, return_inverse=True)
            uk_sg, uk_id = np.divmod(uniq_key, nd + 1)
            grp_first = np.concatenate([[True], uk_sg[1:] != uk_sg[:-1]])
            grp_start = np.where(grp_first, np.arange(uk_sg.shape[0]), 0)
            np.maximum.accumulate(grp_start, out=grp_start)
            u_slot = np.arange(uniq_key.shape[0]) - grp_start
            u_max = int(u_slot.max()) + 1
        else:
            u_max = 0
        hb = self.config.device.heavy_buckets
        U = _pick_shape(max(u_max, 1), hb, self._pin("U", Qb), "U")
        slot_compact = np.full((S, Qb, T), U, np.int32)
        ids = np.full((S, self.dp, Qd * T), nd, np.int32)
        if h_id.shape[0]:
            slot_compact[h_si, qi[hm], slot[hm]] = u_slot[inv]
            uk_s, uk_g = np.divmod(uk_sg, self.dp)
            ids[uk_s, uk_g, u_slot] = uk_id
        plan = np.concatenate(
            [starts, light_dfs, slot_dense, slot_light, slot_compact,
             wbits, ids.reshape(S, Qb, T)],
            axis=2,
        )
        return plan, int(U)

    def _chunk_budget(self, dfs, block) -> int:
        """Static per-step chunk count: max over (shard, dp group) totals."""
        S, Qb, T = dfs.shape
        reps = (dfs.astype(np.int64) + block - 1) // block
        reps = reps.reshape(S, self.dp, (Qb // self.dp) * T).sum(axis=2)
        total_max = max(int(reps.max(initial=0)), 1)
        return _pick_shape(total_max, self.config.device.chunk_buckets,
                           self._pin("C", Qb), "C")

    def _light_budget(self, plan_np) -> int:
        """Static live light-pair count L2 for the compact rescore: max over
        (shard, dp group) of live (query, slot) light pairs."""
        S, Qb, L = plan_np.shape
        T = L // 7
        live = (plan_np[:, :, 3 * T:4 * T] < self.n_light) & (
            plan_np[:, :, 5 * T:6 * T] != 0)
        pairs = int(live.reshape(S, self.dp, -1).sum(axis=2).max(initial=0))
        return _pick_shape(max(pairs, 1), self.L_BUCKETS, self._pin("L", Qb), "L")

    def _heavy_budget(self, plan_np) -> int:
        """Static live heavy-pair count H2 for the compact rescore: max over
        (shard, dp group) of live (query, slot) heavy pairs."""
        S, Qb, L = plan_np.shape
        T = L // 7
        live = (plan_np[:, :, 2 * T:3 * T] < self.n_dense) & (
            plan_np[:, :, 5 * T:6 * T] != 0)
        pairs = int(live.reshape(S, self.dp, -1).sum(axis=2).max(initial=0))
        return _pick_shape(max(pairs, 1), self.HP_BUCKETS, self._pin("HP", Qb), "HP")

    def probe_workload(self, batches, shortcut_k: int = 10):
        """Raw (unbucketed) sizes of the static shapes over a sample workload,
        measured per (shard, dp group), the units each local step runs
        over. Returns {"T","Q","C","U","L","HP"} (no "W": the local step
        keeps the flat-sort selection). The probe applies the 1-term
        shortcut first, exactly as serving does, so C/L budgets exclude
        host-answered queries' postings."""
        block = self.config.device.posting_block
        S, DP = self.n_shards, self.dp
        nd = self.n_dense
        t = q = c = u = li = hp = 1
        for b in batches:
            q = max(q, len(b))
            b, _f = self._shortcut_single_heavy(b, shortcut_k)
            rows, _w, q_lens = _probe_queries_flat(self._lex_slices, b)
            if not rows.shape[0]:
                continue
            qi = np.repeat(np.arange(len(b), dtype=np.int64), q_lens)
            ent = self._lex_table[rows]
            sid = ent[:, 0]
            t = max(t, int(np.bincount(qi * S + sid).max(initial=0)))
            Qb = _round_up(max(len(b), 1), DP)
            if self._pins.get("Q"):
                Qb = _round_up(Qb, self._pins["Q"])
            g = qi // (Qb // DP)
            key_sg = sid * DP + g
            light = ent[:, 3] < 0
            if light.any():
                reps = (ent[light, 2] + block - 1) // block
                c = max(c, int(np.bincount(key_sg[light], weights=reps,
                                           minlength=S * DP).max()))
                li = max(li, int(np.bincount(key_sg[light], minlength=S * DP).max()))
            if not light.all():
                hk = key_sg[~light] * (nd + 1) + ent[~light, 3]
                u = max(u, int(np.bincount(np.unique(hk) // (nd + 1),
                                           minlength=S * DP).max()))
                hp = max(hp, int(np.bincount(key_sg[~light], minlength=S * DP).max()))
        return {"T": t, "Q": q, "C": c, "U": u, "L": li, "HP": hp}

    def pin_shapes(
        self,
        probe_batches=None,
        *,
        T: Optional[int] = None,
        Q: Optional[int] = None,
        C: Optional[int] = None,
        U: Optional[int] = None,
        L: Optional[int] = None,
        HP: Optional[int] = None,
        c_pad: int = 128,
        u_pad: int = 16,
        scope_q: bool = False,
    ):
        """Freeze batch-varying static shapes (the single-device
        pin_shapes contract). Probe sizes are measured per (shard, dp
        group). scope_q=True pins {C, U, L, HP} for the probe's Q envelope
        only (scoped pins win)."""
        if probe_batches is not None:
            block = self.config.device.posting_block
            if self._sparse:
                m = self.probe_workload(probe_batches)
                t, q, c, u, li = m["T"], m["Q"], m["C"], m["U"], m["L"]
                hp = m["HP"]
            else:
                t = q = c = u = li = hp = 1
                for b in probe_batches:
                    q = max(q, len(b))
                    s, _dfs, _w, light_dfs, uh, _m = self.plan(b)
                    t = max(t, s.shape[2])
                    c = max(c, self._chunk_budget(light_dfs, block))
                    u = max(u, uh.shape[2])
            if scope_q:
                # C/U/L/HP only: T stays on its bounded ladder
                qb = _round_up(max(q, 1), self.dp)
                if self._pins.get("Q"):
                    qb = _round_up(qb, self._pins["Q"])
                scope = self._qpins.setdefault(qb, {})
                for k, v in (
                    ("C", C or _round_up(c, c_pad)),
                    ("U", U or _round_up(u + 1, u_pad)),
                    ("L", L or _bucket(li, self.L_BUCKETS)),
                    ("HP", HP or _bucket(hp, self.HP_BUCKETS)),
                ):
                    scope[k] = int(v)
                return {qb: dict(scope)}
            T = T or _bucket(t, self.T_BUCKETS)
            Q = Q or _round_up(q, self.dp)
            C = C or _round_up(c, c_pad)
            U = U or _round_up(u + 1, u_pad)
            L = L or _bucket(li, self.L_BUCKETS)
            HP = HP or _bucket(hp, self.HP_BUCKETS)
        elif scope_q:
            raise ValueError("scope_q=True requires probe_batches")
        for k, v in (("T", T), ("Q", Q), ("C", C), ("U", U), ("L", L), ("HP", HP)):
            if v:
                self._pins[k] = int(v)
        return dict(self._pins)

    # ---------------- execution ----------------

    def _run(self, plan_np: np.ndarray, max_df=None, **statics) -> torch.Tensor:
        """Every (dp group, shard) local step, each group merged on its
        first device, the groups concatenated on self.device: packed f32
        [Qb, 2K + 1 (+ guard)]. The plan goes up once per distinct device."""
        Qd = plan_np.shape[1] // self.dp
        plans: Dict[torch.device, torch.Tensor] = {}
        outs = []
        for g in range(self.dp):
            parts = []
            for s in range(self.n_shards):
                dev = self.mesh.devices[g][s]
                if dev not in plans:
                    plans[dev] = _upload(plan_np, dev)
                pi = plans[dev][s, g * Qd:(g + 1) * Qd]
                tab = self._tables[s][dev]
                with _on(dev):
                    if max_df is not None:  # exact mode: host-int windows
                        parts.append(local_step(
                            tab, pi, n_slots=self.shard_capacity,
                            max_df=max_df[g][s], **statics))
                        continue
                    out = self.launch_caches[dev].run(
                        graphed_step, {"pi": pi},
                        dict(vars(tab), n_slots=self.shard_capacity,
                             **statics))
                parts.append(out if len(out) == 4 else (*out, None))
            dst = self.mesh.devices[g][0]
            with _on(dst):
                outs.append(merge_shards(parts, n_slots=self.shard_capacity,
                                         K=statics["K"], dst=dst))
        return torch.cat([_to_merge(o, self.device) for o in outs], dim=0)

    def search_batch_async(self, queries: Sequence[Sequence[WeightedTerm]], k: int):
        """Launch one sharded batched search; returns an opaque handle for
        search_batch_gather (the single-device protocol: keep several
        launches in flight to hide the host's planning). The plan goes up
        as one int32 array per device (f32 payloads as raw bit patterns);
        results come back as one packed f32 array. Spans as TorchIndex's:
        index.launch around index.plan and index.enqueue."""
        with GLOBAL_TRACER.span("index.launch"):
            nq = len(queries)
            if nq == 0 or self.n_docs == 0:
                return ("empty", nq)
            if self.config.device.mode == "sparse":
                return self._search_sparse_async(queries, k)
            return self._search_full_async(queries, k)

    def _search_sparse_async(self, queries, k: int):
        nq = len(queries)
        dcfg = self.config.device
        block = dcfg.posting_block
        with GLOBAL_TRACER.span("index.plan"):
            K = min(_bucket(max(k, 1), self.K_BUCKETS), self.shard_capacity)
            K2 = min(max(2 * K, dcfg.rescore_margin), self.shard_capacity)
            # 1-term head queries: answered host-side from the per-shard
            # top-k tables; their batch slots plan as empty queries
            queries, fills = self._shortcut_single_heavy(queries, k)
            if fills is not None and len(fills) == nq:
                return ("fills", nq, k, fills)
            plan_np, U = self.plan_sparse(queries)
            T = plan_np.shape[2] // 7
            C = self._chunk_budget(plan_np[:, :, T:2 * T], block)
            L2 = self._light_budget(plan_np)
            H2 = self._heavy_budget(plan_np)
            direct = self._heavy_direct
            fast = (dcfg.fast_heavy and direct
                    and os.environ.get("NEXTSEARCH_FAST_HEAVY", "1") == "1")
            use_compact = (
                os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1")

        def launch(fh: bool) -> _HostCopy:
            # the exact relaunch under fast mode runs over the full
            # stored table, as the single-device path does
            uc = use_compact and (fh or not fast)
            return _HostCopy(self._run(
                plan_np, mode="sparse", T=T, U=U if uc else 0, K=K, K2=K2,
                C=C, block=block, bs_steps=self._bs_depth,
                nd=self.n_dense, nl=self.n_light, use_compact=uc,
                heavy_direct=direct, fast_heavy=fh,
                guard_eps=dcfg.fast_heavy_eps, L2=L2, H2=H2,
                two_level=two_level_sort2()))

        with GLOBAL_TRACER.span("index.enqueue"):
            if fast:
                return ("packedg", nq, k, K, launch(True),
                        lambda: launch(False), None, queries, fills)
            return ("packed", nq, k, K, launch(False), fills)

    def _search_full_async(self, queries, k: int):
        """The fused and exact modes' launch."""
        nq = len(queries)
        dcfg = self.config.device
        mode = dcfg.mode
        block = dcfg.posting_block
        with GLOBAL_TRACER.span("index.plan"):
            K = min(_bucket(max(k, 1), self.K_BUCKETS), self.shard_capacity)
            K2 = min(max(2 * K, dcfg.rescore_margin), self.shard_capacity)
            starts, dfs, weights, light_dfs, unique_heavy, heavy_mix = (
                self.plan(queries))
            C = self._chunk_budget(light_dfs if mode != "exact" else dfs,
                                   block)
            S, Qb, T = starts.shape
            U = unique_heavy.shape[2]
            Qd = Qb // self.dp
            # one int32 plan (L = 4T + 2U): starts | dfs | light_dfs |
            # weight bits | heavy-mix bits | unique heavy ids (in the first
            # row of each dp group)
            plan_np = np.zeros((S, Qb, 4 * T + 2 * U), np.int32)
            plan_np[:, :, :T] = starts
            plan_np[:, :, T:2 * T] = dfs
            plan_np[:, :, 2 * T:3 * T] = light_dfs
            plan_np[:, :, 3 * T:4 * T] = weights.view(np.int32)
            if U:
                plan_np[:, :, 4 * T:4 * T + U] = heavy_mix.reshape(
                    S, Qb, U).view(np.int32)
                for g in range(self.dp):
                    plan_np[:, g * Qd, 4 * T + U:] = unique_heavy[:, g, :]
            # each step's largest df per slot, known here (none read back)
            max_df = [[dfs[s, g * Qd:(g + 1) * Qd].max(axis=0).tolist()
                       for s in range(S)] for g in range(self.dp)] \
                if mode == "exact" else None
        with GLOBAL_TRACER.span("index.enqueue"):
            packed = self._run(
                plan_np, max_df=max_df,
                mode="exact" if mode == "exact" else "fused",
                T=T, U=U, K=K, K2=K2, C=C, block=block, bs_steps=24,
                nd=self.n_dense, nl=self.n_light, use_compact=False,
                heavy_direct=False, fast_heavy=False, guard_eps=0.0, L2=0,
                H2=0)
            return ("packed", nq, k, K, _HostCopy(packed), None)

    def _host_rescue_row(self, out, j, queries, K):
        """Overwrite packed row j with the exact host-oracle result for
        queries[j] (guard-trip rescue; doc slots map through the global
        shard-major layout via segment_slot_bases)."""
        bases = self.segment_slot_bases()
        hits, found = oracle_search_vec(
            self._oracle_segs(), queries[j], K,
            k1=self.config.bm25.k1, b=self.config.bm25.b,
        )
        out[j, : 2 * K + 1] = 0.0
        for i, (score, seg_idx, doc) in enumerate(hits[:K]):
            out[j, i] = np.float32(score)
            out[j, K + i] = np.float32(bases[seg_idx] + doc)
        out[j, 2 * K] = np.float32(found)

    warm_batch = warm_launches

    def search_batch_gather(self, handle) -> List[QueryResult]:
        """Wait for a search_batch_async launch and unpack its results
        (spans as TorchIndex's: index.gather around index.wait,
        index.rescue, index.relaunch and index.unpack)."""
        with GLOBAL_TRACER.span("index.gather"):
            tag = handle[0]
            if tag == "empty":
                return [QueryResult(np.empty(0, np.float32),
                                    np.empty(0, np.int32), 0)] * handle[1]
            if tag == "fills":
                # whole batch answered host-side by the 1-term shortcut
                _tag, nq, _k, fills = handle
                return [fills[qi] for qi in range(nq)]
            if tag == "packedg":
                # the guarded fast path: few trips get the exact host-oracle
                # rescue, many trips one exact full-table relaunch
                _tag, nq, k, K, pending, relaunch, _perm, queries, fills = (
                    handle)
                with GLOBAL_TRACER.span("index.wait"):
                    (out,) = pending.wait()
                tripped = np.flatnonzero(out[:nq, 2 * K + 1] < 0.5)
                if tripped.size:
                    out = self._guard_trip(out, tripped, relaunch, queries,
                                           nq, K)
            else:
                _tag, nq, k, K, pending, fills = handle
                with GLOBAL_TRACER.span("index.wait"):
                    (out,) = pending.wait()
            with GLOBAL_TRACER.span("index.unpack"):
                vals = out[:, :K]
                idx = out[:, K:2 * K].astype(np.int32)
                found = out[:, 2 * K]
                res = []
                for qi in range(nq):
                    keep = vals[qi] > 0.0
                    keep[min(k, K):] = False
                    res.append(QueryResult(scores=vals[qi][keep][:k],
                                           doc_slots=idx[qi][keep][:k],
                                           found=int(found[qi])))
                if fills:
                    for qi, qr in fills.items():
                        res[qi] = qr
            return res

    def _guard_trip(self, out, tripped, relaunch, queries, nq, K):
        """The packed result once the guard tripped for the `tripped`
        queries: each rescued with the exact host oracle
        (index.rescue), or the batch relaunched exactly (index.relaunch)."""
        cap = int(os.environ.get("NEXTSEARCH_TRIP_RESCUE", "8"))
        if tripped.size > cap:
            log("sharded", f"fast-heavy guard tripped ({tripped.size}/"
                f"{nq} queries); relaunching exact-precision kernel")
            self.relaunches += 1
            with GLOBAL_TRACER.span("index.relaunch"):
                (out,) = relaunch().wait()
            return out
        with GLOBAL_TRACER.span("index.rescue"):
            t0 = time.perf_counter()
            out = np.array(out)
            for j in tripped:
                self._host_rescue_row(out, int(j), queries, K)
            dt = (time.perf_counter() - t0) * 1000.0
        self.rescue_ms += dt
        self.rescue_trips += int(tripped.size)
        log("sharded", f"fast-heavy guard tripped ({tripped.size}/"
            f"{nq} queries); host-oracle rescue {dt:.1f}ms")
        return out

    # ---------------- result mapping ----------------

    def hbm_bytes(self) -> Dict[str, int]:
        """Device bytes of the index, by component, summed over every
        shard's copies (one per distinct device of its mesh column)."""
        out: Dict[str, int] = dict.fromkeys(
            ("post_doc", "post_score", "dense_rows", "bucket_pos",
             "light_bucket_pos"), 0)
        for copies in self._tables:
            for tab in copies.values():
                for name in out:
                    t = getattr(tab, name)
                    if t is not None:
                        out[name] += int(t.numel() * t.element_size())
        out = {k: v for k, v in out.items() if v}
        out["total"] = sum(out.values())
        return out

    def locate(self, doc_slot: int) -> Tuple[int, int]:
        """Global sharded doc slot -> (segment index, local docId)."""
        si, local = divmod(int(doc_slot), self.shard_capacity)
        lo, _hi = self.shard_seg_ranges[si]
        bases = self.shard_doc_bases[si]
        j = int(np.searchsorted(np.asarray(bases), local, "right") - 1)
        return lo + j, local - bases[j]

    def doc_info(self, doc_slot: int) -> Tuple[str, str, int]:
        seg_idx, doc_id = self.locate(doc_slot)
        return self.seg_names[seg_idx], self.segments[seg_idx].cord_uids[doc_id], doc_id

    def doc_info_batch(self, slots):
        """doc_info of each slot (the render path's batch form)."""
        return [self.doc_info(int(s)) for s in np.asarray(slots)]
