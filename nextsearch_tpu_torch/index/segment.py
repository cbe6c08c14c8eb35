"""TorchIndex: the device index, in every mode of DeviceConfig.mode (fused,
the default; exact; fast; sparse), with its device side in PyTorch.

The host planner (the 1-term shortcut tables, plan_sparse, _plan_groups,
pin_shapes and the budgets, host rescue and its memo, locate/doc_info) is
the port's copy of the JAX package's numpy planner, in index/planner.py.
This module builds the lexicons, dense-row assignment and light bucket
table on the host, as nextsearch_tpu/index/segment.py's DeviceIndex does,
and holds what runs on the card: the uploads, the launch, the gather with
its guard relaunch, the row top-k build and hbm_bytes.

The build switches are the reference's, with its defaults: the dense rows
are built on the device (NEXTSEARCH_DEVICE_BUILD=0 builds them, and the
heavy bucket table, on the host and uploads the finished table once); the
light bucket table and the row top-k are built on the host
(NEXTSEARCH_LIGHT_BUILD=device and NEXTSEARCH_ROW_TOPK_BUILD=device build
them on the device, index/device_build.py). The fused, exact
and fast modes plan with plan_full and launch ops/bm25.py; they keep the
postings and the dense rows on the device and none of the sparse mode's
tables (light buckets, 1-term shortcut tables, merged multi-segment rows).

DeviceConfig.dense_rows_bf16 is the reference's bf16-rows configuration:
dense rows stored bf16 (half the bytes, so twice the rows fit
dense_max_bytes), one row per (heavy term, segment), a heavy bucket table
for the v2 rescore, no fast mode and no row top-k shortcut.

The sparse, fused and fast launches go through the index's launch cache
(ops/graphs.py): one CUDA graph per key of statics and plan shapes,
captured at its first batch (or by warm_batch, which Engine.warmup calls)
and replayed after, as the reference's jax.jit programs; exact mode, whose
windows per term slot are a static that changes every batch, runs
eagerly. Results come back through a non-blocking copy into a pinned host
buffer and a CUDA event that search_batch_gather waits on, so the host can
plan and launch the next batch while this one runs.

Spans (utils/profiling.GLOBAL_TRACER), one per batch: index.launch around
index.plan (shortcuts, the planner, chunk budgets, plan packing; in sparse
mode index.shortcut around the 1-term shortcut) and index.enqueue
(uploads, the replay or eager launch, the copy-out); and index.gather
around index.wait (the event sync), index.rescue, index.relaunch and
index.unpack. Counters of the sparse mode: index.shortcut_answers (queries
answered by the row or light top-k tables), index.queries_launched
(queries sent to a launch), index.guard_trips (queries whose fast guard
tripped), index.rescued (of those, rescued on the host; rescue_trips
too) and index.relaunches (batches relaunched exactly; relaunches too).
While the tracer records, on a card, each launch also times the card's
idle gap before it: a timing event after its plan uploads, just before its
launch, and its copy-out's event with timing; at its gather the gap from
the previous launch's end to its start is a span device.idle, ending where
the start event was enqueued on the host clock (a gap above 0 means the
stream was empty then, so the event ran at its enqueue). The uploads are a
few kB, so the gap spans the host's enqueue of them, during which the card
idles.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, EngineConfig
from ..ops.bm25 import bm25_search_packed, bm25_topk_exact, bm25_topk_fast
from ..ops.bm25_sparse import (
    BUCKET_LOG2, LIGHT_BUCKET_LOG2, packed_impl, packed_multi, two_level_sort2,
    unified_impl,
)
from ..ops.graphs import LaunchCache
from ..utils.logging import log
from ..utils.profiling import GLOBAL_TRACER
from .builder import SegmentArrays, eager_scores
from .device_build import (
    build_heavy_on_device, build_light_on_device, build_row_topk_on_device,
)
from .planner import (
    QueryResult,
    ResultColumns,
    SparsePlanner,
    WeightedTerm,
    _bucket,
    _deal_sorted,
    _log_build_phases,
    _round_up,
)


class _IdleMark(NamedTuple):
    """A launch's start on the card, for its idle gap (device.idle): a
    timing event recorded after its plan uploads, just before its launch,
    the perf_counter_ns at which it was enqueued, the previous launch's end
    event (None where that one was not timed) and the batch id."""

    start: "torch.cuda.Event"
    t_ns: int
    prev_end: Optional["torch.cuda.Event"]
    batch: Optional[int]


class _HostCopy:
    """Results on their way to the host: a non-blocking copy of each tensor
    into a pinned buffer plus the CUDA event that marks their completion
    (on the CPU the tensors are already host memory). device_outs keeps the
    tensors themselves, so a consumer on the device (the hybrid rerank)
    chains on them without a round trip through the host. With a start
    `mark` the event is timed, and the first wait records the card's idle
    gap before the launch (device.idle)."""

    def __init__(self, *outs: torch.Tensor,
                 mark: Optional[_IdleMark] = None):
        self.device_outs = list(outs)
        self.mark = mark
        if outs[0].device.type == "cuda":
            self.hosts = [
                torch.empty(o.shape, dtype=o.dtype, pin_memory=True).copy_(
                    o, non_blocking=True)
                for o in outs
            ]
            self.event = torch.cuda.Event(enable_timing=mark is not None)
            self.event.record(torch.cuda.current_stream(outs[0].device))
        else:
            self.hosts = list(outs)
            self.event = None

    def wait(self) -> List[np.ndarray]:
        """The results as host arrays, one per tensor (a packed launch has
        one), once the card has written them."""
        if self.event is not None:
            self.event.synchronize()
            mark, self.mark = self.mark, None
            if mark is not None and mark.prev_end is not None:
                gap_ns = max(0, int(
                    mark.prev_end.elapsed_time(mark.start) * 1e6))
                GLOBAL_TRACER.add("device.idle", mark.t_ns - gap_ns,
                                  mark.t_ns, batch=mark.batch)
        return [h.numpy() for h in self.hosts]


# The largest host-oracle pass (the index's documents plus one tripped
# query's postings) that a guard trip rescues on the host rather than by an
# exact relaunch of its batch. On an H100 machine's host the oracle took
# 430-600 ms a query at 8.84M passages (~25 ns an element), and an exact
# relaunch of a 256-query batch 29.5 ms of the card: past about a million
# elements the relaunch is the cheaper.
RESCUE_WORK = 1 << 20


def _unpack(out: np.ndarray, K: int, w: int):
    """(vals, doc slots, found) of a packed f32 [Q, 2K + 1 (+ guard)]
    result, the first w of its K hits a row."""
    return (out[:, :w], out[:, K: K + w].astype(np.int32),
            out[:, 2 * K].astype(np.int32))


def warm_launches(index, queries: Sequence[Sequence[WeightedTerm]],
                  k: int) -> Sequence[QueryResult]:
    """search_batch on a TorchIndex or ShardedIndex, and under the fast
    guard the batch's exact relaunch as well, so that the index's launch
    caches hold both graphs of the batch's envelope before serving meets a
    guard trip (Engine.warmup)."""
    handle = index.search_batch_async(queries, k)
    if handle[0] == "packedg":
        handle[5]().wait()
    return index.search_batch_gather(handle)


def _upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host plan array on `device`. On a card the copy goes pinned and
    non-blocking: a pageable upload would wait for the batch still running
    on the card and stall the pipeline."""
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t


class TorchIndex(SparsePlanner):
    """Immutable multi-segment index resident on `device`."""

    def __init__(
        self,
        segments: Sequence[SegmentArrays],
        seg_names=None,
        config: EngineConfig = DEFAULT_CONFIG,
        *,
        device,
    ):
        dcfg = config.device
        if dcfg.mode not in ("fused", "exact", "fast", "sparse"):
            raise ValueError(f"unknown device mode {dcfg.mode!r}")
        self.device = torch.device(device)
        # the fused mode's heavy product and the plain versions of the
        # kernels are f32 matmuls: no TF32 operands (PyTorch's default)
        torch.backends.cuda.matmul.allow_tf32 = False

        phases: List[Tuple[str, float]] = []
        t_last = [time.perf_counter()]

        def tick(name: str) -> None:
            now = time.perf_counter()
            phases.append((name, now - t_last[0]))
            t_last[0] = now

        self.host_only = False
        self.config = config
        # the sparse, fused and fast launches, one CUDA graph per key
        self.launch_cache = LaunchCache(self.device)
        self._last_end = None  # the last timed launch's end event
        self._pins: Dict[str, int] = {}
        self._qpins: Dict[int, Dict[str, int]] = {}
        self._tpins: Dict[Tuple[int, int], Dict[str, int]] = {}
        self._shortcut_memo: Dict = {}
        self.rescue_ms = 0.0
        self.rescue_trips = 0
        self.relaunches = 0  # batches re-run exactly after a guard trip
        self._rescue_memo: Dict = {}
        self.segments = list(segments)
        self.seg_names = list(seg_names) if seg_names else [
            f"seg_{i + 1:06d}" for i in range(len(self.segments))
        ]
        if len(self.seg_names) != len(self.segments):
            raise ValueError("seg_names and segments differ in length")

        self.doc_bases: List[int] = []
        base = 0
        for seg in self.segments:
            self.doc_bases.append(base)
            base += seg.N
        self.n_docs = base
        self._sparse = dcfg.mode == "sparse"
        pad = dcfg.doc_pad
        if self._sparse:
            # heavy kernels tile the doc axis in 2048-doc tiles
            pad = _round_up(pad, 2048)
        self.n_slots = max(_round_up(base, pad), pad)
        if self.n_slots >= 1 << 24:
            raise ValueError(
                f"TorchIndex supports < 2^24 doc slots (got {self.n_slots}): "
                "doc slots travel as exact f32 values in the packed output"
            )
        self.dense_threshold = (
            max(1, int(self.n_slots * dcfg.dense_df_ratio))
            if dcfg.dense_df_ratio > 0
            else (1 << 62)
        )
        # bf16 rows rescore by v2 over the postings, which needs one
        # contiguous posting range per row: rows stay per (term, segment)
        self._heavy_direct = not dcfg.dense_rows_bf16
        # multi-segment: one merged dense row per heavy term (see the
        # reference's DeviceIndex.__init__ for why this is bit-exact)
        self._merged_heavy = (
            self._sparse and self._heavy_direct and len(self.segments) > 1
        )

        self.lex: List[Dict[str, Tuple[int, int, int]]] = []
        post_doc_parts: List[np.ndarray] = []
        post_score_parts: List[np.ndarray] = []
        heavy: List[Tuple[int, int, int, int]] = []
        gdf: Dict[str, int] = {}
        self._seg_pbase: List[int] = []
        pbase = 0
        for seg_i, (seg, dbase) in enumerate(zip(self.segments, self.doc_bases)):
            self._seg_pbase.append(pbase)
            lex: Dict[str, Tuple[int, int, int]] = {}
            offs = seg.term_offsets
            for i, t in enumerate(seg.terms):
                df = int(seg.term_df[i])
                start = pbase + int(offs[i])
                lex[t] = (start, df, -1)
                if self._merged_heavy:
                    if df > 0:
                        gdf[t] = gdf.get(t, 0) + df
                elif df >= self.dense_threshold:
                    heavy.append((df, seg_i, i, start))
            self.lex.append(lex)
            post_doc_parts.append(seg.post_doc.astype(np.int64) + dbase)
            score = seg.post_score
            if score is None:
                score = eager_scores(seg, k1=config.bm25.k1, b=config.bm25.b)
            post_score_parts.append(score)
            pbase += seg.num_postings
        self.n_postings = pbase
        tick("lexicons")

        # highest-df terms win the capped dense-row budget
        row_bytes = (2 if dcfg.dense_rows_bf16 else 4) * self.n_slots
        row_cap = min(
            dcfg.dense_max_rows,
            max(0, int(dcfg.dense_max_bytes // row_bytes)),
        )
        self._gdf: Dict[str, int] = {}
        heavy_entries: List[Tuple[int, int, str]] = []
        if self._merged_heavy:
            heavy_terms = sorted(
                ((d, t) for t, d in gdf.items() if d >= self.dense_threshold),
                reverse=True,
            )[:row_cap]
            self.n_dense = len(heavy_terms)
            self._gdf = {t: d for d, t in heavy_terms}
            for row_id, (_d, t) in enumerate(heavy_terms):
                for seg_i in range(len(self.segments)):
                    v = self.lex[seg_i].get(t)
                    if v is not None and v[1] > 0:
                        heavy_entries.append((row_id, seg_i, t))
                        self.lex[seg_i][t] = (v[0], v[1], row_id)
        else:
            heavy.sort(reverse=True)
            heavy = heavy[:row_cap]
            self.n_dense = len(heavy)
            for row_id, (_df, seg_i, term_i, _start) in enumerate(heavy):
                term = self.segments[seg_i].terms[term_i]
                start, dfv, _ = self.lex[seg_i][term]
                self.lex[seg_i][term] = (start, dfv, row_id)
        nd1_pad = _round_up(self.n_dense + 1, 8)
        self._device_build = (
            os.environ.get("NEXTSEARCH_DEVICE_BUILD", "1") == "1")
        # the light table is built on the device only beside a device build
        # of the dense rows, as in the reference
        light_device = self._sparse and self._device_build and (
            os.environ.get("NEXTSEARCH_LIGHT_BUILD", "host") != "host")

        # the light bucket table exists only in sparse mode
        self._light_row: List[Dict[str, int]] = []
        self._lb_log2 = LIGHT_BUCKET_LOG2
        self.n_light = 0
        light_host, light_max_occ = (
            self._build_light_rows(post_doc_parts, heavy_entries,
                                   table=not light_device)
            if self._sparse else (None, 0)
        )
        tick("light_rows")

        post_doc = (
            np.concatenate(post_doc_parts).astype(np.int32)
            if post_doc_parts else np.zeros(1, np.int32)
        )
        post_score = (
            np.concatenate(post_score_parts).astype(np.float32)
            if post_score_parts else np.zeros(1, np.float32)
        )
        if post_doc.size == 0:
            post_doc = np.zeros(1, np.int32)
            post_score = np.zeros(1, np.float32)

        dev = self.device
        self.post_doc = torch.as_tensor(post_doc, device=dev)
        self.post_score = torch.as_tensor(post_score, device=dev)
        tick("postings_upload")
        if self._merged_heavy:
            h_starts = [self.lex[s][t][0] for _r, s, t in heavy_entries]
            h_dfs = [self.lex[s][t][1] for _r, s, t in heavy_entries]
            h_rows = [r for r, _s, _t in heavy_entries]
        else:
            h_starts = [h[3] for h in heavy]
            h_dfs = [h[0] for h in heavy]
            h_rows = None
        with_buckets = self._sparse and not self._heavy_direct
        if self._device_build:
            self.dense_rows, self.bucket_pos, heavy_max_occ = (
                build_heavy_on_device(
                    self.post_doc, self.post_score, h_starts, h_dfs,
                    rows=h_rows, n_rows_pad=nd1_pad, n_slots=self.n_slots,
                    bf16=dcfg.dense_rows_bf16, with_buckets=with_buckets,
                ))
        else:
            self.dense_rows, self.bucket_pos, heavy_max_occ = (
                self._build_heavy_host(
                    post_doc, post_score, h_starts, h_dfs, h_rows,
                    n_rows_pad=nd1_pad, with_buckets=with_buckets,
                ))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tick("heavy_device_build" if self._device_build
             else "host_tables_upload")
        self.light_bucket_pos = None
        if light_device:
            l_starts = np.zeros(self.n_light, np.int64)
            l_dfs = np.zeros(self.n_light, np.int64)
            for seg_i, lmap in enumerate(self._light_row):
                lex = self.lex[seg_i]
                for t, row in lmap.items():
                    l_starts[row], l_dfs[row] = lex[t][0], lex[t][1]
            self.light_bucket_pos, light_max_occ = build_light_on_device(
                self.post_doc, l_starts, l_dfs, n_rows_pad=self.n_light + 1,
                n_slots=self.n_slots, bucket_log2=self._lb_log2,
            )
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            tick("light_device_build")
        elif self._sparse:
            self.light_bucket_pos = torch.as_tensor(light_host, device=dev)
        # the rescore's binary search covers the fullest bucket of either
        # table (the heavy one exists only with bf16 rows)
        self._bs_depth = max(
            2, int(max(heavy_max_occ, light_max_occ, 1)).bit_length())
        self._build_row_topk(post_doc, post_score)
        tick("row_topk")
        self._build_light_topk(post_doc_parts, post_score_parts)
        tick("light_topk")
        self._build_merged_lex()
        tick("merged_lex")
        self.build_phases = dict(phases)  # seconds by build phase
        _log_build_phases(phases)

    def _build_light_rows(self, post_doc_parts, heavy_entries, table=True):
        """The sparse mode's light rows: sets n_light, _light_row and
        _lb_log2 and returns the host-built light bucket-position table
        (int32 [n_light + 1, nbl + 1]) with its fullest bucket's posting
        count, or (None, 0) without `table` (the device builds it)."""
        # Light bucket-position table (host-built, one upload): one row per
        # light (term, segment), first-posting offset per 2^lb_log2-slot
        # bucket; row n_light is the zero sentinel. Granularity coarsens
        # until the table fits its byte budget, as in the reference.
        n_light_est = sum(
            int((seg.term_df > 0).sum()) for seg in self.segments
        ) - (len(heavy_entries) if self._merged_heavy else self.n_dense)
        budget = int(os.environ.get("NEXTSEARCH_LIGHT_TABLE_BYTES", 2 << 30))
        while (
            self._lb_log2 < 14
            and (n_light_est + 1) * ((self.n_slots >> self._lb_log2) + 2) * 4
            > budget
        ):
            self._lb_log2 += 1
        if self._lb_log2 != LIGHT_BUCKET_LOG2:
            log("index", f"light bucket granularity coarsened to "
                f"2^{self._lb_log2} ({n_light_est} light rows; table "
                f"budget {budget >> 20} MiB)")
        nbl = (self.n_slots + (1 << self._lb_log2) - 1) >> self._lb_log2
        counts_parts: List[np.ndarray] = []
        base_row = 0
        for seg_i, seg in enumerate(self.segments):
            lex = self.lex[seg_i]
            dense_ids = np.asarray([lex[t][2] for t in seg.terms], np.int64)
            lt_idx = np.nonzero((seg.term_df > 0) & (dense_ids < 0))[0]
            term_row = np.full(len(seg.terms), -1, np.int64)
            term_row[lt_idx] = base_row + np.arange(lt_idx.shape[0])
            self._light_row.append({seg.terms[i]: int(term_row[i]) for i in lt_idx})
            if lt_idx.shape[0] and table:
                row_of_post = np.repeat(
                    term_row - base_row, seg.term_df.astype(np.int64)
                )
                valid = row_of_post >= 0
                bucket = post_doc_parts[seg_i][valid] >> self._lb_log2
                # (row, bucket) keys are non-decreasing: counts are run
                # lengths
                ncell = lt_idx.shape[0] * nbl
                kdt = np.int32 if ncell < (1 << 31) else np.int64
                key = row_of_post[valid].astype(kdt) * kdt(nbl) + bucket.astype(kdt)
                cnt = np.zeros(ncell, np.int32)
                if key.size:
                    change = np.flatnonzero(key[1:] != key[:-1])
                    starts_u = np.concatenate(([0], change + 1))
                    ends_u = np.concatenate((change + 1, [key.size]))
                    cnt[key[starts_u]] = (ends_u - starts_u).astype(np.int32)
                counts_parts.append(cnt.reshape(lt_idx.shape[0], nbl))
            base_row += lt_idx.shape[0]
        self.n_light = base_row
        if not table:
            return None, 0
        light_host = np.zeros((base_row + 1, nbl + 1), np.int32)
        light_max_occ = 0
        if counts_parts:
            counts = np.concatenate(counts_parts, axis=0)
            light_max_occ = int(counts.max(initial=0))
            np.cumsum(counts, axis=1, out=light_host[:base_row, 1:])
        return light_host, light_max_occ

    def _build_heavy_host(self, post_doc, post_score, starts, dfs, rows, *,
                          n_rows_pad: int, with_buckets: bool):
        """NEXTSEARCH_DEVICE_BUILD=0: the dense rows (and, with bf16 rows in
        sparse mode, the heavy bucket table) written on the host and
        uploaded once, as the reference's host path. Returns the
        build_heavy_on_device triple. One host table of the stored dtype:
        each row's scores are rounded to bf16 (to nearest even) by torch's
        cast as they are written, which gives the device build's bits."""
        dcfg = self.config.device
        dtype = torch.bfloat16 if dcfg.dense_rows_bf16 else torch.float32
        host = torch.zeros((n_rows_pad, self.n_slots), dtype=dtype)
        nb = (self.n_slots + (1 << BUCKET_LOG2) - 1) >> BUCKET_LOG2
        bucket_host = (np.zeros((n_rows_pad, nb + 1), np.int32)
                       if with_buckets else None)
        bounds = np.arange(nb + 1, dtype=np.int64) << BUCKET_LOG2
        occ = 0
        for e, (start, df) in enumerate(zip(starts, dfs)):
            row = e if rows is None else rows[e]
            docs = post_doc[start:start + df].astype(np.int64)
            host[row, torch.from_numpy(docs)] = torch.from_numpy(
                post_score[start:start + df]).to(dtype)
            if bucket_host is not None:
                bucket_host[row] = np.searchsorted(docs, bounds, side="left")
                occ = max(occ, int(np.diff(bucket_host[row]).max()))
        dev = self.device
        dense = host.to(dev)
        del host
        bucket_pos = (torch.as_tensor(bucket_host, device=dev)
                      if bucket_host is not None else None)
        return dense, bucket_pos, occ

    def _build_row_topk(self, post_doc_np=None, post_score_np=None) -> None:
        """Exact canonical top-k of the df-head dense rows: from the host
        postings (the reference's default), or from the device's dense rows
        under NEXTSEARCH_ROW_TOPK_BUILD=device. None with bf16 rows, as in
        the reference."""
        dcfg = self.config.device
        self._row_topk = None
        if not (self._sparse and self._heavy_direct):
            return
        n = min(self.n_dense, dcfg.row_topk_rows)
        k = min(dcfg.row_topk_k, self.n_slots)
        if n <= 0 or k <= 0:
            return
        if os.environ.get("NEXTSEARCH_ROW_TOPK_BUILD", "host") == "host":
            self._row_topk = self._row_topk_host(n, k, post_doc_np, post_score_np)
        else:
            self._row_topk = build_row_topk_on_device(
                self.dense_rows, n, k=k, n_slots=self.n_slots)

    # ---------------- execution ----------------

    def search_batch_async(self, queries: Sequence[Sequence[WeightedTerm]],
                           k: int, shortcut: bool = True):
        """Launch one batched search in the index's mode; returns an opaque
        handle for search_batch_gather. Keeping several launches in flight
        hides the host's planning behind the card's work. shortcut=False
        disables the sparse mode's host-side 1-term and rescue-memo
        answers."""
        with GLOBAL_TRACER.span("index.launch"):
            nq = len(queries)
            if nq == 0 or self.n_docs == 0:
                return ("empty", nq)
            if self.config.device.mode == "sparse":
                return self._search_sparse_async(queries, k, shortcut)
            return self._search_full_async(queries, k)

    def _idle_mark(self) -> Optional[_IdleMark]:
        """This launch's start mark while the tracer records on a card,
        taking the last timed launch's end as the previous one; None
        otherwise, and then no event gets timing."""
        prev, self._last_end = self._last_end, None
        if self.device.type != "cuda" or not GLOBAL_TRACER.recording():
            return None
        start = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(self.device))
        return _IdleMark(start, time.perf_counter_ns(), prev,
                         GLOBAL_TRACER.batch_id())

    def _copy_out(self, *outs: torch.Tensor,
                  mark: Optional[_IdleMark] = None) -> _HostCopy:
        """The launch's _HostCopy; a timed one's event is where the next
        launch's idle gap starts."""
        copy = _HostCopy(*outs, mark=mark)
        if mark is not None:
            self._last_end = copy.event
        return copy

    def _search_full_async(self, queries, k: int):
        """The fused, exact and fast modes' launch (plan_full)."""
        nq = len(queries)
        dcfg = self.config.device
        block = dcfg.posting_block
        dev = self.device
        with GLOBAL_TRACER.span("index.plan"):
            K = min(_bucket(max(k, 1), self.K_BUCKETS), self.n_slots)
            starts, dfs, weights, light_dfs, unique_heavy, heavy_mix = (
                self.plan_full(queries)
            )
            if dcfg.mode == "exact":
                # eager: max_df (host ints, the windows of each term slot)
                # is a static of the launch and differs from batch to
                # batch, so a graph per value would be captured for nearly
                # every batch
                max_df = dfs.max(axis=0).tolist()
                plan = dict(starts=starts, dfs=dfs, weights=weights)
            elif dcfg.mode == "fast":
                plan = dict(zip(
                    ("chunk_start", "chunk_len", "chunk_q", "chunk_w"),
                    self._chunk_plan(starts, dfs, weights, block)))
            else:  # fused (default): the plan in two uploads
                K2 = min(max(2 * K, dcfg.rescore_margin), self.n_slots)
                C = self._chunk_budget(light_dfs, block)
                Qb, T = starts.shape
                U = unique_heavy.shape[0]
                plan_f32 = np.zeros((Qb + 1, T + U), np.float32)
                plan_f32[:Qb, :T] = weights
                plan_f32[:Qb, T:] = heavy_mix
                # ids as exact f32 values (< 2^24), as the reference packs
                # them
                plan_f32[Qb, T:] = unique_heavy.astype(np.float32)
                plan = dict(plan_ints=np.stack([starts, dfs, light_dfs]),
                            plan_f32=plan_f32)
        with GLOBAL_TRACER.span("index.enqueue"):
            ins = {name: _upload(arr, dev) for name, arr in plan.items()}
            mark = self._idle_mark()
            tables = dict(post_doc=self.post_doc, post_score=self.post_score)
            if dcfg.mode == "exact":
                out = bm25_topk_exact(
                    self.post_doc, self.post_score, **ins,
                    n_slots=self.n_slots, K=K, block=block, max_df=max_df,
                )
            elif dcfg.mode == "fast":
                out = self.launch_cache.run(
                    bm25_topk_fast, ins,
                    dict(tables, n_slots=self.n_slots, K=K,
                         Q=starts.shape[0], block=block),
                )
            else:  # fused: one packed result
                packed = self.launch_cache.run(
                    bm25_search_packed, ins,
                    dict(tables, dense_rows=self.dense_rows,
                         n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
                         bs_steps=max(2, self.n_slots.bit_length() + 1),
                         scores_bf16=dcfg.scores_bf16),
                )
                return ("packed", nq, k, K,
                        self._copy_out(packed, mark=mark), None, None)
            return ("pending", nq, k, K, self._copy_out(*out, mark=mark))

    def _search_sparse_async(self, queries, k: int, shortcut: bool = True):
        nq = len(queries)
        with GLOBAL_TRACER.span("index.plan"):
            K = min(_bucket(max(k, 1), self.K_BUCKETS), self.n_slots)
            fills = None
            if shortcut:
                with GLOBAL_TRACER.span("index.shortcut"):
                    queries, fills = self._shortcut_single_heavy(queries, k)
                if fills:
                    GLOBAL_TRACER.count("index.shortcut_answers", len(fills))
            if shortcut and self._rescue_memo:
                out_q = None
                for qi, terms in enumerate(queries):
                    if fills is not None and qi in fills:
                        continue
                    res = self._rescue_memo.get((tuple(terms), K))
                    if res is None:
                        continue
                    if fills is None:
                        fills = {}
                    if out_q is None:
                        out_q = list(queries)
                    fills[qi] = QueryResult(
                        scores=res.scores[:k], doc_slots=res.doc_slots[:k],
                        found=res.found,
                    )
                    out_q[qi] = []
                if out_q is not None:
                    queries = out_q
            if fills is not None and len(fills) == nq:
                return ("fills", nq, k, fills)
            GLOBAL_TRACER.count("index.queries_launched",
                                nq - len(fills or ()))

            dcfg = self.config.device
            g = self._pins.get("Q") or dcfg.launch_group
            # Under the selection kernel K4, order queries by light window
            # so the long windows sit together (the reference does so for
            # its kernel's per-program block count, segment.py:1473-1506);
            # dealt round-robin over launch groups so each group keeps its
            # share. Undone at gather. NEXTSEARCH_SORT_QUERIES=1 forces it
            # (tests).
            perm = None
            forced = os.environ.get("NEXTSEARCH_SORT_QUERIES") == "1"
            select_kernel = (
                os.environ.get("NEXTSEARCH_SELECT_PALLAS", "0") == "1")
            if (select_kernel or forced) and nq > 1:
                wins = self._query_windows(queries)
                if wins.size and (wins.max() > 1024 or forced):
                    order = np.argsort(wins, kind="stable")
                    perm = _deal_sorted(order, g) if g and nq > g else order
                    queries = [queries[i] for i in perm]
            fast = (
                dcfg.fast_heavy
                and self._heavy_direct
                and os.environ.get("NEXTSEARCH_FAST_HEAVY", "1") == "1"
            )
            use_compact = (
                os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1")
            block = dcfg.posting_block
            unified = False
            if g and nq > g:
                plans, U = self._plan_groups(queries, g)
                groups = range(plans.shape[0])
                C = max(self._chunk_budget(plans[gi, 1], block)
                        for gi in groups)
                L2 = max(self._light_budget(plans[gi]) for gi in groups)
                H2 = max(self._heavy_budget(plans[gi]) for gi in groups)
                run, plan = packed_multi, plans
                w_max = self._sel_window(plans[:, 1])
            else:
                plan, U = self.plan_sparse(queries)
                C = self._chunk_budget(plan[1], block)
                L2 = self._light_budget(plan)
                H2 = self._heavy_budget(plan)
                # the unified kernel runs over the compact table at the
                # default light bucket granularity, single launches only (as
                # the reference, segment.py:1580-1589)
                unified = (
                    dcfg.unified
                    and os.environ.get("NEXTSEARCH_UNIFIED", "1") == "1"
                    and self._lb_log2 == LIGHT_BUCKET_LOG2
                    and use_compact
                )
                if not use_compact:
                    U = 0
                run, w_max = packed_impl, self._sel_window(plan[1])
            K2 = min(max(2 * K, dcfg.rescore_margin), self.n_slots)
            statics = dict(
                post_doc=self.post_doc, post_score=self.post_score,
                dense_rows=self.dense_rows,
                light_bucket_pos=self.light_bucket_pos,
                n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
                bs_steps=self._bs_depth, nd=self.n_dense, nl=self.n_light,
                heavy_direct=self._heavy_direct,
                guard_eps=dcfg.fast_heavy_eps, bucket_pos=self.bucket_pos,
            )
            cache = self.launch_cache
            # the switches a launch reads, as statics that key its graph
            switches = dict(
                h_bf16=os.environ.get("NEXTSEARCH_H_BF16", "0") == "1",
                two_level=two_level_sort2(),
            )
        with GLOBAL_TRACER.span("index.enqueue"):
            plan_dev = {"plans" if run is packed_multi else "plan":
                        _upload(plan, self.device)}
            mark = self._idle_mark()

            def launch(fh: bool, mark=None) -> _HostCopy:
                # the exact relaunch under fast mode runs over the full
                # stored table (no compact f32 gather buffer), as in the
                # reference
                uc = use_compact and (fh or not fast)
                return self._copy_out(cache.run(run, plan_dev, dict(
                    statics, **switches, U=U if uc else 0, use_compact=uc,
                    fast_heavy=fh, w_max=w_max, lb_log2=self._lb_log2,
                    L2=L2, H2=H2,
                )), mark=mark)

            if unified:
                # light entries folded into the heavy product (K5); a guard
                # trip relaunches the exact full-table packed kernel
                first = self._copy_out(cache.run(
                    unified_impl, plan_dev,
                    dict(statics, U=U, fast_heavy=fast, L2=L2)), mark=mark)
            else:
                first = launch(fast, mark)
            if fast:
                return ("packedg", nq, k, K, first, lambda: launch(False),
                        perm, queries, fills)
            return ("packed", nq, k, K, first, perm, fills)

    @property
    def launch_caches(self) -> Dict[torch.device, LaunchCache]:
        """{device: launch cache}, as ShardedIndex has one per device."""
        return {self.launch_cache.device: self.launch_cache}

    warm_batch = warm_launches

    def search_batch_gather(self, handle) -> ResultColumns:
        """Wait for a search_batch_async launch and unpack its results as
        one ResultColumns, which reads as a QueryResult per query."""
        with GLOBAL_TRACER.span("index.gather"):
            tag = handle[0]
            if tag == "empty" or tag == "fills":
                nq = handle[1]
                return ResultColumns.build(
                    np.zeros((nq, 0), np.float32), np.zeros((nq, 0), np.int32),
                    np.zeros(nq, np.int32),
                    fills=handle[3] if tag == "fills" else None)
            perm = fills = None
            if tag == "packedg":
                _tag, nq, k, K, pending, relaunch, perm, queries, fills = (
                    handle)
                with GLOBAL_TRACER.span("index.wait"):
                    (out,) = pending.wait()
                tripped = np.flatnonzero(out[:nq, 2 * K + 1] < 0.5)
                if tripped.size:
                    GLOBAL_TRACER.count("index.guard_trips", int(tripped.size))
                    out = self._guard_trip(out, tripped, relaunch, queries,
                                           nq, K)
            elif tag == "pending":  # exact and fast modes: three arrays
                _tag, nq, k, K, pending = handle
                with GLOBAL_TRACER.span("index.wait"):
                    arrays = pending.wait()
            else:
                _tag, nq, k, K, pending, perm, fills = handle
                with GLOBAL_TRACER.span("index.wait"):
                    (out,) = pending.wait()
            with GLOBAL_TRACER.span("index.unpack"):
                w = min(k, K)
                if tag == "pending":
                    vals, slots, found = (a[:nq] for a in arrays)
                    vals, slots = vals[:, :w], slots[:, :w]
                else:
                    vals, slots, found = _unpack(out[:nq], K, w)
                return ResultColumns.build(vals, slots, found, perm, fills)

    def _guard_trip(self, out, tripped, relaunch, queries, nq, K):
        """The packed result once the fast launch's one-pass merged-pool
        selection could not prove the top-K for the `tripped` queries:
        rescued on the host (index.rescue), or the whole batch relaunched
        exactly (index.relaunch). A query of one df-head term and a few
        light postings is answered from the row top-k table (_head_answer,
        well under a millisecond). Any other goes to the exact oracle,
        which passes over every document of the index and the query's
        postings, on one core, while the gather waits: at most
        NEXTSEARCH_TRIP_RESCUE (8) of them a batch, each within
        RESCUE_WORK elements, or the batch relaunches instead."""
        cap = int(os.environ.get("NEXTSEARCH_TRIP_RESCUE", "8"))
        with GLOBAL_TRACER.span("index.rescue"):
            t0 = time.perf_counter()
            answers = {int(j): self._head_answer(queries[int(j)], K)
                       for j in tripped}
            rest = [queries[j] for j, a in answers.items() if a is None]
            work = (self.n_docs + self._query_postings(rest)
                    if rest else [0])
            rescue = len(rest) <= cap and int(max(work)) <= RESCUE_WORK
            if rescue:
                for j in tripped:
                    self._host_rescue_row(out, int(j), queries, K,
                                          answers[int(j)])
            dt = (time.perf_counter() - t0) * 1000.0
        if not rescue:
            log("sparse", f"fast-heavy guard tripped ({tripped.size}/"
                f"{nq} queries, past the host's rescue); relaunching "
                f"exact-precision kernel")
            self.relaunches += 1
            GLOBAL_TRACER.count("index.relaunches")
            with GLOBAL_TRACER.span("index.relaunch"):
                (out,) = relaunch().wait()
            return out
        self.rescue_ms += dt
        self.rescue_trips += int(tripped.size)
        GLOBAL_TRACER.count("index.rescued", int(tripped.size))
        log("sparse", f"fast-heavy guard tripped ({tripped.size}/"
            f"{nq} queries); host rescue {dt:.1f}ms, "
            f"{tripped.size - len(rest)} from the row top-k table, the "
            f"oracle over {int(sum(work))} elements")
        if os.environ.get("NEXTSEARCH_TRIP_LOG") == "1":
            for j in tripped:
                terms = queries[int(j)]
                dfs = [
                    int(sum(lex.get(t, (0, 0, -1))[1] for lex in self.lex))
                    for t, _w in terms
                ]
                log("trip", f"q={[t for t, _ in terms]} dfs={dfs}")
        return out

    def hbm_bytes(self) -> Dict[str, int]:
        """Device footprint of the serving index, bytes by component."""
        out: Dict[str, int] = {}
        for name in ("post_doc", "post_score", "dense_rows", "bucket_pos",
                     "light_bucket_pos"):
            arr = getattr(self, name)
            if arr is not None:
                out[name] = int(arr.numel() * arr.element_size())
        out["total"] = sum(out.values())
        return out
