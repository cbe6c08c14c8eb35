"""TorchIndex: the sparse-mode DeviceIndex with its device side in PyTorch.

The host planner of nextsearch_tpu/index/segment.py (lexicons, dense-row
assignment, light bucket table, 1-term shortcut tables, plan_sparse,
_plan_groups, pin_shapes and the budgets, host rescue and its memo,
locate/doc_info) is numpy and is inherited unchanged. What touched jax is
overridden here: the uploads in __init__, the launch, the gather with its
guard relaunch, the row top-k build and hbm_bytes.

Results come back through a non-blocking copy into a pinned host buffer and
a CUDA event that search_batch_gather waits on, so the host can plan and
launch the next batch while this one runs.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from nextsearch_tpu.config import DEFAULT_CONFIG, EngineConfig
from nextsearch_tpu.index.builder import SegmentArrays, eager_scores
from nextsearch_tpu.index.segment import (
    DeviceIndex,
    QueryResult,
    WeightedTerm,
    _bucket,
    _deal_sorted,
    _log_build_phases,
    _round_up,
)
from nextsearch_tpu.utils.logging import log

from ..ops.bm25_sparse import (
    LIGHT_BUCKET_LOG2, packed_impl, packed_multi, unified_impl,
)
from .device_build import build_heavy_on_device

# Environment switches that pick reference paths the port does not carry.
_UNPORTED_ENV = (
    ("NEXTSEARCH_DEVICE_BUILD", "1", "host-built dense rows", "queue 1 item 5"),
    ("NEXTSEARCH_LIGHT_BUILD", "host", "device-built light table",
     "queue 1 item 5"),
    ("NEXTSEARCH_ROW_TOPK_BUILD", "host", "device-built row top-k",
     "queue 1 item 5"),
)


class _HostCopy:
    """A packed result on its way to the host: a non-blocking copy into a
    pinned buffer plus the CUDA event that marks its completion (on the
    CPU the tensor is already host memory)."""

    def __init__(self, out: torch.Tensor):
        if out.device.type == "cuda":
            self.host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            self.host.copy_(out, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(out.device))
        else:
            self.host = out
            self.event = None

    def wait(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


class TorchIndex(DeviceIndex):
    """Immutable multi-segment sparse-mode index resident on `device`."""

    def __init__(
        self,
        segments: Sequence[SegmentArrays],
        seg_names=None,
        config: EngineConfig = DEFAULT_CONFIG,
        *,
        device,
    ):
        dcfg = config.device
        if dcfg.mode != "sparse":
            raise NotImplementedError(
                f"mode={dcfg.mode!r} is not ported (only 'sparse'): "
                "ROADMAP queue 1 item 6"
            )
        if dcfg.dense_rows_bf16:
            raise NotImplementedError(
                "bf16 dense rows are not ported: ROADMAP queue 1 item 12"
            )
        for env, default, what, item in _UNPORTED_ENV:
            if os.environ.get(env, default) != default:
                raise NotImplementedError(
                    f"{env}: {what} is not ported: ROADMAP {item}"
                )
        self.device = torch.device(device)

        phases: List[Tuple[str, float]] = []
        t_last = [time.perf_counter()]

        def tick(name: str) -> None:
            now = time.perf_counter()
            phases.append((name, now - t_last[0]))
            t_last[0] = now

        self.host_only = False
        self.config = config
        self._pins: Dict[str, int] = {}
        self._qpins: Dict[int, Dict[str, int]] = {}
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
        # heavy kernels tile the doc axis in 2048-doc tiles
        pad = _round_up(dcfg.doc_pad, 2048)
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
        self._sparse = True
        self._heavy_direct = True
        # multi-segment: one merged dense row per heavy term (see the
        # reference's DeviceIndex.__init__ for why this is bit-exact)
        self._merged_heavy = len(self.segments) > 1

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
        row_cap = min(
            dcfg.dense_max_rows,
            max(0, int(dcfg.dense_max_bytes // (4 * self.n_slots))),
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

        # Light bucket-position table (host-built, one upload): one row per
        # light (term, segment), first-posting offset per 2^lb_log2-slot
        # bucket; row n_light is the zero sentinel. Granularity coarsens
        # until the table fits its byte budget, as in the reference.
        self._light_row: List[Dict[str, int]] = []
        self._lb_log2 = LIGHT_BUCKET_LOG2
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
            if lt_idx.shape[0]:
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
        light_host = np.zeros((base_row + 1, nbl + 1), np.int32)
        light_max_occ = 0
        if counts_parts:
            counts = np.concatenate(counts_parts, axis=0)
            light_max_occ = int(counts.max(initial=0))
            np.cumsum(counts, axis=1, out=light_host[:base_row, 1:])
        self._bs_depth = max(2, int(max(light_max_occ, 1)).bit_length())
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
        self.dense_rows = build_heavy_on_device(
            self.post_doc, self.post_score, h_starts, h_dfs, rows=h_rows,
            n_rows_pad=nd1_pad, n_slots=self.n_slots,
        )
        self.light_bucket_pos = torch.as_tensor(light_host, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        tick("heavy_device_build")
        self._build_row_topk(post_doc, post_score)
        tick("row_topk")
        self._build_light_topk(post_doc_parts, post_score_parts)
        tick("light_topk")
        self._build_merged_lex()
        tick("merged_lex")
        _log_build_phases(phases)

    def _build_row_topk(self, post_doc_np=None, post_score_np=None) -> None:
        """Exact canonical top-k of the df-head dense rows, from the host
        postings (the reference's default host path)."""
        dcfg = self.config.device
        self._row_topk = None
        n = min(self.n_dense, dcfg.row_topk_rows)
        k = min(dcfg.row_topk_k, self.n_slots)
        if n > 0 and k > 0:
            self._row_topk = self._row_topk_host(n, k, post_doc_np, post_score_np)

    # ---------------- execution ----------------

    def search_batch_async(self, queries: Sequence[Sequence[WeightedTerm]],
                           k: int, shortcut: bool = True):
        """Launch one batched sparse search; returns an opaque handle for
        search_batch_gather. shortcut=False disables the host-side 1-term
        and rescue-memo answers."""
        nq = len(queries)
        if nq == 0 or self.n_docs == 0:
            return ("empty", nq)
        return self._search_sparse_async(queries, k, shortcut=shortcut)

    def _search_sparse_async(self, queries, k: int, shortcut: bool = True):
        nq = len(queries)
        K = min(_bucket(max(k, 1), self.K_BUCKETS), self.n_slots)
        queries, fills = (
            self._shortcut_single_heavy(queries, k) if shortcut
            else (queries, None)
        )
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

        dcfg = self.config.device
        g = self._pins.get("Q") or dcfg.launch_group
        # Under the selection kernel K4, order queries by light window so
        # the long windows sit together (the reference does so for its
        # kernel's per-program block count, segment.py:1473-1506); dealt
        # round-robin over launch groups so each group keeps its share.
        # Undone at gather. NEXTSEARCH_SORT_QUERIES=1 forces it (tests).
        perm = None
        forced = os.environ.get("NEXTSEARCH_SORT_QUERIES") == "1"
        select_kernel = os.environ.get("NEXTSEARCH_SELECT_PALLAS", "0") == "1"
        if (select_kernel or forced) and nq > 1:
            wins = self._query_windows(queries)
            if wins.size and (wins.max() > 1024 or forced):
                order = np.argsort(wins, kind="stable")
                perm = _deal_sorted(order, g) if g and nq > g else order
                queries = [queries[i] for i in perm]
        fast = (
            dcfg.fast_heavy
            and os.environ.get("NEXTSEARCH_FAST_HEAVY", "1") == "1"
        )
        use_compact = os.environ.get("NEXTSEARCH_COMPACT_HEAVY", "1") == "1"
        block = dcfg.posting_block
        unified = False
        if g and nq > g:
            plans, U = self._plan_groups(queries, g)
            groups = range(plans.shape[0])
            C = max(self._chunk_budget(plans[gi, 1], block) for gi in groups)
            L2 = max(self._light_budget(plans[gi]) for gi in groups)
            H2 = max(self._heavy_budget(plans[gi]) for gi in groups)
            run, plan, w_max = packed_multi, plans, self._sel_window(plans[:, 1])
        else:
            plan, U = self.plan_sparse(queries)
            C = self._chunk_budget(plan[1], block)
            L2 = self._light_budget(plan)
            H2 = self._heavy_budget(plan)
            # the unified kernel runs over the compact table at the default
            # light bucket granularity, single launches only (as the
            # reference, segment.py:1580-1589)
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
        plan_dev = torch.from_numpy(plan)
        if self.device.type == "cuda":
            # pinned + non_blocking: a pageable upload would wait for the
            # batch still running on the card and stall the pipeline
            plan_dev = plan_dev.pin_memory().to(self.device, non_blocking=True)
        statics = dict(
            n_slots=self.n_slots, K=K, K2=K2, C=C, block=block,
            bs_steps=self._bs_depth, nd=self.n_dense, nl=self.n_light,
            heavy_direct=self._heavy_direct, guard_eps=dcfg.fast_heavy_eps,
        )
        tables = (self.post_doc, self.post_score, self.dense_rows,
                  self.light_bucket_pos, plan_dev)

        def launch(fh: bool) -> _HostCopy:
            # the exact relaunch under fast mode runs over the full stored
            # table (no compact f32 gather buffer), as in the reference
            uc = use_compact and (fh or not fast)
            out = run(
                *tables, U=U if uc else 0, use_compact=uc, fast_heavy=fh,
                w_max=w_max,
                h_bf16=os.environ.get("NEXTSEARCH_H_BF16", "0") == "1",
                lb_log2=self._lb_log2, L2=L2, H2=H2, **statics,
            )
            return _HostCopy(out)

        if unified:
            # light entries folded into the heavy product (K5); a guard
            # trip relaunches the exact full-table packed kernel
            first = _HostCopy(unified_impl(
                *tables, U=U, fast_heavy=fast, L2=L2, **statics))
        else:
            first = launch(fast)
        if fast:
            return ("packedg", nq, k, K, first, lambda: launch(False), perm,
                    queries, fills)
        return ("packed", nq, k, K, first, perm, fills)

    def search_batch_gather(self, handle) -> List[QueryResult]:
        """Wait for a search_batch_async launch and unpack its results."""
        tag = handle[0]
        if tag == "empty":
            nq = handle[1]
            return [
                QueryResult(np.empty(0, np.float32), np.empty(0, np.int32), 0)
            ] * nq
        if tag == "fills":
            _tag, nq, _k, fills = handle
            return [fills[qi] for qi in range(nq)]
        if tag == "packedg":
            _tag, nq, k, K, pending, relaunch, perm, queries, fills = handle
            out = pending.wait()
            tripped = np.flatnonzero(out[:nq, 2 * K + 1] < 0.5)
            if tripped.size:
                # The one-pass merged-pool selection could not prove the
                # top-K for these queries: rescue a few on the host with
                # the exact oracle, or relaunch the whole batch exactly.
                cap = int(os.environ.get("NEXTSEARCH_TRIP_RESCUE", "8"))
                if tripped.size <= cap:
                    t0 = time.perf_counter()
                    for j in tripped:
                        self._host_rescue_row(out, int(j), queries, K)
                    dt = (time.perf_counter() - t0) * 1000.0
                    self.rescue_ms += dt
                    self.rescue_trips += int(tripped.size)
                    log("sparse", f"fast-heavy guard tripped ({tripped.size}/"
                        f"{nq} queries); host-oracle rescue {dt:.1f}ms")
                    if os.environ.get("NEXTSEARCH_TRIP_LOG") == "1":
                        for j in tripped:
                            terms = queries[int(j)]
                            dfs = [
                                int(sum(lex.get(t, (0, 0, -1))[1]
                                        for lex in self.lex))
                                for t, _w in terms
                            ]
                            log("trip", f"q={[t for t, _ in terms]} dfs={dfs}")
                else:
                    log("sparse", f"fast-heavy guard tripped ({tripped.size}/"
                        f"{nq} queries); relaunching exact-precision kernel")
                    self.relaunches += 1
                    out = relaunch().wait()
        else:
            _tag, nq, k, K, pending, perm, fills = handle
            out = pending.wait()
        vals = out[:, :K]
        idx = out[:, K: 2 * K].astype(np.int32)
        found = out[:, 2 * K].astype(np.int32)
        res: List[QueryResult] = []
        for qi in range(nq):
            keep = vals[qi] > 0.0
            keep[min(k, K):] = False
            res.append(QueryResult(
                scores=vals[qi][keep][:k],
                doc_slots=idx[qi][keep][:k],
                found=int(found[qi]),
            ))
        if perm is not None:
            unperm = [res[0]] * nq
            for j in range(nq):
                unperm[perm[j]] = res[j]
            res = unperm
        if fills:
            for qi, qr in fills.items():
                res[qi] = qr
        return res

    def hbm_bytes(self) -> Dict[str, int]:
        """Device footprint of the serving index, bytes by component."""
        out: Dict[str, int] = {}
        for name in ("post_doc", "post_score", "dense_rows", "light_bucket_pos"):
            arr = getattr(self, name)
            out[name] = int(arr.numel() * arr.element_size())
        out["total"] = sum(out.values())
        return out
