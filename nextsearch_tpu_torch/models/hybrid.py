"""Hybrid retrieval: BM25 candidate generation + dense rerank on the device.
The port of nextsearch_tpu/models/hybrid.py over a TorchIndex or a
ShardedIndex.

BASELINE config 5 ("BM25 candidates + semantic_embedding dense rerank").
The reference has no document embeddings; they are derived at build time as
the tf-weighted sum of each document's term embeddings (terms the
SemanticIndex knows), L2-normalized — the classic fastText-style doc
vector. Query embeddings use the same construction over the weighted query
terms.

Final score: beta * bm25/max_bm25(query) + (1-beta) * max(cos, 0), reranked
on the device (ops/dense.hybrid_rerank) straight from the BM25 launch's
device tensors (_HostCopy.device_outs): nothing round-trips through the
host between the two. A sharded sparse index's handles are gathered on the
host first and then reranked ("hybrid_host"), as in the reference.

The device build adds the doc vectors with index_add_, whose adds land in
any order on a card (atomics), so two builds may differ in the last bits;
the exact check of a hybrid result is _host_hybrid_row over the same
doc_emb.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..index.planner import QueryResult, WeightedTerm
from ..index.segment import _HostCopy, _upload
from ..ops.dense import hybrid_rerank
from .semantic import SemanticIndex


def _emb_normalize(doc_emb: torch.Tensor) -> torch.Tensor:
    norms = torch.sqrt(torch.sum(doc_emb * doc_emb, dim=1, keepdim=True))
    return doc_emb / torch.where(norms == 0.0, torch.ones_like(norms), norms)


def _unpack(out: torch.Tensor, K: int):
    """(vals, doc slots, found) of a packed f32 [Q, 2K + 1 (+ guard)]
    result on the device."""
    return (out[:, :K], out[:, K: 2 * K].to(torch.int32),
            out[:, 2 * K].to(torch.int32))


def _posting_rows(seg, sem: SemanticIndex):
    """A segment's postings whose term the SemanticIndex knows: (local doc
    int64, embedding row int64, tf f32), in posting order."""
    rows = np.array([sem.term_to_row.get(t, -1) for t in seg.terms], np.int64)
    row_per_post = np.repeat(rows, np.diff(seg.term_offsets))
    known = row_per_post >= 0
    return (seg.post_doc[known].astype(np.int64), row_per_post[known],
            seg.post_tf[known].astype(np.float32))


class HybridIndex:
    """Doc-embedding store + rerank over a TorchIndex's candidates, on the
    index's device."""

    def __init__(
        self,
        index,
        sem: SemanticIndex,
        beta: float = 0.5,
        chunk: int = 262144,
    ):
        assert sem.enabled, "hybrid rerank needs a loaded SemanticIndex"
        self.index = index
        self.sem = sem
        self.beta = float(beta)
        self.device = index.device
        torch.backends.cuda.matmul.allow_tf32 = False
        d = sem.dim
        n_slots = index.slot_capacity
        device_build = (
            os.environ.get("NEXTSEARCH_HYBRID_DEVICE_BUILD", "1") == "1"
        )
        if device_build:
            # Only the per-posting (doc, term row, tf) triples go up, in
            # fixed-size chunks; the tf-weighted rows are added into the
            # [n_slots, d] accumulator on the device and normalized there.
            emb = torch.as_tensor(sem._emb_host, device=self.device)
            doc_emb = torch.zeros((n_slots, d), dtype=torch.float32,
                                  device=self.device)
            CH = max(int(chunk), 1)
            for seg, dbase in zip(index.segments, index.segment_slot_bases()):
                docs, rws, tfs = _posting_rows(seg, sem)
                docs = docs + dbase
                for lo in range(0, docs.shape[0], CH):
                    hi = min(lo + CH, docs.shape[0])
                    d_c = torch.as_tensor(docs[lo:hi], device=self.device)
                    r_c = torch.as_tensor(rws[lo:hi], device=self.device)
                    t_c = torch.as_tensor(tfs[lo:hi], device=self.device)
                    doc_emb.index_add_(0, d_c, emb[r_c] * t_c[:, None])
            self.doc_emb = _emb_normalize(doc_emb)
            del doc_emb, emb
        else:
            emb_host = sem._emb_host
            doc_emb = np.zeros((n_slots, d), np.float32)
            for seg, dbase in zip(index.segments, index.segment_slot_bases()):
                docs, rws, tfs = _posting_rows(seg, sem)
                np.add.at(doc_emb, docs + dbase, emb_host[rws] * tfs[:, None])
            norms = np.linalg.norm(doc_emb, axis=1)
            norms[norms == 0.0] = 1.0
            doc_emb /= norms[:, None]
            self.doc_emb = torch.as_tensor(doc_emb, device=self.device)

    def query_embedding(self, terms: Sequence[WeightedTerm]) -> np.ndarray:
        d = self.sem.dim
        q = np.zeros(d, np.float32)
        for t, w in terms:
            v = self.sem.get_vec(t)
            if v is not None:
                q += np.float32(w) * v
        n = float(np.linalg.norm(q))
        if n > 0:
            q = q / np.float32(n)
        return q

    def search_batch_async(
        self,
        queries: Sequence[Sequence[WeightedTerm]],
        k: int,
        candidates: int = 100,
    ):
        """Launch BM25 top-`candidates` + the dense rerank; no host sync.

        The BM25 handle's device tensors feed hybrid_rerank directly, so
        callers can pipeline hybrid launches exactly like
        TorchIndex.search_batch_async. Which tensors a handle holds depends
        on the index's mode, so the dispatch goes by index._sparse and the
        handle's tag: fused "packed" and exact/fast "pending" carry the
        whole batch; a single-device sparse index's "packed"/"packedg"
        carry the launched rows (permuted by perm, with host-shortcut
        answers in fills, and under fast mode the guard column) and its
        "fills" no launch at all. A sharded sparse index's handles (no
        doc_bases) are gathered on the host, then reranked."""
        nq = len(queries)
        if nq == 0 or self.index.n_docs == 0:
            return ("hybrid_trivial", nq)

        C = max(candidates, k)
        handle = self.index.search_batch_async(queries, C)
        tag = handle[0]
        if tag == "empty":
            return ("hybrid_passthrough", handle)
        perm = None
        guard = None
        fills = None
        bm_queries = queries
        # a single-device sparse index: its handles chain on the device
        sparse_direct = self.index._sparse and hasattr(self.index, "doc_bases")
        if tag == "pending":  # exact and fast modes: three tensors
            _tag, _nq, _k, K, pending = handle
            vals, idx, found = pending.device_outs
        elif not self.index._sparse and tag == "packed":
            # fused mode's packed result, ids as exact f32 values
            _tag, _nq, _k, K, pending = handle[:5]
            vals, idx, found = _unpack(pending.device_outs[0], K)
        elif sparse_direct and tag == "fills":
            # whole batch answered host-side: rerank the fill candidates
            # in one launch (no BM25 launch happened)
            _tag, _nq, _k, fills_all = handle
            K = C
            vals, idx, found = (
                _upload(a, self.device)
                for a in self._fill_arrays(fills_all, nq, C, None))
        elif sparse_direct and tag in ("packed", "packedg"):
            if tag == "packedg":
                _tag, _nq, _k, K, pending, _relaunch, perm, _q, fills = handle
            else:
                _tag, _nq, _k, K, pending, perm, fills = handle
            dev_out = pending.device_outs[0]
            vals, idx, found = _unpack(dev_out, K)
            if tag == "packedg":
                guard = dev_out[:, 2 * K + 1]
            if perm is not None:
                bm_queries = [queries[perm[j]] for j in range(nq)]
            if fills:
                # splice host-shortcut rows into the device candidates
                # (row j in launch space answers original index perm[j];
                # rows past the live query count are envelope padding)
                Qb = int(vals.shape[0])
                n_live = min(Qb, len(perm) if perm is not None else nq)
                f_vals, f_idx, f_found = self._fill_arrays(
                    fills, Qb, min(C, K), perm, n_live
                )
                mask = np.zeros((Qb, 1), bool)
                rows = [
                    j for j in range(n_live)
                    if (int(perm[j]) if perm is not None else j) in fills
                ]
                mask[rows] = True
                mask_d = _upload(mask, self.device)
                pad = K - f_vals.shape[1]
                if pad:
                    f_vals = np.pad(f_vals, ((0, 0), (0, pad)))
                    f_idx = np.pad(
                        f_idx, ((0, 0), (0, pad)), constant_values=2**30
                    )
                vals = torch.where(mask_d, _upload(f_vals, self.device), vals)
                idx = torch.where(mask_d, _upload(f_idx, self.device), idx)
                found = torch.where(
                    mask_d[:, 0], _upload(f_found, self.device), found
                )
        else:
            # sharded sparse handles are gathered host-side first
            q_emb = np.stack([self.query_embedding(q) for q in queries])
            return ("hybrid_host", nq, k, C, handle, q_emb)

        q_emb = np.stack([self.query_embedding(q) for q in bm_queries])
        Qb = vals.shape[0]
        if q_emb.shape[0] < Qb:
            q_emb = np.vstack(
                [q_emb, np.zeros((Qb - q_emb.shape[0], self.sem.dim), np.float32)]
            )

        hvals, hdocs, hbm25 = hybrid_rerank(
            self.doc_emb, _upload(q_emb, self.device), idx, vals,
            self.beta, K=min(k, K),
        )
        outs = (hvals, hdocs, hbm25, found) + (
            (guard,) if guard is not None else ())
        return ("hybrid", nq, k, _HostCopy(*outs), perm, queries, C)

    def _fill_arrays(self, fills, rows, C, perm, n_live=None):
        """Host-shortcut QueryResults -> padded (vals, idx, found) arrays
        in LAUNCH row space (row j answers original index perm[j]; rows
        past n_live are envelope padding)."""
        vals = np.zeros((rows, C), np.float32)
        idx = np.full((rows, C), 2**30, np.int32)
        found = np.zeros(rows, np.int32)
        for j in range(rows if n_live is None else n_live):
            orig = int(perm[j]) if perm is not None else j
            qr = fills.get(orig)
            if qr is None:
                continue
            n = min(len(qr.scores), C)
            vals[j, :n] = qr.scores[:n]
            idx[j, :n] = qr.doc_slots[:n]
            found[j] = qr.found
        return vals, idx, found

    def search_batch_gather(self, handle) -> List[QueryResult]:
        """Block on a search_batch_async handle and assemble results."""
        if handle[0] == "hybrid_trivial":
            return [
                QueryResult(np.empty(0, np.float32), np.empty(0, np.int32), 0)
            ] * handle[1]
        if handle[0] == "hybrid_passthrough":
            return self.index.search_batch_gather(handle[1])
        if handle[0] == "hybrid_host":
            _tag, nq, k, C, bm_handle, q_emb = handle
            base = self.index.search_batch_gather(bm_handle)
            vals_h = np.zeros((nq, C), np.float32)
            idx_h = np.zeros((nq, C), np.int32)
            found_h = np.array([r.found for r in base], np.int32)
            for qi, r in enumerate(base):
                n = min(len(r.scores), C)
                vals_h[qi, :n] = r.scores[:n]
                idx_h[qi, :n] = r.doc_slots[:n]
            hvals, hdocs, hbm25 = hybrid_rerank(
                self.doc_emb, _upload(q_emb, self.device),
                _upload(idx_h, self.device), _upload(vals_h, self.device),
                self.beta, K=min(k, C),
            )
            handle = ("hybrid", nq, k, _HostCopy(
                hvals, hdocs, hbm25, _upload(found_h, self.device)),
                None, None, C)
        _tag, nq, k, pending, perm, orig_queries, C = handle
        outs = pending.wait()
        hvals, hdocs, hbm25, found = outs[:4]
        guard = outs[4] if len(outs) > 4 else None

        out: List[Optional[QueryResult]] = [None] * nq
        for qi in range(nq):
            pos = int(perm[qi]) if perm is not None else qi
            if guard is not None and guard[qi] < 0.5:
                # BM25 guard tripped for this row: the fast candidates may
                # be inexact — recompute exactly host-side (rare)
                out[pos] = self._host_hybrid_row(orig_queries[pos], k, C)
                continue
            keep = hbm25[qi] > 0.0
            out[pos] = QueryResult(
                scores=hvals[qi][keep][:k],
                doc_slots=hdocs[qi][keep][:k],
                found=int(found[qi]),
            )
        return out  # type: ignore[return-value]

    def _host_hybrid_row(self, query, k: int, C: int) -> QueryResult:
        """Exact hybrid result for one query: host-oracle BM25 top-C +
        the rerank formula over the candidates' doc embeddings, read back
        from the device (guard-trip fix-up; also the parity oracle for
        config 5)."""
        from ..index.oracle import oracle_search_vec

        bm = self.index.config.bm25
        hits, found = oracle_search_vec(
            self.index._oracle_segs(), query, C, k1=bm.k1, b=bm.b,
        )
        if not hits:
            return QueryResult(
                np.empty(0, np.float32), np.empty(0, np.int32), int(found)
            )
        bases = self.index.segment_slot_bases()
        cand = np.asarray(
            [bases[seg] + doc for _s, seg, doc in hits], np.int32
        )
        bm25 = np.asarray([s for s, _seg, _doc in hits], np.float32)
        q_emb = self.query_embedding(query)
        emb = self.doc_emb[torch.as_tensor(cand, device=self.device).long()]
        emb = emb.cpu().numpy()
        cos = np.maximum(emb @ q_emb.astype(np.float32), 0.0)
        denom = max(float(bm25.max()), 1e-30)
        hybrid = (
            np.float32(self.beta) * (bm25 / np.float32(denom))
            + np.float32(1.0 - self.beta) * cos.astype(np.float32)
        )
        order = np.lexsort((cand, -hybrid))
        order = order[bm25[order] > 0][:k]
        return QueryResult(
            scores=hybrid[order].astype(np.float32),
            doc_slots=cand[order],
            found=int(found),
        )

    def search_batch(
        self,
        queries: Sequence[Sequence[WeightedTerm]],
        k: int,
        candidates: int = 100,
    ) -> List[QueryResult]:
        """BM25 top-`candidates` then the dense rerank to top-k."""
        return self.search_batch_gather(
            self.search_batch_async(queries, k, candidates)
        )
