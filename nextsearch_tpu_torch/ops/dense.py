"""Dense embedding ops: the port of nextsearch_tpu/ops/dense.py.

similarity_topk replaces the reference's brute-force O(V*d) scalar cosine
scans (src/semantic_embedding.cpp:104-145) with one f32 product over the
normalized embedding matrix plus a masked top-k; hybrid_rerank is the dense
rerank of BM25 candidates (BASELINE config 5). The JAX package computes
these with XLA ops, outside any Pallas kernel, so here they are torch ops.

Products are true f32: each function refuses to run a product on a card
while torch.backends.cuda.matmul.allow_tf32 is on (TorchIndex, Engine and
SemanticIndex construction turn it off). Top-k ties go to the lower index,
as lax.top_k's and lax.sort's do, through unique int64 keys; products and
sums stay separate ops (no FMA contraction).
"""

from __future__ import annotations

import numpy as np
import torch

from .bm25 import PAD_DOC, f32_order_key, topk_low_index


def _check_f32(t: torch.Tensor, name: str) -> None:
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"{name}: torch.backends.cuda.matmul.allow_tf32 "
                           "is on; the product must be f32")


def similarity_topk(emb: torch.Tensor, qvecs: torch.Tensor,
                    banned: torch.Tensor, min_sim: float, *, k: int):
    """Per query-vector top-k most similar rows with sim >= min_sim.

    emb f32 [V, d] (L2-normalized rows), qvecs f32 [n, d], banned bool [V].
    Returns (sims f32 [n, k], rows int32 [n, k]); slots that fail the floor
    or fall in the banned set carry sim = -inf. Ties break toward the lower
    row."""
    _check_f32(emb, "similarity_topk")
    sims = torch.matmul(qvecs, emb.T)  # [n, V]
    neg = torch.full((), float("-inf"), dtype=torch.float32, device=emb.device)
    sims = torch.where(banned[None, :], neg, sims)
    sims = torch.where(sims < min_sim, neg, sims)
    vals, rows = topk_low_index(sims, k)
    return vals, rows.to(torch.int32)


def matvec_scores(emb: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Similarity of one vector against all rows (f32 matvec)."""
    _check_f32(emb, "matvec_scores")
    return torch.matmul(emb, q)


def hybrid_rerank(doc_emb: torch.Tensor, q_emb: torch.Tensor,
                  cand: torch.Tensor, bm25: torch.Tensor, beta: float, *,
                  K: int):
    """Dense rerank of BM25 candidates (BASELINE config 5).

    doc_emb f32 [N_pad, d] (L2-normalized), q_emb f32 [Q, d], cand int32
    [Q, C] candidate doc slots, bm25 f32 [Q, C] (0 = dead slot).
    hybrid = beta * bm25 / max_bm25 + (1 - beta) * max(cos(q, doc), 0), then
    the top K in the canonical (hybrid desc, doc slot asc) order, dead slots
    (bm25 <= 0) last with doc 2^30. Returns (hybrid f32 [Q, k], doc int32
    [Q, k], bm25 of the winners f32 [Q, k]), k = min(K, C)."""
    _check_f32(doc_emb, "hybrid_rerank")
    alive = bm25 > 0
    rows = cand.clamp(0, doc_emb.shape[0] - 1).long()
    gathered = doc_emb[rows]  # [Q, C, d]
    cos = torch.bmm(gathered, q_emb.unsqueeze(2)).squeeze(2)
    cos = torch.clamp_min(cos, 0.0)
    denom = torch.clamp_min(bm25.max(dim=1, keepdim=True).values, 1e-30)
    # both weights as f32 values (1 - beta subtracted in f32, as the JAX
    # function does), so the Python scalars convert to f32 exactly
    b = np.float32(beta)
    hybrid = float(b) * (bm25 / denom) + float(np.float32(1.0) - b) * cos
    neg = torch.where(alive, -hybrid,
                      torch.full_like(hybrid, float("inf")))
    sort_doc = torch.where(alive, cand.to(torch.int64),
                           torch.full_like(cand, PAD_DOC, dtype=torch.int64))
    key = (f32_order_key(neg) << 31) | sort_doc
    key_s, order = torch.sort(key, dim=1, stable=True)
    k = min(K, cand.shape[1])
    sdoc = (key_s[:, :k] & ((1 << 31) - 1)).to(torch.int32)
    order = order[:, :k]
    return (torch.gather(hybrid, 1, order), sdoc,
            torch.gather(bm25, 1, order))
