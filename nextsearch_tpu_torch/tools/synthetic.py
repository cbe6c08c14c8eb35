"""The bench corpus and query stream (bench.py build_corpus and
sample_queries), kept here because bench.py enables the JAX compile cache
when it is imported. Same arrays from the same seeds."""

from __future__ import annotations

import numpy as np

from nextsearch_tpu.index.builder import SegmentArrays, eager_scores


def zipf_probs(vocab: int) -> np.ndarray:
    probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
    return probs / probs.sum()


def build_corpus(n_docs: int, vocab: int, seed: int = 0):
    """Zipf-distributed synthetic corpus built directly as segment arrays
    (no per-doc tokenization). Returns (segment, term probabilities)."""
    r = np.random.default_rng(seed)
    avg_len = 120
    doc_len = np.maximum(1, r.poisson(avg_len, n_docs)).astype(np.int64)
    probs = zipf_probs(vocab)

    # ~doc_len/2 unique terms per doc; duplicate (doc, term) draws add tf
    uniq = np.maximum(1, doc_len // 2)
    total = int(uniq.sum())
    terms_flat = r.choice(vocab, size=total, p=probs).astype(np.int64)
    docs_flat = np.repeat(np.arange(n_docs, dtype=np.int64), uniq)

    key = docs_flat * vocab + terms_flat
    key_sorted = np.sort(key)
    uniq_key, counts = np.unique(key_sorted, return_counts=True)
    post_doc = (uniq_key // vocab).astype(np.int32)
    post_term = (uniq_key % vocab).astype(np.int32)
    post_tf = counts.astype(np.int32)

    # CSR by term (stable keeps doc ascending within a term)
    order = np.argsort(post_term, kind="stable")
    post_term = post_term[order]
    post_doc = post_doc[order]
    post_tf = post_tf[order]

    term_df = np.bincount(post_term, minlength=vocab).astype(np.int32)
    term_offsets = np.zeros(vocab + 1, np.int64)
    np.cumsum(term_df, out=term_offsets[1:])
    real_len = np.bincount(post_doc, weights=post_tf, minlength=n_docs).astype(np.int64)
    avgdl = float(np.float32(real_len.sum()) / np.float32(n_docs))

    seg = SegmentArrays(
        terms=[f"t{i:06d}" for i in range(vocab)],
        term_df=term_df,
        term_offsets=term_offsets,
        post_doc=post_doc,
        post_tf=post_tf,
        doc_len=real_len.astype(np.int32),
        N=n_docs,
        avgdl=avgdl,
        cord_uids=[f"uid{i}" for i in range(n_docs)],
    )
    seg.post_score = eager_scores(seg)
    return seg, probs


def sample_queries(probs, n_queries: int, batch: int, seed: int = 1):
    """Query stream of 1-4 Zipf-sampled distinct terms per query, cut into
    n_queries // batch batches."""
    r = np.random.default_rng(seed)
    cum = np.cumsum(probs)
    cum[-1] = 1.0
    n_terms = r.integers(1, 5, size=n_queries)
    total = int(n_terms.sum())
    tids = np.searchsorted(cum, r.random(total), side="right")
    ends = np.cumsum(n_terms)
    starts_q = ends - n_terms
    batches = []
    qi = 0
    for _ in range(n_queries // batch):
        qb = []
        for _b in range(batch):
            q = tids[starts_q[qi]:ends[qi]]
            # resample a query with a repeated term
            while len(set(q.tolist())) != len(q):
                q = np.searchsorted(cum, r.random(len(q)), side="right")
            qb.append([(f"t{t:06d}", 1.0) for t in q])
            qi += 1
        batches.append(qb)
    return batches
