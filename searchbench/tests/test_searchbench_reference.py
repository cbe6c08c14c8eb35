"""The plain reference against a brute-force BM25 over each document's own
term counts, and the corpus generator's arrays against their definition."""

from __future__ import annotations

import math

import numpy as np
import torch

from searchbench.corpus import generate
from searchbench.reference import Bm25Reference, round_mantissa

CFG = {"n_docs": 400, "mean_tokens": 15, "vocab": 300,
       "zipf_s": 1.07, "query_terms": [1, 4], "k": 10}


def brute_force(corpus, terms):
    """Each document's BM25 from a dict of its term counts, in Python
    floats (the IDF's argument in float32, as the reference states)."""
    tf = [dict() for _ in range(corpus.n_docs)]
    for t in range(corpus.vocab):
        lo, hi = corpus.term_offsets[t], corpus.term_offsets[t + 1]
        for d, f in zip(corpus.post_doc[lo:hi], corpus.post_tf[lo:hi]):
            tf[int(d)][t] = int(f)
    dl = [sum(c.values()) for c in tf]
    avgdl = sum(dl) / len(dl)
    df = corpus.term_df
    out = np.zeros(corpus.n_docs)
    for d in range(corpus.n_docs):
        for t in terms:
            f = tf[d].get(t, 0)
            if f:
                f32 = np.float32
                arg = ((f32(corpus.n_docs - int(df[t])) + f32(0.5))
                       / (f32(int(df[t])) + f32(0.5)) + f32(1.0))
                w = math.log(float(arg))
                out[d] += w * f * 2.2 / (f + 1.2 * (0.25 + 0.75 * dl[d] / avgdl))
    return out


def test_reference_equals_brute_force():
    corpus = generate(CFG, 7, "cpu")
    assert corpus.n_postings > 1000
    ref = Bm25Reference(corpus.term_offsets, corpus.post_doc, corpus.post_tf,
                        corpus.doc_len, "cpu")
    for terms in ([0], [3, 17], [1, 2, 150, 299]):
        want = brute_force(corpus, terms)
        got = ref.scores(terms).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
        a = ref.answer(terms, 10)
        order = np.lexsort((np.arange(len(want)), -want))[:10]
        order = order[want[order] > 0]
        assert a.docs.tolist() == order.tolist()
        assert a.found == int((want > 0).sum())


def test_corpus_arrays():
    corpus = generate(CFG, 11, "cpu")
    again = generate(CFG, 11, "cpu")
    assert np.array_equal(corpus.post_doc, again.post_doc)
    assert not np.array_equal(corpus.post_doc,
                              generate(CFG, 12, "cpu").post_doc)
    off = corpus.term_offsets
    for t in range(corpus.vocab):
        docs = corpus.post_doc[off[t]:off[t + 1]]
        assert np.all(np.diff(docs) > 0)
    lens = np.bincount(corpus.post_doc, weights=corpus.post_tf,
                       minlength=corpus.n_docs)
    assert np.array_equal(lens, corpus.doc_len)
    assert corpus.post_tf.min() >= 1 and not corpus.post_doc.flags.writeable


def test_round_mantissa():
    x = torch.rand(10000, dtype=torch.float32) * 7
    assert torch.equal(round_mantissa(x, 7), x.bfloat16().float())
    tf32 = round_mantissa(x, 10)
    assert torch.all((tf32 - x).abs() <= x.abs() * 2.0 ** -11)
