"""The plain reference: BM25 worked out again from the raw postings.

Okapi BM25 with the reference engine's constants (k1 1.2, b 0.75) and its
IDF, log((N - df + 0.5) / (df + 0.5) + 1), from tf, df, the documents'
lengths, N and avgdl = sum(lengths) / N: a document's score is the sum over
the query's distinct terms of idf * tf * (k1 + 1) /
(tf + k1 * (1 - b + b * dl / avgdl)). The configurations state float32
scores, as the NextSearch engine defines them (C++ float arithmetic), so
the IDF's argument is formed in float32, operation by operation: for a term
in nearly every document it is 1 + a few 1e-5, and its float32 rounding
moves the IDF by up to 1e-3 of itself, which is the stated semantics and no
error. The log and everything after it are float64. It takes nothing that
the program made (no precomputed scores, dense rows, plans or tables) and
imports nothing of the program, of jax or of the JAX package.

`precision` gives the control of the comparison: each term's contribution
rounded to TF32 (10 mantissa bits, the precision of an f32 matmul with
TF32 on) or to bfloat16, and summed in float32.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import numpy as np
import torch

K1 = 1.2
B = 0.75


def round_mantissa(x: torch.Tensor, bits: int) -> torch.Tensor:
    """float32 `x` rounded to nearest (ties to even) at `bits` mantissa bits."""
    drop = 23 - bits
    i = x.contiguous().view(torch.int32)
    half = (1 << (drop - 1)) - 1
    odd = (i >> drop) & 1
    i = ((i + half + odd) >> drop) << drop
    return i.view(torch.float32)


PRECISIONS = {"float64": None, "tf32": 10, "bfloat16": 7}


def idf(n_docs: int, df: np.ndarray) -> np.ndarray:
    """float64 log of the float32 argument (N - df + 0.5) / (df + 0.5) + 1."""
    f32 = np.float32
    num = (np.int64(n_docs) - df.astype(np.int64)).astype(f32) + f32(0.5)
    arg = num / (df.astype(f32) + f32(0.5)) + f32(1.0)
    return np.log(arg.astype(np.float64))


@dataclass
class Answer:
    """One query's answer: docs and scores in rank order, and found."""

    docs: np.ndarray
    scores: np.ndarray
    found: int


class Bm25Reference:
    """BM25 over one corpus's raw CSR arrays, on `device`."""

    def __init__(self, term_offsets, post_doc, post_tf, doc_len, device):
        self.device = torch.device(device)
        dev = self.device
        self.offsets = np.asarray(term_offsets, np.int64)
        with warnings.catch_warnings():  # the raw arrays are read-only
            warnings.simplefilter("ignore", UserWarning)
            self.post_doc = torch.as_tensor(post_doc, device=dev)
            self.post_tf = torch.as_tensor(post_tf, device=dev)
            dl = torch.as_tensor(doc_len, device=dev).double()
        self.n_docs = int(dl.shape[0])
        avgdl = dl.sum() / self.n_docs
        self.norm = K1 * (1.0 - B + B * dl / avgdl)
        self.idf = idf(self.n_docs, np.diff(self.offsets))

    def scores(self, term_ids, precision: str = "float64") -> torch.Tensor:
        """Every document's score for the distinct terms `term_ids`."""
        bits = PRECISIONS[precision]
        acc = torch.zeros(self.n_docs, device=self.device,
                          dtype=torch.float64 if bits is None else torch.float32)
        for t in sorted(set(int(t) for t in term_ids)):
            lo, hi = int(self.offsets[t]), int(self.offsets[t + 1])
            if hi == lo:
                continue
            d = self.post_doc[lo:hi].long()
            tf = self.post_tf[lo:hi].double()
            c = self.idf[t] * tf * (K1 + 1.0) / (tf + self.norm[d])
            if bits is not None:
                c = round_mantissa(c.float(), bits)
            acc.index_add_(0, d, c)
        return acc

    def answer(self, term_ids, k: int, precision: str = "float64") -> Answer:
        """Top k by score (ties to the lower doc) and the matched count,
        as the reference computes them in `precision`."""
        s = self.scores(term_ids, precision)
        found = int(torch.count_nonzero(s))
        kk = min(k, found)
        if kk == 0:
            return Answer(np.empty(0, np.int64), np.empty(0), found)
        # a margin of ties past the k-th score, then an exact order
        thr = torch.topk(s, kk).values[-1]
        idx = torch.nonzero(s >= thr).flatten()
        sv = s[idx].double().cpu().numpy()
        ids = idx.cpu().numpy()
        order = np.lexsort((ids, -sv))[:kk]
        return Answer(ids[order], sv[order], found)
