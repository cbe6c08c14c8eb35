"""The corpus and the query streams, drawn from the run's seed.

The corpus is a frozen, parametrised copy of
nextsearch_tpu_torch/tools/synthetic.py's build_corpus (commit df737fb):
a Poisson count of indexed tokens per document (the configuration's
mean_tokens: its words less stopwords, where synthetic.py keeps half),
each token a term of Zipf rank r with weight 1 / (r + 1)^s, repeated (doc, term) draws
merged into one posting whose tf is the count, postings in CSR order by
term with docs ascending, and a document's length the sum of its tfs. It
is drawn with torch on the given device from one torch.Generator, so the
same seed gives the same arrays and 210M postings take seconds.

The query stream is a copy of nextsearch_tpu_torch/benchmarks/load_http.py's
make_query_texts (commit df737fb): distinct terms drawn by the same Zipf
weights, a uniform count between the configuration's bounds. Drawing a
query's terms by their frequency in the corpus puts the highest-df terms
in most queries, more than real keyword queries hold (heavy_profile counts
them).

Nothing here imports the program: the harness hands the raw arrays to the
program's segment type and to the reference alike.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def term_name(i: int) -> str:
    """The text of term i; fixed width, so text order is rank order."""
    return f"t{i:07d}"


@dataclass
class Corpus:
    """Raw host arrays of one generated corpus (read-only)."""

    n_docs: int
    vocab: int
    term_offsets: np.ndarray  # int64 [vocab + 1]
    post_doc: np.ndarray  # int32 [P], ascending within a term
    post_tf: np.ndarray  # int32 [P]
    doc_len: np.ndarray  # int32 [n_docs], sum of the doc's tfs

    @property
    def n_postings(self) -> int:
        return int(self.post_doc.shape[0])

    @property
    def term_df(self) -> np.ndarray:
        return np.diff(self.term_offsets).astype(np.int32)


def zipf_cdf(vocab: int, s: float, device) -> torch.Tensor:
    """float64 cumulative Zipf weights 1 / (r + 1)^s over ranks 0..vocab-1."""
    w = 1.0 / torch.arange(1, vocab + 1, dtype=torch.float64,
                           device=device) ** s
    cum = torch.cumsum(w / w.sum(), 0)
    cum[-1] = 1.0
    return cum


def _readonly(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


def generate(cfg: dict, seed: int, device) -> Corpus:
    """The corpus of configuration `cfg` for `seed`, drawn on `device`."""
    n, vocab = int(cfg["n_docs"]), int(cfg["vocab"])
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    draws = torch.poisson(
        torch.full((n,), float(cfg["mean_tokens"]), dtype=torch.float32,
                   device=device), generator=g,
    ).to(torch.int64).clamp_(min=1)
    total = int(draws.sum())
    cum = zipf_cdf(vocab, float(cfg["zipf_s"]), device)
    u = torch.rand(total, dtype=torch.float64, device=device, generator=g)
    terms = torch.searchsorted(cum, u, right=True).clamp_(max=vocab - 1)
    del u, cum
    docs = torch.repeat_interleave(torch.arange(n, device=device), draws)
    keys, tf = torch.unique(docs * vocab + terms, sorted=True,
                            return_counts=True)
    del docs, terms
    # CSR by term, docs ascending inside a term
    by_term, order = torch.sort((keys % vocab) * n + keys // vocab)
    del keys
    tf = tf[order].to(torch.int32)
    del order
    post_term = by_term // n
    post_doc = (by_term % n).to(torch.int32)
    del by_term
    df = torch.bincount(post_term, minlength=vocab)
    del post_term
    offsets = torch.zeros(vocab + 1, dtype=torch.int64, device=device)
    torch.cumsum(df, 0, out=offsets[1:])
    doc_len = torch.zeros(n, dtype=torch.int64, device=device)
    doc_len.index_add_(0, post_doc.to(torch.int64), tf.to(torch.int64))
    return Corpus(
        n_docs=n, vocab=vocab,
        term_offsets=_readonly(offsets.cpu().numpy()),
        post_doc=_readonly(post_doc.cpu().numpy()),
        post_tf=_readonly(tf.cpu().numpy()),
        doc_len=_readonly(doc_len.to(torch.int32).cpu().numpy()),
    )


def draw_queries(cfg: dict, n_queries: int, rng: np.random.Generator):
    """n_queries term-id arrays: a uniform count of distinct terms between
    the configuration's query_terms bounds, each drawn by Zipf rank."""
    lo, hi = cfg["query_terms"]
    probs = 1.0 / np.arange(1, cfg["vocab"] + 1) ** float(cfg["zipf_s"])
    cum = np.cumsum(probs / probs.sum())
    cum[-1] = 1.0
    n_terms = rng.integers(lo, hi + 1, size=n_queries)
    tids = np.minimum(np.searchsorted(cum, rng.random(int(n_terms.sum())),
                                      side="right"), cfg["vocab"] - 1)
    ends = np.cumsum(n_terms)
    return [np.unique(tids[e - c:e]) for e, c in zip(ends, n_terms)]


def query_text(tids: np.ndarray) -> str:
    return " ".join(term_name(int(t)) for t in tids)


def heavy_profile(term_df: np.ndarray, threshold: int, queries) -> dict:
    """How heavy a query stream is: the share of its query terms, and of
    its queries, with a term of df at or above `threshold` (the dense-row
    threshold), and the mean query term's df."""
    if not queries:
        return {"heavy_term_share": 0.0, "heavy_query_share": 0.0,
                "mean_query_term_df": 0.0}
    flat = term_df[np.concatenate(queries)]
    starts = np.cumsum([0] + [len(t) for t in queries[:-1]])
    heavy = np.add.reduceat((flat >= threshold).astype(np.int64), starts)
    return {
        "heavy_term_share": float(heavy.sum() / flat.shape[0]),
        "heavy_query_share": float((heavy > 0).mean()),
        "mean_query_term_df": float(flat.astype(np.float64).mean()),
    }
