"""Evaluation harness for the five BASELINE.md configurations on one CUDA
card (port of nextsearch_tpu's benchmarks/eval_configs.py).

Runs each configuration on synthetic CORD-shaped corpora, checks exact
parity against the oracle where the configuration demands it, and
measures throughput. Prints one JSON object per configuration and writes
them to --out (default chiprun_out/eval_configs.json, merged with the
file's earlier records).

  1. single segment, 5k docs, single-term BM25 top-10 (the 1-term
     shortcut tables)
  2. multi-term queries, 50k docs
  3. four segments (25k docs each; NEXTSEARCH_EVAL_FULL=1: 250k each at
     the 1M bench configuration), batched top-k across the merge
  4. autocomplete over 400k terms at high QPS
  5. hybrid retrieval: BM25 candidates + the dense rerank (20k docs, dim
     64; NEXTSEARCH_EVAL_FULL=1: 1M docs, dim 128)

    python -m nextsearch_tpu_torch.benchmarks.eval_configs [--configs 1,2]
        [--out PATH] [--device cpu] [--scale 1.0] [--secs S]

--scale multiplies every document, vocabulary and term count and --secs
sets every timed loop's length (the tests run both small on the CPU);
numbers from a CPU run are not device numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..index.oracle import oracle_search
from ..tools.synthetic import build_corpus, sample_queries


class Eval:
    """The five configurations on one device at one scale."""

    def __init__(self, device, scale: float = 1.0, secs=None):
        self.device = device
        self.scale = scale
        self.secs = secs  # every timed loop's length (None: 6 s and 5 s)

    def n(self, count: int, least: int = 64) -> int:
        return max(least, int(count * self.scale))

    def pinned_index(self, segs, batches, blk=512, mode="fused", **dev_kw):
        """TorchIndex with serving shape pins sized from the workload."""
        from ..config import DeviceConfig, EngineConfig
        from ..index.segment import TorchIndex

        cfg = EngineConfig(device=DeviceConfig(posting_block=blk, mode=mode,
                                               **dev_kw))
        ti = TorchIndex(segs, config=cfg, device=self.device)
        pins = ti.pin_shapes(batches)
        print(f"[eval] pins: {pins}", file=sys.stderr, flush=True)
        return ti

    @staticmethod
    def recall_check(ti, seg, queries, k=10, n_check=20):
        """Exact recall@k and score parity against the oracle."""
        oracle_segs = [seg.to_oracle_segment()]
        sample = queries[:n_check]
        for terms, res in zip(sample, ti.search_batch(sample, k=k)):
            hits, found = oracle_search(oracle_segs, terms, k=k)
            assert res.found == found, terms
            assert len(res.scores) == len(hits), terms
            for (o_s, _o_seg, o_doc), d_s, d_slot in zip(hits, res.scores,
                                                          res.doc_slots):
                assert ti.locate(int(d_slot))[1] == o_doc, terms
                assert np.float32(d_s) == np.float32(o_s), terms
        return True

    def throughput(self, index, batches, depth=4, secs=6.0):
        """Pipelined QPS at k 10 (a HybridIndex at its 100 candidates)."""
        from .probe_depth import run_point

        index.search_batch(batches[0], k=10)  # warm
        return run_point(index, batches, depth=depth,
                         secs=self.secs or secs)[0]

    def cached_corpus(self, n_docs, vocab, seed):
        from .common import bench_corpus

        return bench_corpus(n_docs, vocab, seed=seed)[0]

    def config1(self):
        # the production sparse configuration over a single-term stream:
        # answered almost entirely by the 1-term shortcut tables (exact,
        # canonical); an all-shortcut batch launches nothing
        docs, vocab = self.n(5_000), self.n(5_000)
        seg, probs = build_corpus(docs, vocab, seed=1)
        rng = np.random.default_rng(1)
        queries = [[(f"t{t:06d}", 1.0)] for t in rng.choice(vocab, size=2048, p=probs)]
        batches = [queries[i: i + 512] for i in range(0, 2048, 512)]
        # row_topk_rows covers every dense row at this scale
        ti = self.pinned_index([seg], batches, blk=64, mode="sparse",
                               dense_df_ratio=1 / 1024,
                               dense_max_bytes=7 << 30, row_topk_rows=4096)
        self.recall_check(ti, seg, queries)
        qps = self.throughput(ti, batches)
        return {
            "config": 1, "docs": docs, "parity": True, "qps": round(qps, 1),
            "mechanism": "host shortcut tables (precomputed exact per-term "
                         "top-k; all-shortcut batches skip the device launch)",
        }

    def config2(self):
        docs, vocab = self.n(50_000), self.n(30_000)
        seg, probs = build_corpus(docs, vocab, seed=2)
        batches = sample_queries(probs, 2048, 512, seed=2)
        ti = self.pinned_index([seg], batches, blk=64, mode="sparse",
                               dense_df_ratio=1 / 1024, dense_max_bytes=7 << 30)
        self.recall_check(ti, seg, [q for b in batches for q in b])
        qps = self.throughput(ti, batches)
        return {"config": 2, "docs": docs, "parity": True, "qps": round(qps, 1)}

    def config3(self):
        full = os.environ.get("NEXTSEARCH_EVAL_FULL") == "1"
        n_per_seg = self.n(250_000 if full else 25_000)
        n_segs = 4
        # the segments share the headline corpus's term distribution, so
        # the merged index has the single-segment bench's df profile
        vocab = self.n(200_000 if full else 40_000)
        segs = [self.cached_corpus(n_per_seg, vocab, 10 + i)
                for i in range(n_segs)]
        probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
        probs /= probs.sum()
        if full:
            batches = sample_queries(probs, 4096, 512, seed=3)
            ti = self.pinned_index(segs, batches, blk=64, mode="sparse",
                                   dense_df_ratio=1 / 1024,
                                   dense_max_bytes=7 << 30)
        else:
            batches = sample_queries(probs, 256, 64, seed=3)
            ti = self.pinned_index(segs, batches)
        oracle_segs = [s.to_oracle_segment() for s in segs]
        spot = batches[0][:10]
        for terms, res in zip(spot, ti.search_batch(spot, k=10)):
            hits, found = oracle_search(oracle_segs, terms, k=10)
            assert res.found == found
            for (o_s, o_seg, o_doc), d_s, d_slot in zip(hits, res.scores,
                                                        res.doc_slots):
                assert ti.locate(int(d_slot)) == (o_seg, o_doc)
                assert np.float32(d_s) == np.float32(o_s)
        qps = self.throughput(ti, batches, depth=8 if full else 4)
        return {"config": 3, "docs": n_per_seg * n_segs, "segments": n_segs,
                "parity": True, "qps": round(qps, 1)}

    def config4(self):
        """Autocomplete over a 1M-doc-scale vocabulary: 400k distinct term
        strings with Zipf dfs; the workload mixes short prefixes (the
        per-prefix cache) with long ones (the windowed device top-k)."""
        from ..models.autocomplete import AutocompleteIndex

        n_terms = self.n(400_000, least=2_000)
        rng = np.random.default_rng(4)
        letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
        lp = 1.0 / (np.arange(26) + 5.0)
        lp /= lp.sum()
        words: set = set()
        while len(words) < n_terms:
            lens = rng.integers(3, 13, size=n_terms)
            chars = letters[rng.choice(26, size=(n_terms, 12), p=lp)]
            words.update("".join(row[:ln]) for row, ln in zip(chars, lens))
        terms = sorted(words)
        dfs = (1_000_000 / np.arange(1, len(terms) + 1) ** 1.07).astype(
            np.int64) + 1
        rng.shuffle(dfs)  # df rank uncorrelated with lexicographic order
        ac = AutocompleteIndex(device=self.device)
        ac.build({t: int(d) for t, d in zip(terms, dfs)}, 10)
        plens = rng.choice([1, 2, 3, 4, 5, 6, 99], size=512,
                           p=[0.10, 0.25, 0.25, 0.20, 0.10, 0.05, 0.05])
        picks = rng.integers(0, len(terms), size=512)
        queries = [terms[i][: min(pl, len(terms[i]))]
                   for i, pl in zip(picks, plens)]
        batches = [queries[i: i + 64] for i in range(0, 512, 64)]
        for b in batches:
            ac.suggest_batch(b, 10)  # warm every window bucket
        n = 0
        lat = []
        t0 = time.time()
        while time.time() - t0 < (self.secs or 5.0):
            b0 = time.time()
            ac.suggest_batch(batches[n // 64 % len(batches)], 10)
            lat.append(time.time() - b0)
            n += 64
        qps = n / (time.time() - t0)
        p50 = float(np.median(lat)) * 1000
        return {"config": 4, "terms": len(ac.terms), "qps": round(qps, 1),
                "p50_batch64_ms": round(p50, 2), "target_qps": 1000,
                "meets_target": qps >= 1000}

    def config5(self):
        """Hybrid BM25 + dense rerank, pipelined at depth 4, batch 128 (the
        reference's sweep), 100 candidates; doc embeddings built on the
        device."""
        from ..models.hybrid import HybridIndex
        from ..models.semantic import SemanticIndex

        full = os.environ.get("NEXTSEARCH_EVAL_FULL") == "1"
        n_docs = self.n(1_000_000 if full else 20_000)
        vocab = self.n(200_000 if full else 10_000)
        dim = 128 if full else 64
        seg = self.cached_corpus(n_docs, vocab, 5)
        probs = 1.0 / np.arange(1, vocab + 1) ** 1.07
        probs /= probs.sum()
        qbatch = int(os.environ.get("NEXTSEARCH_EVAL_C5_QB", 128))
        batches = sample_queries(probs, 16 * qbatch, qbatch, seed=5)
        if full:
            ti = self.pinned_index([seg], batches, blk=64, mode="sparse",
                                   dense_df_ratio=1 / 1024,
                                   dense_max_bytes=7 << 30)
        else:
            ti = self.pinned_index([seg], batches)
        rng = np.random.default_rng(5)
        sem = SemanticIndex(device=self.device)
        sem.load_from_arrays(
            seg.terms, rng.normal(size=(len(seg.terms), dim)).astype(np.float32))
        t0 = time.time()
        hy = HybridIndex(ti, sem, beta=0.5)
        emb_build_s = time.time() - t0
        # parity gate: the device hybrid against the exact host row (doc
        # order exact, scores to the cosine's summation-order tolerance)
        parity_q = batches[1][:8]
        got = hy.search_batch(parity_q, k=10, candidates=100)
        for q, r in zip(parity_q, got):
            exp = hy._host_hybrid_row(q, 10, 100)
            assert r.found == exp.found, (q, r.found, exp.found)
            assert r.doc_slots.tolist() == exp.doc_slots.tolist(), q
            np.testing.assert_allclose(r.scores, exp.scores, rtol=2e-5)
        print("[c5] parity: OK (8 queries, doc order exact)", file=sys.stderr,
              flush=True)
        qps = self.throughput(hy, batches, secs=5.0)
        return {"config": 5, "docs": n_docs, "dim": dim, "parity": True,
                "emb_build_s": round(emb_build_s, 1), "qps": round(qps, 1)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=str(Path("chiprun_out") / "eval_configs.json"))
    p.add_argument("--configs", default="1,2,3,4,5")
    p.add_argument("--device", default="cuda",
                   help="cuda (default, required for a measurement) or cpu")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--secs", type=float, default=None,
                   help="each timed loop's seconds (default 6, 5 for 4 and 5)")
    args = p.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        print("no CUDA device: eval_configs measures the card "
              "(--device cpu runs it without one)", file=sys.stderr)
        return 2
    device = torch.device(args.device)
    if device.type == "cuda":
        from .common import card_line

        card = card_line()
    else:
        card = "cpu (no device measured)"
    print(card, flush=True)
    ev = Eval(device, args.scale, args.secs)
    results = []
    for c in (int(x) for x in args.configs.split(",")):
        t0 = time.time()
        r = getattr(ev, f"config{c}")()
        r["wall_s"] = round(time.time() - t0, 1)
        r["device"] = card
        print(json.dumps(r), flush=True)
        results.append(r)
    # merge with the file's records, so a partial refresh keeps the others
    out_path = Path(args.out)
    merged = {}
    if out_path.exists():
        try:
            for r in json.loads(out_path.read_text()):
                merged[r.get("config")] = r
        except (ValueError, OSError):
            pass
    for r in results:
        merged[r.get("config")] = r
    out_path.parent.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps([merged[c] for c in sorted(merged)], indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
