"""make_synthetic CLI: generate a CORD-19-shaped synthetic corpus on disk.

No real CORD-19 data ships with this environment, so the eval configs
(BASELINE.md) run against a synthetic corpus with a Zipf vocabulary and
CORD-19 file layout: metadata.csv + document_parses/pmc_json/*.xml.json with
title/abstract/body_text sections. The same tool feeds the offline build
pipeline (forwardindex -> lexicon) and the benchmark harness.

Usage: python -m nextsearch_tpu_torch.tools.make_synthetic OUT_DIR \
    [--n 5000] [--vocab 20000] [--seed 0] [--avg_len 120]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

# A tiny real-word stem list keeps queries human-typable; the tail is wNNNNN.
_STEMS = (
    "covid corona virus vaccine immunity antibody protein cell lung "
    "infection transmission mutation variant genome sequence patient "
    "clinical trial efficacy symptom fever respiratory pandemic epidemic "
    "mask distancing quarantine antiviral treatment therapy dose response "
    "pcr test antigen spike receptor binding enzyme inhibitor pathway "
).split()


def vocab_words(vocab: int):
    words = list(_STEMS[:vocab])
    for i in range(len(words), vocab):
        words.append(f"w{i:05d}")
    return words


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="make_synthetic")
    p.add_argument("out_dir")
    p.add_argument("--n", type=int, default=5000)
    p.add_argument("--vocab", type=int, default=20000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--avg_len", type=int, default=120)
    args = p.parse_args(argv)

    out = Path(args.out_dir)
    parses = out / "document_parses" / "pmc_json"
    parses.mkdir(parents=True, exist_ok=True)

    r = np.random.default_rng(args.seed)
    words = vocab_words(args.vocab)
    wobj = np.asarray(words, dtype=object)
    probs = 1.0 / np.arange(1, args.vocab + 1) ** 1.07
    probs /= probs.sum()
    # Vectorized Zipf sampling: per-doc r.choice(p=...) rebuilds an O(vocab)
    # cdf per call — hours at 1M docs x 200k vocab. One cdf + batched
    # searchsorted generates ~1M tokens per numpy call instead.
    cdf = np.cumsum(probs)
    cdf[-1] = 1.0

    meta_f = open(out / "metadata.csv", "w", encoding="utf-8")
    meta_f.write(
        "cord_uid,title,authors,publish_time,url,abstract,"
        "pdf_json_files,pmc_json_files\n"
    )
    B = 20_000
    for lo in range(0, args.n, B):
        nb = min(B, args.n - lo)
        lens = np.maximum(5, r.poisson(args.avg_len, nb))
        offs = np.concatenate([[0], np.cumsum(lens)])
        toks = np.searchsorted(cdf, r.random(int(offs[-1])), side="right")
        ttoks = np.searchsorted(cdf, r.random(4 * nb), side="right")
        tw = wobj[np.minimum(toks, args.vocab - 1)]
        ttw = wobj[np.minimum(ttoks, args.vocab - 1)]
        for j in range(nb):
            i = lo + j
            uid = f"syn{i:07d}"
            body = " ".join(tw[offs[j]:offs[j + 1]])
            title = " ".join(ttw[4 * j : 4 * j + 4])
            rel = f"document_parses/pmc_json/{uid}.xml.json"
            doc = {
                "paper_id": uid,
                "title": title,
                "abstract": [{"text": body[: len(body) // 3]}],
                "body_text": [{"text": body}],
            }
            (out / rel).write_text(json.dumps(doc))
            year = 2019 + i % 3
            meta_f.write(
                f'{uid},"{title}","Author{i % 97}, A; Coauthor, B",'
                f"{year}-01-{1 + i % 28:02d},https://example.org/{uid};mirror,"
                f'"{body[:80]}",,{rel}\n'
            )
        print(f"docs: {min(lo + B, args.n)}", file=sys.stderr)

    meta_f.close()
    print(f"Synthetic corpus: {args.n} docs in {out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
