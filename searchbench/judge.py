"""The comparison that decides `correct`.

Each sampled answer, as the timed path rendered it (JSON, from the LRU
cache or from a launch), is held against the reference's float64 scores of
every document for the query's terms:

  bad_answers   answers that never came, raised, do not parse, echo
                another query, repeat a doc, are not in score order, or
                hold fewer than min(k, found) or more than k results
  found_err     answers whose `found` differs from the number of documents
                the reference scores above 0
  score_err     the largest gap between a served score and the reference's
                score of that doc, over the query's best reference score
  rank_err      the largest amount by which a served doc's reference score
                lies below the reference's k-th best, over the query's best
  meta_err      served results whose cord_uid, title, url, publish_time or
                author differ from what the deployment's metadata.csv row
                of that doc gives (configurations with metadata only)

The first two and the last are exact (limit 0). The limits of the last two lie between
the largest reading of sound runs of the program over a dozen seeds and
more and the smallest reading of the control, the reference with each
contribution rounded to TF32 (PERF.md gives both readings).
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .reference import Answer, Bm25Reference

LIMITS = {
    "bad_answers": 0,
    "found_err": 0,
    "score_err": 1e-5,
    "rank_err": 1e-5,
    "meta_err": 0,
}


def parse(served, query: str) -> Optional[Tuple[Answer, list]]:
    """An answer as the timed path rendered it (a JSON fragment or a dict),
    and its result rows; None where it is malformed or echoes another
    query."""
    try:
        if isinstance(served, tuple):  # the native renderer's fragment
            served = json.loads(served[0])
        if served.get("query") != query:
            return None
        rows = served["results"]
        docs = np.array([int(r["docId"]) for r in rows], np.int64)
        scores = np.array([float(r["score"]) for r in rows], np.float64)
        return Answer(docs, scores, int(served["found"])), rows
    except (KeyError, TypeError, ValueError, AttributeError):
        return None


def judge(answers: Iterable, ref: Bm25Reference, k: int,
          meta=None) -> Dict[str, float]:
    """The numbers above over `answers`: (term ids, query text, served),
    where served is None for an answer that never came or raised; `meta`
    is the deployment's metadata.Metadata, or None where it has none."""
    out = {"bad_answers": 0, "found_err": 0, "score_err": 0.0,
           "rank_err": 0.0, "meta_err": 0, "judged": 0}
    for tids, query, served in answers:
        out["judged"] += 1
        parsed = parse(served, query) if served is not None else None
        if parsed is None:
            out["bad_answers"] += 1
            continue
        got, rows = parsed
        s = ref.scores(tids)
        found = int(torch.count_nonzero(s))
        n = len(got.docs)
        if (n != min(k, found) or len(set(got.docs.tolist())) != n
                or np.any(np.diff(got.scores) > 0)
                or np.any(got.docs < 0) or np.any(got.docs >= s.shape[0])):
            out["bad_answers"] += 1
            continue
        out["found_err"] += int(got.found != found)
        if meta is not None:
            out["meta_err"] += sum(
                any(r.get(f) != v for f, v in meta.expected(int(d)).items())
                for d, r in zip(got.docs, rows))
        if n == 0:
            continue
        top = torch.topk(s, n).values.cpu().numpy()
        best, kth = float(top[0]), float(top[-1])
        mine = s[torch.as_tensor(got.docs, device=s.device)].cpu().numpy()
        out["score_err"] = max(out["score_err"],
                               float(np.abs(got.scores - mine).max()) / best)
        out["rank_err"] = max(out["rank_err"],
                              float(max(0.0, kth - mine.min())) / best)
    return out


def control_answers(items, ref: Bm25Reference, k: int, precision: str,
                    meta=None):
    """The reference in `precision`, put in the program's place: the same
    (term ids, query, served) items with the control's answer served, its
    results carrying the metadata fields where the deployment has them."""
    for tids, query, _served in items:
        a = ref.answer(tids, k, precision)
        yield tids, query, {
            "query": query, "found": a.found,
            "results": [dict(meta.expected(int(d)) if meta else {},
                             docId=int(d), score=float(np.float32(s)))
                        for d, s in zip(a.docs, a.scores)],
        }


def verdict(numbers: Dict[str, float]) -> bool:
    return all(numbers[name] <= lim for name, lim in LIMITS.items())


def lines(numbers: Dict[str, float]) -> list:
    """Each compared number beside its limit, one per line."""
    return [f"{name} {numbers[name]!r} limit {lim!r}"
            for name, lim in LIMITS.items()]
