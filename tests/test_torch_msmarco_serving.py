"""MS MARCO passage's deployment, small, served in sparse mode on the CPU.

A seeded corpus drawn as the benchmark's msmarco-passage configuration
draws it (Zipf 1.07 terms, 39.85 indexed tokens a passage, 1-6-term
queries by corpus frequency), at 20,000 passages, served through the
server's path: SearchBatcher -> Engine (server configuration, sparse mode,
warmed) -> TorchIndex. Every answer is held to searchbench/reference.py's
plain BM25 (float64, from the raw postings, nothing of the program) by
searchbench/judge.py: scores within 1e-5 of the best, ranks, and `found`
exact. Cases: a dense row for every term at the threshold against a budget
of a few rows, the fast guard on and off, and a guard trip forced in every
launch, rescued on the host or relaunched exactly. The comparison fails a
planted fault; the tracer's counters equal the index's attributes and the
shortcut's answers; after Engine.warmup the traffic takes no shape past a
pin and captures no launch graph; a tripped query of one df-head term and
a few rare ones is answered from the row top-k table as the oracle
answers it.
"""

from __future__ import annotations

import json
import threading
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from nextsearch_tpu_torch.api import server as server_mod
from nextsearch_tpu_torch.api.batching import SearchBatcher
from nextsearch_tpu_torch.index.oracle import oracle_search_vec
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.ops import graphs
from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER
from searchbench import judge
from searchbench.corpus import generate
from searchbench.reference import Bm25Reference
from searchbench.run import segment_arrays, serve, stop_flushers
from searchbench.traffic import distinct_stream, query_text

from test_torch_graphs import FakeGraphs

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(json.loads((ROOT / "searchbench" / "configs"
                       / "msmarco-passage.json").read_text()),
           n_docs=20_000, vocab=6_000)
SEED = 3_000_000_017
N_SLOTS = 20_480  # 20,000 passages rounded up to 2048
BATCH = 256
N_BATCHES = 4


@pytest.fixture(scope="module")
def corpus():
    return generate(CFG, SEED, "cpu")


@pytest.fixture(scope="module")
def reference(corpus):
    return Bm25Reference(corpus.term_offsets, corpus.post_doc,
                         corpus.post_tf, corpus.doc_len, "cpu")


def heavy_terms(corpus) -> int:
    return int((corpus.term_df >= N_SLOTS // 256).sum())


@pytest.fixture()
def served(corpus, tmp_path, monkeypatch):
    """serve(**case): the harness's Engine over the corpus in the server's
    sparse configuration with a dense-row budget of `rows` rows (None: one
    for every term at the threshold), the fast guard `fast` with eps
    `eps`, and NEXTSEARCH_TRIP_RESCUE `rescue`; yields (engine, batcher)
    and stops both."""
    made = []

    def make(rows=None, fast=True, eps=None, rescue=None):
        rows = heavy_terms(corpus) if rows is None else rows
        cfg = dict(CFG, env={"NEXTSEARCH_DENSE_BYTES": rows * 4 * N_SLOTS})
        for key in cfg["env"]:
            monkeypatch.setenv(key, "0")  # restored after the test
        if rescue is not None:
            monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", str(rescue))
        real = server_mod.serving_config

        def config(mode):
            c = real(mode)
            dev = replace(c.device, fast_heavy=fast)
            if eps is not None:
                dev = replace(dev, fast_heavy_eps=eps)
            return replace(c, device=dev)

        monkeypatch.setattr(server_mod, "serving_config", config)
        work = tmp_path / f"serve{len(made)}"
        work.mkdir()
        engine, config_used, _s = serve(cfg, segment_arrays(corpus), work,
                                        "cpu")
        batcher = SearchBatcher(engine, config_used.batching)
        made.append((engine, batcher))
        return engine, batcher

    yield make
    for engine, batcher in made:
        batcher.shutdown()
        stop_flushers(engine)


def traffic(n, seed=1):
    return distinct_stream(CFG, n, np.random.default_rng(seed))


def send(batcher, queries):
    """The queries in requests of BATCH from two clients, as (term ids,
    text, served) items for the judge."""
    out = [None] * len(queries)

    def client(c):
        for i in range(c * BATCH, len(queries), 2 * BATCH):
            part = queries[i:i + BATCH]
            res = batcher.search_many([(text, CFG["k"]) for _t, text in part])
            out[i:i + len(part)] = res

    threads = [threading.Thread(target=client, args=(c,)) for c in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    return [(t, text, r) for (t, text), r in zip(queries, out)]


CASES = {
    "rows_for_every_heavy_term": dict(),
    "a_few_rows": dict(rows=6),
    "fast_guard_off": dict(fast=False),
    "fast_guard_off_a_few_rows": dict(rows=6, fast=False),
    "trip_rescued": dict(eps=1e30, rescue=1_000_000),
    "trip_relaunched": dict(eps=1e30, rescue=0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_served_answers_equal_plain_bm25(served, reference, corpus, case):
    engine, batcher = served(**CASES[case])
    index = engine.index
    want_rows = 6 if CASES[case].get("rows") else heavy_terms(corpus)
    assert index.n_dense == want_rows
    items = send(batcher, traffic(N_BATCHES * BATCH))
    numbers = judge.judge(items, reference, CFG["k"])
    assert numbers["judged"] == N_BATCHES * BATCH
    assert judge.verdict(numbers), numbers
    if case == "trip_rescued":
        assert index.rescue_trips > 0 and index.relaunches == 0
    elif case == "trip_relaunched":
        assert index.relaunches > 0 and index.rescue_trips == 0


def test_shifted_doc_slots_fail_the_comparison(served, reference,
                                               monkeypatch):
    """A planted fault: every doc slot the index returns moved by one."""
    engine, batcher = served()
    real = TorchIndex.search_batch_gather

    def shifted(self, handle):
        res = real(self, handle)
        for r in res:
            r.doc_slots[:] = r.doc_slots + 1
        return res

    monkeypatch.setattr(TorchIndex, "search_batch_gather", shifted)
    items = send(batcher, traffic(BATCH, seed=2))
    numbers = judge.judge(items, reference, CFG["k"])
    assert not judge.verdict(numbers), numbers
    assert numbers["rank_err"] > judge.LIMITS["rank_err"]


class MemoHits(dict):
    """The rescue memo, counting the answers it gives."""

    hits = 0

    def get(self, key, default=None):
        res = super().get(key, default)
        self.hits += res is not None
        return res


@pytest.mark.parametrize("case", ["trip_rescued", "trip_relaunched"])
def test_counters_equal_attributes_and_shortcut_answers(served, case):
    """index.rescued and index.relaunches equal rescue_trips and
    relaunches; index.shortcut_answers the 1-term shortcut's answers;
    index.queries_launched the rest of the launched batches but those the
    rescue memo answers; every
    launched query's guard trips here (eps 1e30), and index.guard_trips
    counts them."""
    engine, batcher = served(**CASES[case])
    index = engine.index
    answered = []
    real = index._shortcut_single_heavy

    def counting(queries, k):
        out, fills = real(queries, k)
        answered.append(len(fills or ()))
        return out, fills

    index._shortcut_single_heavy = counting
    index._rescue_memo = MemoHits(index._rescue_memo)
    before = dict(GLOBAL_TRACER.report()["counters"])
    attrs = (index.rescue_trips, index.relaunches)
    send(batcher, traffic(N_BATCHES * BATCH, seed=3))
    after = GLOBAL_TRACER.report()["counters"]

    def delta(name):
        return after.get(name, 0) - before.get(name, 0)

    assert delta("index.rescued") == index.rescue_trips - attrs[0]
    assert delta("index.relaunches") == index.relaunches - attrs[1]
    assert delta("index.shortcut_answers") == sum(answered) > 0
    launched = delta("index.queries_launched")
    assert launched == (N_BATCHES * BATCH - sum(answered)
                        - index._rescue_memo.hits)
    assert 0 < delta("index.guard_trips") <= launched
    if case == "trip_rescued":
        assert delta("index.guard_trips") == delta("index.rescued") > 0
        assert delta("index.relaunches") == 0
    else:
        assert delta("index.relaunches") == N_BATCHES
        assert delta("index.rescued") == 0


def test_no_escape_and_no_capture_after_warmup(served, monkeypatch):
    """Engine.warmup pins and captures the envelopes that this traffic
    plans in (questions of up to 6 terms): 20 more batches of it take no
    shape past a pin and capture no launch graph."""
    monkeypatch.setattr(graphs, "CPU_BACKEND", FakeGraphs())
    engine, batcher = served()
    cache = engine.index.launch_cache
    assert cache.captures > 0
    captures = cache.captures
    escapes = GLOBAL_TRACER.report()["counters"].get("planner.escapes", 0)
    send(batcher, traffic(20 * BATCH, seed=4))
    assert cache.replays > 0
    assert cache.captures == captures
    assert GLOBAL_TRACER.report()["counters"].get(
        "planner.escapes", 0) == escapes


def test_head_answers_equal_the_oracle(served, corpus):
    """_head_answer (the guard's rescue of a df-head term beside rare
    terms) gives the oracle's hits and found bit for bit, wherever the
    head term sits in the query, and declines other query forms."""
    engine, _b = served()
    index = engine.index
    df = corpus.term_df
    name = "t{:07d}".format
    heads = [name(int(t)) for t in np.argsort(-df, kind="stable")[:3]]
    rare = [name(int(t)) for t in np.flatnonzero((df >= 1) & (df <= 4))]
    rng = np.random.default_rng(5)
    answered = 0
    for _ in range(40):
        head = heads[int(rng.integers(len(heads)))]
        others = list(rng.choice(rare, size=int(rng.integers(1, 4)),
                                 replace=False))
        terms = others[:1] + [head] + others[1:]
        q = [(t, 1.0) for t in terms]
        for K in (10, 32):
            got = index._head_answer(q, K)
            want = oracle_search_vec(index._oracle_segs(), q, K)
            assert got is not None
            assert got == want, (terms, K)
            answered += 1
    assert answered == 80
    # other forms go to the oracle or a relaunch
    assert index._head_answer([(heads[0], 1.0), (heads[1], 1.0)], 10) is None
    assert index._head_answer([(rare[0], 1.0), (rare[1], 1.0)], 10) is None
    assert index._head_answer([(heads[0], 2.0), (rare[0], 1.0)], 10) is None
    assert index._head_answer([(heads[0], 1.0), (heads[0], 1.0)], 10) is None
    # light postings past what the stored head prefix can hold
    light = [name(int(t)) for t in np.flatnonzero((df >= 60) & (df < 80))]
    assert index._head_answer([(heads[0], 1.0)] + [
        (t, 1.0) for t in light[:2]], 10) is None


@pytest.mark.parametrize("other", [False, True])
def test_head_answers_outside_the_rescue_cap(served, reference, corpus,
                                             other):
    """NEXTSEARCH_TRIP_RESCUE bounds the host oracle's rescues only: at 0,
    a batch whose tripped queries are all of the df-head form is answered
    from the row top-k table, with no relaunch; one tripped query of
    another form relaunches its batch. Every answer equals plain BM25."""
    engine, batcher = served(eps=1e30, rescue=0)
    index = engine.index
    df = corpus.term_df
    heads = [int(t) for t in np.argsort(-df, kind="stable")[:3]]
    rare = np.flatnonzero((df >= 1) & (df <= 4))
    rng = np.random.default_rng(6)
    batch = [[heads[i % 3]] + sorted(int(t) for t in rng.choice(
        rare, size=2, replace=False)) for i in range(48)]
    if other:
        batch.append(heads[:2])
    queries = [(np.array(t), query_text(np.array(t))) for t in batch]
    attrs = (index.rescue_trips, index.relaunches)
    res = batcher.search_many([(text, CFG["k"]) for _t, text in queries])
    items = [(t, text, r) for (t, text), r in zip(queries, res)]
    numbers = judge.judge(items, reference, CFG["k"])
    assert numbers["judged"] == len(batch)
    assert judge.verdict(numbers), numbers
    if other:
        assert index.relaunches == attrs[1] + 1
        assert index.rescue_trips == attrs[0]
    else:
        assert index.relaunches == attrs[1]
        assert index.rescue_trips == attrs[0] + len(batch)
