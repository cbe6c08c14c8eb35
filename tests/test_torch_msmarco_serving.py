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
planted fault. The guard's own cases (counters, head answers, no escape
after warm-up) are in test_torch_msmarco_guard.py, which takes this
file's corpus, engines and traffic.

Each served configuration is built and warmed once a module (`engines`)
and handed to each test that asks for it as a fresh one (`served`).
"""

from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest

from nextsearch_tpu_torch.api import server as server_mod
from nextsearch_tpu_torch.api.batching import SearchBatcher
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.ops import graphs
from searchbench import judge
from searchbench.corpus import generate
from searchbench.reference import Bm25Reference
from searchbench.run import segment_arrays, serve, stop_flushers
from searchbench.traffic import distinct_stream

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


def _build(corpus, work, rows, fast, eps, rescue, fake_graphs):
    """The harness's Engine over the corpus, served and warmed in `work`
    under its configuration (served); returns (engine, batcher, the
    environment it was served under, its graph backend)."""
    rows = heavy_terms(corpus) if rows is None else rows
    cfg = dict(CFG, env={"NEXTSEARCH_DENSE_BYTES": rows * 4 * N_SLOTS})
    env = {key: str(value) for key, value in cfg["env"].items()}
    if rescue is not None:
        env["NEXTSEARCH_TRIP_RESCUE"] = str(rescue)
    backend = FakeGraphs() if fake_graphs else None
    with pytest.MonkeyPatch.context() as mp:  # undone after the build
        for key, value in env.items():
            mp.setenv(key, value)
        real = server_mod.serving_config

        def config(mode):
            c = real(mode)
            dev = replace(c.device, fast_heavy=fast)
            if eps is not None:
                dev = replace(dev, fast_heavy_eps=eps)
            return replace(c, device=dev)

        mp.setattr(server_mod, "serving_config", config)
        if fake_graphs:
            mp.setattr(graphs, "CPU_BACKEND", backend)
        engine, config_used, _s = serve(cfg, segment_arrays(corpus), work,
                                        "cpu")
    assert len(engine.cache) == 0  # warm-up searches the index directly
    batcher = SearchBatcher(engine, config_used.batching)
    return engine, batcher, env, backend


@pytest.fixture(scope="module")
def engines():
    """{configuration: what _build returns}, each built by served on its
    first use in the module; all are stopped at the module's end. The
    engines' flush threads are stopped at once: stop_flushers joins every
    flush thread in the process, and would wait out its timeout (10 s) on
    each thread of an engine not yet stopped."""
    made = {}
    yield made
    for _engine, batcher, _env, _backend in made.values():
        batcher.shutdown()
    stops = [threading.Thread(target=stop_flushers, args=(engine,))
             for engine, *_ in made.values()]
    for t in stops:
        t.start()
    for t in stops:
        t.join()


@pytest.fixture()
def served(engines, corpus, tmp_path_factory, monkeypatch):
    """serve(**case): the harness's Engine over the corpus in the server's
    sparse configuration with a dense-row budget of `rows` rows (None: one
    for every term at the threshold), the fast guard `fast` with eps
    `eps`, NEXTSEARCH_TRIP_RESCUE `rescue` and, with `fake_graphs`,
    test_torch_graphs' stand-in graph backend in place from its warm-up;
    returns (engine, batcher). Each configuration is built once a module;
    a test gets it as a fresh one: under the environment it was served
    under, with an empty result cache and the rescue memo as its warm-up
    left it, all restored after the test."""

    def make(rows=None, fast=True, eps=None, rescue=None, fake_graphs=False):
        key = (rows, fast, eps, rescue, fake_graphs)
        if key not in engines:
            engines[key] = _build(corpus, tmp_path_factory.mktemp("serve"),
                                  *key)
        engine, batcher, env, backend = engines[key]
        for name, value in env.items():
            monkeypatch.setenv(name, value)
        if fake_graphs:
            monkeypatch.setattr(graphs, "CPU_BACKEND", backend)
        monkeypatch.setattr(engine.cache, "_data", OrderedDict())
        index = engine.index
        monkeypatch.setattr(index, "_rescue_memo", dict(index._rescue_memo))
        return engine, batcher

    return make


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
