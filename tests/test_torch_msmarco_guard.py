"""MS MARCO passage's deployment, small, served in sparse mode on the CPU:
the fast guard's cases.

The corpus, the served engines and the traffic are
test_torch_msmarco_serving.py's (20,000 passages, the server's path,
every configuration built once a module). The tracer's counters equal the
index's attributes and the shortcut's answers when every launch trips the
guard, rescued on the host or relaunched exactly; after Engine.warmup the
traffic takes no shape past a pin and captures no launch graph; a tripped
query of one df-head term and a few rare ones is answered from the row
top-k table as the oracle answers it, whether or not the host rescue's cap
allows a rescue.
"""

from __future__ import annotations

import numpy as np
import pytest

from nextsearch_tpu_torch.index.oracle import oracle_search_vec
from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER
from searchbench import judge
from searchbench.traffic import query_text

from test_torch_msmarco_serving import (  # noqa: F401 (fixtures)
    BATCH, CASES, CFG, N_BATCHES, corpus, engines, reference, send, served,
    traffic,
)


class MemoHits(dict):
    """The rescue memo, counting the answers it gives."""

    hits = 0

    def get(self, key, default=None):
        res = super().get(key, default)
        self.hits += res is not None
        return res


@pytest.mark.parametrize("case", ["trip_rescued", "trip_relaunched"])
def test_counters_equal_attributes_and_shortcut_answers(served, case,
                                                        monkeypatch):
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

    monkeypatch.setattr(index, "_shortcut_single_heavy", counting)
    monkeypatch.setattr(index, "_rescue_memo", MemoHits(index._rescue_memo))
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


def test_no_escape_and_no_capture_after_warmup(served):
    """Engine.warmup pins and captures the envelopes that this traffic
    plans in (questions of up to 6 terms): 20 more batches of it take no
    shape past a pin and capture no launch graph."""
    engine, batcher = served(fake_graphs=True)
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
    head term sits in the query, and declines other query forms. On the
    engine of the test above: _head_answer runs on the host alone, so the
    stand-in graph backend does not reach it."""
    engine, _b = served(fake_graphs=True)
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
