"""A batch's results as columns: TorchIndex.search_batch_gather(handle)
gives one ResultColumns for every kind of handle, equal to the batch's
unpack a query at a time and read as that batch's QueryResults; the
Engine's native render from those columns against its render a query at
a time and against the JAX package's Engine; and stand-ins of the gather
written against the list of QueryResults reach the render.
"""

import json

import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.engine import Engine as JaxEngine
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.oracle import oracle_search
from nextsearch_tpu.index.segmentio import save_manifest, write_segment
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch import native
from nextsearch_tpu_torch.engine import Engine as TorchEngine
from nextsearch_tpu_torch.engine import _render_columns
from nextsearch_tpu_torch.index.planner import QueryResult, ResultColumns
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.utils.profiling import GLOBAL_TRACER

from conftest import make_synthetic_docs

torch.set_num_threads(1)

WORDS = [f"w{i:04d}" for i in range(220)]


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
        # words of one or two documents: rows with fewer hits than k
        build_segment_arrays([
            {"cord_uid": f"rare{i}", "title": "", "relpath": f"r/{i}.json",
             "tokens": toks}
            for i, toks in enumerate([["zeta", "w0000", "w0003"],
                                      ["zeta", "eta"], ["theta", "w0001"]])]),
    ]


def _index(segs, **kw):
    dev = dict(posting_block=64, chunk_buckets=(64, 256, 1024),
               dense_df_ratio=0.02)
    dev.update(kw)
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(**dev))
    return TorchIndex(segs, config=cfg, device="cpu")


def _heavy_terms(ti):
    return sorted({t for lex in ti.lex for t, v in lex.items() if v[2] >= 0})


def _batch(ti, seed, n=40):
    """Random 1-4-term queries, 1-term heavy ones (the sparse mode's
    shortcuts), rare terms of fewer postings than k, a term no document
    has and an empty query."""
    r = np.random.default_rng(seed)
    heavy = _heavy_terms(ti)
    out = [[(WORDS[int(r.integers(0, 220))], float(r.uniform(0.2, 1.5)))
            for _ in range(int(r.integers(1, 5)))] for _ in range(n)]
    return out + [[(heavy[0], 1.0)], [(heavy[1], 1.0)], [("zeta", 1.0)],
                  [("eta", 1.0), ("theta", 0.5)], [("nosuchterm", 1.0)], []]


# case: (index settings, environment, batch, the handle's tag)
CASES = {
    "fused_packed": (dict(mode="fused"), {}, "random", "packed"),
    "exact_pending": (dict(mode="exact"), {}, "random", "pending"),
    "fast_pending": (dict(mode="fast"), {}, "random", "pending"),
    "sparse_packedg_sorted": (
        dict(mode="sparse"), {"NEXTSEARCH_SORT_QUERIES": "1"}, "random",
        "packedg"),
    "sparse_packedg_rescued": (
        dict(mode="sparse", fast_heavy_eps=1e9),
        {"NEXTSEARCH_TRIP_RESCUE": "100"}, "random", "packedg"),
    "sparse_packedg_relaunched": (
        dict(mode="sparse", fast_heavy_eps=1e9),
        {"NEXTSEARCH_TRIP_RESCUE": "0"}, "random", "packedg"),
    "sparse_packed": (dict(mode="sparse", fast_heavy=False), {}, "random",
                      "packed"),
    "fills": (dict(mode="sparse"), {}, "heavy", "fills"),
    "empty": (dict(mode="fused"), {}, "random", "empty"),
}


def _unpack_per_query(vals, slots, found, perm=None, fills=None):
    """A launch's unpack a query at a time: each row's positive scores, the
    row of launch j put back at perm[j], then the host's answers."""
    res = []
    for qi in range(len(vals)):
        keep = vals[qi] > 0.0
        res.append(QueryResult(vals[qi][keep], slots[qi][keep],
                               int(found[qi])))
    if perm is not None:
        unperm = [res[0]] * len(res)
        for j in range(len(res)):
            unperm[perm[j]] = res[j]
        res = unperm
    for qi, qr in (fills or {}).items():
        res[qi] = qr
    return res


def _same_rows(cols, rows):
    assert len(cols) == len(rows)
    assert cols.offsets[0] == 0
    assert np.array_equal(np.diff(cols.offsets),
                          [len(qr.scores) for qr in rows])
    assert cols.offsets[-1] == len(cols.scores) == len(cols.doc_slots)
    for got, qr in zip(cols, rows):
        assert np.array_equal(got.scores.view(np.uint32),
                              np.asarray(qr.scores, np.float32).view(np.uint32))
        assert np.array_equal(got.doc_slots, qr.doc_slots)
        assert got.found == qr.found


@pytest.mark.parametrize("k", [3, 10])
@pytest.mark.parametrize("case", list(CASES))
def test_columns_equal_the_per_query_unpack(segs, monkeypatch, case, k):
    """One launch gathered as columns: the same hits, count and found on
    every row as the launch's arrays unpacked a query at a time, and the
    oracle's answer (fast mode's scores within 1e-6, one scatter in any
    order of adds)."""
    settings, env, kind, tag = CASES[case]
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    full = _index(segs, **settings)
    ti = _index([], **settings) if case == "empty" else full
    queries = ([[(t, 1.0)] for t in _heavy_terms(full)[:5]]
               if kind == "heavy" else _batch(full, seed=70 + k))
    built = []
    real_build = ResultColumns.build.__func__

    def build(cls, *args, **kw):
        built.append((args, kw))
        return real_build(cls, *args, **kw)

    monkeypatch.setattr(ResultColumns, "build", classmethod(build))
    handle = ti.search_batch_async(queries, k)
    assert handle[0] == tag
    trips0 = ti.rescue_trips + ti.relaunches
    cols = ti.search_batch_gather(handle)
    assert isinstance(cols, ResultColumns)
    assert cols.scores.dtype == np.float32 and cols.doc_slots.dtype == np.int32
    assert cols.found.dtype == np.int32 and len(cols) == len(queries)
    if "packedg_" in case and case != "sparse_packedg_sorted":
        assert ti.rescue_trips + ti.relaunches > trips0
    ((args, kw),) = built
    assert args[0].shape[1] <= k
    _same_rows(cols, _unpack_per_query(*args, **kw))
    rows = list(cols)
    if case == "empty":
        assert all(qr.found == 0 and qr.scores.size == 0 for qr in rows)
        return
    oracle_segs = [s.to_oracle_segment() for s in segs]
    rtol = 1e-6 if case == "fast_pending" else 0.0
    short = 0
    for terms, qr in zip(queries, rows):
        hits, found = oracle_search(oracle_segs, terms, k=k)
        assert qr.found == found, terms
        assert [ti.locate(int(s)) for s in qr.doc_slots] == [
            (seg, doc) for _s, seg, doc in hits], terms
        assert np.allclose(qr.scores, [s for s, _g, _d in hits], rtol=rtol,
                           atol=0), terms
        short += 0 < len(hits) < k
    if kind == "random":
        assert short > 0  # rows with fewer hits than k


def test_columns_build_unpermutes_and_fills():
    """ResultColumns.build on a permuted launch with host answers: row j
    lands at perm[j], a fill replaces its row whole (launch hits past its
    own dropped), and a fill longer than the launch's width widens it."""
    vals = np.array([[3, 2, 0], [5, 0, 0], [9, 8, 7]], np.float32)
    slots = np.array([[10, 11, 0], [20, 0, 0], [30, 31, 32]], np.int32)
    found = np.array([2, 1, 3], np.int32)
    perm = np.array([2, 0, 1])
    short = QueryResult(np.array([4, 3], np.float32),
                        np.array([40, 41], np.int32), 9)
    long = QueryResult(np.array([4, 3, 2, 1], np.float32),
                       np.array([40, 41, 42, 43], np.int32), 9)
    for fill in (short, long):
        cols = ResultColumns.build(vals, slots, found, perm=perm,
                                   fills={1: fill})
        got = [(r.scores.tolist(), r.doc_slots.tolist(), r.found)
               for r in cols]
        assert got == [([5.0], [20], 1),
                       (fill.scores.tolist(), fill.doc_slots.tolist(), 9),
                       ([3.0, 2.0], [10, 11], 2)]
        assert cols.offsets.tolist() == [0, 1, 1 + len(fill.scores),
                                         3 + len(fill.scores)]
        _same_rows(cols, _unpack_per_query(vals, slots, found, perm,
                                           {1: fill}))
    assert vals[2].tolist() == [9, 8, 7]  # the launch's arrays untouched


def test_columns_read_as_the_list_of_query_results():
    """Length, indexing from either end, slices (a list), iteration and
    from_rows: the batch's QueryResults, whose arrays are views of the
    columns, so that a change made in place to a row is one to the
    columns; from_rows of those rows gives the same columns."""
    vals = np.array([[3, 2, 0], [0, 0, 0], [9, 8, 7], [1, 0, 0]], np.float32)
    slots = np.arange(12, dtype=np.int32).reshape(4, 3)
    cols = ResultColumns.build(vals, slots, np.array([2, 0, 5, 1], np.int32))
    rows = list(cols)
    assert len(cols) == 4 and [len(r.scores) for r in rows] == [2, 0, 3, 1]
    assert cols[-1].doc_slots.tolist() == [9] and cols[2].found == 5
    with pytest.raises(IndexError):
        cols[4]
    tail = cols[1:]
    assert isinstance(tail, list) and [r.found for r in tail] == [0, 5, 1]
    assert [r.found for r in cols[::-2]] == [1, 0]
    for r in cols:
        assert r.doc_slots.base is cols.doc_slots or r.doc_slots.size == 0
        r.doc_slots[:] = r.doc_slots + 100
    assert cols.doc_slots.tolist() == [100, 101, 106, 107, 108, 109]
    again = ResultColumns.from_rows(list(cols))
    for name in ("scores", "doc_slots", "offsets", "found"):
        a, b = getattr(cols, name), getattr(again, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    empty = ResultColumns.from_rows([])
    assert len(empty) == 0 and empty.offsets.tolist() == [0]
    assert empty.scores.dtype == np.float32


METADATA = "\n".join(
    ["cord_uid,title,authors,publish_time,url,abstract"]
    + [f'uid{i:05d},"Title {i}, ""quoted""","Author {i}; B",2020-0{i % 9 + 1}-01,'
       f"https://x.example/{i};https://m/{i},abstract {i}"
       for i in range(0, 120, 3)]) + "\n"


@pytest.fixture(scope="module")
def index_dir(tmp_path_factory, segs):
    d = tmp_path_factory.mktemp("columns") / "index"
    (d / "segments").mkdir(parents=True)
    names = [f"seg_{i:06d}" for i in range(1, len(segs) + 1)]
    for name, seg in zip(names, segs):
        write_segment(seg, d / "segments" / name)
    save_manifest(d / "manifest.bin", names)
    (d / "metadata.csv").write_text(METADATA)
    return d


def _requests(seed, n):
    """(text, k) of 1-4 words, k mixed: a few repeated, a few with a word
    no document has and a few of words of one or two documents."""
    r = np.random.default_rng(seed)
    ks = (1, 2, 3, 5, 7, 10, 16, 25)
    out = []
    for i in range(n):
        words = [WORDS[int(r.integers(0, 220))]
                 for _ in range(int(r.integers(1, 5)))]
        if i % 37 == 5:
            words.append("nosuchword")
        if i % 23 == 7:
            words = ["zeta", "eta"][: 1 + i % 2]
        out.append((" ".join(words), int(ks[int(r.integers(0, len(ks)))])))
    return out + out[:4]


def _counters():
    c = GLOBAL_TRACER.report()["counters"]
    return (c.get("engine.render_columnar", 0), c.get("engine.render_rows", 0))


def _render_per_query(renderer, pending, seg_count, results):
    """The native render a query at a time: each QueryResult's first K
    hits, concatenated in batch order."""
    ks = np.array([p[2] for p in pending], np.int32)
    sc = [qr.scores[:K] for (_i, _q, K, _t), qr in zip(pending, results)]
    sl = [qr.doc_slots[:K] for (_i, _q, K, _t), qr in zip(pending, results)]
    return renderer.render(
        [p[1] for p in pending], seg_count, ks,
        np.array([qr.found for qr in results], np.int32),
        np.array([len(x) for x in sc], np.int32),
        np.concatenate(sc + [np.empty(0, np.float32)]),
        np.concatenate(sl + [np.empty(0, np.int32)]))


def _engine(index_dir, path, mode):
    path.mkdir()
    engine = TorchEngine(index_dir, config=tconfig.EngineConfig(
        device=tconfig.DeviceConfig(mode=mode), native_render=True),
        cache_dir=path, device="cpu")
    assert engine.reload()
    return engine


@pytest.mark.parametrize("mode", ["fused", "sparse"])
def test_engine_renders_columns_as_rows(index_dir, tmp_path, mode):
    """Engine.search_batch with native_render: the fragments rendered from
    the index's columns are the bytes of the render a query at a time and
    of an index that gives a list of QueryResults (as the sharded and
    hybrid ones do), over a few hundred queries of mixed k; the counters
    tell the two apart; the documents and scores are the JAX package's
    Engine's (scores within rtol 1e-5, as the HTTP bodies are held)."""
    if not native.available():
        pytest.skip("native library unavailable")
    engines = {name: _engine(index_dir, tmp_path / name, mode)
               for name in ("columns", "rows")}
    listed = engines["rows"].index
    listed.search_batch_gather = (
        lambda h, real=listed.search_batch_gather: list(real(h)))
    batches = [_requests(80 + b, 100) for b in range(3)]
    got = {}
    for name, engine in engines.items():
        before = _counters()
        got[name] = [r for reqs in batches for r in engine.search_batch(reqs)]
        after = _counters()
        assert (after[0] - before[0], after[1] - before[1]) == (
            (len(batches), 0) if name == "columns" else (0, len(batches)))
    assert [r.fragment for r in got["columns"]] == [
        r.fragment for r in got["rows"]]
    assert engines["columns"].cache._data == engines["rows"].cache._data

    engine = _engine(index_dir, tmp_path / "reference", mode)
    for reqs in batches:
        state = engine.search_batch_async(reqs)
        _out, pending, handle, _kmax, index, _md, seg_count, renderer = state
        cols = index.search_batch_gather(handle)
        assert _render_columns(renderer, pending, seg_count, cols) == (
            _render_per_query(renderer, pending, seg_count, list(cols)))

    (tmp_path / "jax").mkdir()
    ref = JaxEngine(index_dir, config=EngineConfig(
        device=DeviceConfig(mode=mode)), cache_dir=tmp_path / "jax")
    assert ref.reload()
    want = [r for reqs in batches for r in ref.search_batch(reqs)]
    hits = titled = 0
    for frag, body in zip(got["columns"], want):
        body = dict(body)
        body.pop("from_cache", None)
        mine = json.loads(frag.fragment)
        mr, wr = mine.pop("results"), body.pop("results")
        assert mine == body
        assert [dict(r, score=0) for r in mr] == [dict(r, score=0) for r in wr]
        for a, b in zip(mr, wr):
            assert a["score"] == pytest.approx(b["score"], rel=1e-5, abs=0)
        hits += len(mr)
        titled += sum("title" in r for r in mr)
    assert hits > 500 and titled > 50


def _shift_docs(results):
    """An answer altered where it is produced: every doc slot moved by 1."""
    for r in results:
        r.doc_slots[:] = r.doc_slots + 1
    return results


def _drop_half(results):
    """Half of the batch left out: the second half's answers empty."""
    h = len(results) // 2
    return results[:h] + [QueryResult(np.empty(0, np.float32),
                                      np.empty(0, np.int32), 0)
                          for _ in results[h:]]


@pytest.mark.parametrize("fault", [_shift_docs, _drop_half],
                         ids=["answer_altered", "half_batch_left_out"])
def test_gather_stand_ins_reach_the_render(index_dir, tmp_path, monkeypatch,
                                           fault):
    """A stand-in for TorchIndex.search_batch_gather written against the
    list of QueryResults, (self, handle) -> fault(gather): the Engine calls
    it as it is, and what it gives is what is rendered, a change in place
    to the rows' arrays as well as a new list."""
    if not native.available():
        pytest.skip("native library unavailable")
    reqs = [(q, 10) for q, _k in _requests(95, 64)]
    clean = _engine(index_dir, tmp_path / "clean", "fused").search_batch(reqs)
    real = TorchIndex.search_batch_gather
    monkeypatch.setattr(TorchIndex, "search_batch_gather",
                        lambda self, h: fault(real(self, h)))
    before = _counters()
    faulted = _engine(index_dir, tmp_path / "faulted", "fused").search_batch(
        reqs)
    after = _counters()
    assert (after[0] - before[0], after[1] - before[1]) == (
        (1, 0) if fault is _shift_docs else (0, 1))
    bodies = [(json.loads(a.fragment), json.loads(b.fragment))
              for a, b in zip(clean, faulted)]
    hit = [(a, b) for a, b in bodies if a["results"]]
    assert len(hit) > 20
    if fault is _shift_docs:
        for a, b in hit:
            assert b["found"] == a["found"]
            assert [r["docId"] for r in b["results"]] != [
                r["docId"] for r in a["results"]]
        return
    h = len(reqs) // 2
    assert [b for _a, b in bodies[:h]] == [a for a, _b in bodies[:h]]
    assert all(b["results"] == [] and b["found"] == 0
               for _a, b in bodies[h:])
    assert any(a["results"] for a, _b in bodies[h:])
