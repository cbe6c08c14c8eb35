"""The port's hybrid rerank (ops/dense.hybrid_rerank, models/hybrid.py) on the
CPU against the JAX package's: hybrid_rerank (doc order exact, scores rtol
2e-5), the doc embeddings of both builds (within 1e-6), HybridIndex results
over every kind of BM25 handle a TorchIndex returns (fused "packed",
exact/fast "pending", sparse "packed", sparse "packedg" with a forced guard
trip, sparse "fills"), and the cases of tests/test_hybrid.py.

The handle kind of each launch is recorded and asserted, so each case
covers the branch it names."""

import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu.models.hybrid import HybridIndex as JaxHybrid
from nextsearch_tpu.models.semantic import SemanticIndex as JaxSemantic
from nextsearch_tpu.ops import dense as jdense
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.models.hybrid import HybridIndex
from nextsearch_tpu_torch.models.semantic import SemanticIndex
from nextsearch_tpu_torch.ops import dense as tdense

from conftest import make_synthetic_docs

torch.set_num_threads(1)

VOCAB = 120


def _same_results(got, want, rtol=2e-5):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.found == b.found
        assert a.doc_slots.tolist() == np.asarray(b.doc_slots).tolist()
        np.testing.assert_allclose(a.scores, b.scores, rtol=rtol, atol=0)


# ------------------------------------------------------------ hybrid_rerank


@pytest.mark.parametrize("beta", [0.0, 0.3, 0.5, 1.0])
def test_hybrid_rerank_matches_jax(beta):
    r = np.random.default_rng(int(beta * 10))
    n, d, Q, C = 700, 24, 9, 40
    doc = r.normal(size=(n, d)).astype(np.float32)
    doc /= np.linalg.norm(doc, axis=1, keepdims=True)
    q = r.normal(size=(Q, d)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q[-1] = 0.0  # an envelope padding row
    cand = np.stack([r.choice(n, C, replace=False) for _ in range(Q)]).astype(np.int32)
    bm25 = r.uniform(0.5, 9.0, (Q, C)).astype(np.float32)
    bm25[:, C - 7:] = 0.0  # dead slots ...
    cand[:, C - 3:] = 2**30  # ... some with the fills' padding id
    bm25[4] = 0.0  # a row with no candidate at all
    for K in (10, C + 5):
        jv, jd, jb = (np.asarray(x) for x in jdense.hybrid_rerank(
            doc, q, cand, bm25, np.float32(beta), K=K))
        tv, td, tb = tdense.hybrid_rerank(
            torch.from_numpy(doc), torch.from_numpy(q), torch.from_numpy(cand),
            torch.from_numpy(bm25), beta, K=K)
        assert td.dtype == torch.int32 and tv.shape == jv.shape
        assert np.array_equal(td.numpy(), jd)
        assert np.array_equal(tb.numpy(), jb)
        live = jb > 0
        np.testing.assert_allclose(tv.numpy()[live], jv[live], rtol=2e-5, atol=0)
        assert (td.numpy()[~live] == 2**30).all()


# ------------------------------------------------------------ HybridIndex


def _vectors(seed=11, dim=16):
    """Every corpus term, 8 to a cluster (centre + 0.65 noise), plus a few
    terms the corpus lacks."""
    r = np.random.default_rng(seed)
    terms = [f"w{i:04d}" for i in range(VOCAB)] + ["zzz", "yyy"]
    centres = r.normal(size=(len(terms) // 8 + 1, dim))
    vecs = centres[np.arange(len(terms)) // 8] + 0.65 * r.normal(size=(len(terms), dim))
    return terms, vecs.astype(np.float32)


@pytest.fixture(scope="module")
def world():
    segs = [build_segment_arrays(make_synthetic_docs(300, VOCAB, seed=7)),
            build_segment_arrays(make_synthetic_docs(90, VOCAB, seed=8, avg_len=30))]
    terms, vecs = _vectors()
    jsem, tsem = JaxSemantic(), SemanticIndex(device="cpu")
    assert jsem.load_from_arrays(terms, vecs) and tsem.load_from_arrays(terms, vecs)
    return segs, jsem, tsem


def _pair(world, n_segs=2, **device):
    segs, jsem, tsem = world
    base = dict(posting_block=64, chunk_buckets=(64, 256, 1024),
                dense_df_ratio=0.02)
    base.update(device)
    ji = DeviceIndex(segs[:n_segs], config=EngineConfig(device=DeviceConfig(**base)))
    ti = TorchIndex(segs[:n_segs], config=tconfig.EngineConfig(
        device=tconfig.DeviceConfig(**base)), device="cpu")
    return ji, ti


def _queries(seed=5, n=24):
    r = np.random.default_rng(seed)
    out = [[("w0000", 1.0)], [("zzz", 1.0)], [("w0003", 1.0), ("w0050", 0.6)]]
    for _ in range(n):
        w = int(r.integers(1, 7))
        picks = r.choice(VOCAB, w, replace=False)
        out.append([(f"w{int(t):04d}", float(np.float32(r.uniform(0.3, 1.0))))
                    for t in picks])
    return out


def _handles(ti):
    """Record every handle ti.search_batch_async returns."""
    handles = []
    orig = ti.search_batch_async

    def spy(*a, **kw):
        handles.append(orig(*a, **kw))
        return handles[-1]
    ti.search_batch_async = spy
    return handles


@pytest.mark.parametrize("build,chunk", [("1", 262144), ("1", 7), ("0", 262144)])
def test_doc_emb_matches_jax(world, monkeypatch, build, chunk):
    ji, ti = _pair(world)
    _segs, jsem, tsem = world
    monkeypatch.setenv("NEXTSEARCH_HYBRID_DEVICE_BUILD", build)
    ref = np.asarray(JaxHybrid(ji, jsem, chunk=chunk).doc_emb)
    got = HybridIndex(ti, tsem, chunk=chunk).doc_emb
    assert got.shape == ref.shape == (ti.n_slots, 16)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-6)
    assert (np.linalg.norm(ref[:ti.n_docs], axis=1) > 0.99).all()


HANDLES = {
    # case: (device config, query set, the BM25 handle kind it must take)
    "fused packed": (dict(), "mixed", "packed"),
    "exact pending": (dict(mode="exact"), "mixed", "pending"),
    "fast pending": (dict(mode="fast"), "mixed", "pending"),
    "sparse packed": (dict(mode="sparse", fast_heavy=False), "mixed", "packed"),
    "sparse packedg, guard tripped": (
        dict(mode="sparse", fast_heavy=True, fast_heavy_eps=1e9), "mixed",
        "packedg"),
    "sparse packedg": (dict(mode="sparse", fast_heavy=True), "mixed", "packedg"),
    "sparse fills": (dict(mode="sparse"), "single", "fills"),
}


@pytest.mark.parametrize("case", list(HANDLES))
def test_search_batch_matches_jax_per_handle_kind(world, case):
    device, qset, tag = HANDLES[case]
    ji, ti = _pair(world, **device)
    _segs, jsem, tsem = world
    if qset == "single":
        # 1-term head-heavy queries: answered by the host shortcut tables
        queries, k, C = [[("w0000", 1.0)], [("w0001", 1.0)], [("w0002", 1.0)]], 3, 8
    else:
        queries, k, C = _queries(), 10, 100
    ref = JaxHybrid(ji, jsem, beta=0.4).search_batch(queries, k=k, candidates=C)
    hy = HybridIndex(ti, tsem, beta=0.4)
    bm_handles = _handles(ti)
    rescued = ti.rescue_trips
    handle = hy.search_batch_async(queries, k, C)
    assert handle[0] == "hybrid" and [h[0] for h in bm_handles] == [tag]
    got = hy.search_batch_gather(handle)
    _same_results(got, ref)
    assert sum(len(g.scores) for g in got) > (3 if qset == "single" else 100)
    if "tripped" in case:
        # every row with a heavy term tripped; the hybrid fixes them up
        # host-side and never relaunches or rescues the BM25 batch
        assert (handle[3].device_outs[4] < 0.5).sum() > 5
        assert ti.relaunches == 0 and ti.rescue_trips == rescued
    # and each result equals the host formula over the same doc_emb
    for q, g in zip(queries, got):
        _same_results([g], [hy._host_hybrid_row(q, k, C)])


def test_sparse_fills_splice_into_a_launch(world):
    """A sparse batch mixing 1-term shortcut queries with launched ones
    splices the fills into the device candidates (perm-free and with the
    K4 query sort, which permutes the launch rows)."""
    ji, ti = _pair(world, mode="sparse", fast_heavy=False)
    _segs, jsem, tsem = world
    queries = [[("w0000", 1.0)]] + _queries(seed=6, n=10) + [[("w0001", 1.0)]]
    ref = JaxHybrid(ji, jsem).search_batch(queries, k=5, candidates=8)
    hy = HybridIndex(ti, tsem)
    for sort in ("0", "1"):
        with pytest.MonkeyPatch.context() as m:
            m.setenv("NEXTSEARCH_SORT_QUERIES", sort)
            bm_handles = _handles(ti)
            h = hy.search_batch_async(queries, 5, 8)
            (bm,) = bm_handles
            assert bm[0] == "packed" and sorted(bm[6]) == [0, 1, 13, 14]
            assert (h[4] is not None) == (sort == "1")
            _same_results(hy.search_batch_gather(h), ref)


def test_pipelined_hybrid_launches(world):
    """Two hybrid launches in flight, gathered in order, equal the
    synchronous calls."""
    _ji, ti = _pair(world, mode="sparse")
    hy = HybridIndex(ti, world[2])
    qa, qb = _queries(seed=1, n=6), _queries(seed=2, n=9)
    sync = [hy.search_batch(q, k=10) for q in (qa, qb)]
    ha, hb = hy.search_batch_async(qa, 10), hy.search_batch_async(qb, 10)
    for h, s in zip((ha, hb), sync):
        _same_results(hy.search_batch_gather(h), s, rtol=0)


# ---------------------------------------------------------------- the cases
# of tests/test_hybrid.py, on a TorchIndex


@pytest.fixture(scope="module")
def setup():
    docs = [
        {"cord_uid": "d0", "text": "covid covid vaccine trial"},
        {"cord_uid": "d1", "text": "covid banana smoothie recipe"},
        {"cord_uid": "d2", "text": "covid corona virus outbreak"},
        {"cord_uid": "d3", "text": "banana apple fruit salad"},
    ]
    seg = build_segment_arrays(docs)
    di = TorchIndex([seg], device="cpu")

    rng = np.random.default_rng(11)
    base_med = rng.normal(size=16).astype(np.float32)
    base_food = rng.normal(size=16).astype(np.float32)

    def near(v, eps=0.15):
        return v + eps * rng.normal(size=16).astype(np.float32)

    terms = ["covid", "corona", "virus", "vaccine", "trial", "outbreak",
             "banana", "apple", "fruit", "smoothie", "recipe", "salad"]
    vecs = np.stack([
        base_med, near(base_med), near(base_med), near(base_med),
        near(base_med), near(base_med),
        base_food, near(base_food), near(base_food), near(base_food),
        near(base_food), near(base_food),
    ])
    sem = SemanticIndex(device="cpu")
    assert sem.load_from_arrays(terms, vecs)
    return di, sem


def _sparse(di, **kw):
    return TorchIndex(di.segments, config=tconfig.EngineConfig(
        device=tconfig.DeviceConfig(mode="sparse", posting_block=64,
                                    chunk_buckets=(64, 256),
                                    dense_df_ratio=0.001, **kw)), device="cpu")


def test_rerank_promotes_semantic_match(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=0.0)
    q = [[("covid", 1.0), ("virus", 1.0)]]
    bm = di.search_batch(q, k=4)[0]
    hres = hy.search_batch(q, k=4, candidates=4)[0]
    assert hres.found == bm.found
    assert set(hres.doc_slots.tolist()) == set(bm.doc_slots.tolist())
    order = hres.doc_slots.tolist()
    assert order.index(1) > order.index(2)


def test_beta_one_matches_bm25_ranking(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=1.0)
    q = [[("covid", 1.0)]]
    bm = di.search_batch(q, k=3)[0]
    hres = hy.search_batch(q, k=3, candidates=4)[0]
    assert hres.doc_slots.tolist() == bm.doc_slots.tolist()
    np.testing.assert_allclose(
        hres.scores, bm.scores / bm.scores.max(), rtol=1e-6
    )


def test_hybrid_scores_sorted_and_bounded(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=0.5)
    res = hy.search_batch([[("covid", 1.0), ("banana", 1.0)]], k=4)[0]
    s = res.scores
    assert np.all(np.diff(s) <= 0)
    assert np.all(s <= 1.0 + 1e-6) and np.all(s >= 0)


def test_no_candidates(setup):
    di, sem = setup
    hy = HybridIndex(di, sem, beta=0.5)
    res = hy.search_batch([[("zzz", 1.0)]], k=4)[0]
    assert res.found == 0 and len(res.scores) == 0


def test_device_build_matches_host_build(setup, monkeypatch):
    di, sem = setup
    monkeypatch.setenv("NEXTSEARCH_HYBRID_DEVICE_BUILD", "1")
    dev = HybridIndex(di, sem, beta=0.5, chunk=7)
    monkeypatch.setenv("NEXTSEARCH_HYBRID_DEVICE_BUILD", "0")
    host = HybridIndex(di, sem, beta=0.5)
    np.testing.assert_allclose(
        dev.doc_emb.numpy(), host.doc_emb.numpy(), rtol=1e-5, atol=1e-6,
    )


def test_async_matches_sync(setup):
    hy = HybridIndex(*setup, beta=0.5)
    queries = [
        [("covid", 1.0), ("virus", 1.0)],
        [("banana", 1.0)],
        [("zzz", 1.0)],
    ]
    sync = [hy.search_batch([q], k=4, candidates=4)[0] for q in queries]
    handles = [hy.search_batch_async([q], 4, 4) for q in queries]
    for h, s in zip(handles, sync):
        (a,) = hy.search_batch_gather(h)
        assert a.found == s.found
        assert a.doc_slots.tolist() == s.doc_slots.tolist()
        np.testing.assert_array_equal(a.scores, s.scores)


def test_engine_hybrid_endpoint(tmp_path):
    """Engine.search_hybrid: response shape, the cache, the plain search
    unaffected."""
    from nextsearch_tpu_torch.engine import Engine
    from nextsearch_tpu_torch.index.segmentio import save_manifest, write_segment

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    docs = [
        {"cord_uid": "h1", "text": "covid vaccine trial"},
        {"cord_uid": "h2", "text": "covid corona outbreak"},
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    (d / "metadata.csv").write_text("cord_uid,title\nh1,One\nh2,Two\n")
    rng = np.random.default_rng(0)
    terms = ["covid", "vaccine", "trial", "corona", "outbreak"]
    lines = [
        t + " " + " ".join(f"{x:.5f}" for x in rng.normal(size=12))
        for t in terms
    ]
    (d / "embeddings.vec").write_text("\n".join(lines) + "\n")

    e = Engine(d, cache_dir=tmp_path, device="cpu")
    assert e.reload() and e.sem.enabled
    j = e.search_hybrid("covid vaccine", 5)
    assert j["hybrid"] is True and j["found"] == 2
    assert all("hybrid_score" in r for r in j["results"])
    j2 = e.search_hybrid("covid vaccine", 5)
    assert j2.get("from_cache") is True
    j3 = e.search("covid vaccine", 5)
    assert "hybrid" not in j3


def test_hybrid_over_sparse_mode_index(setup):
    di, sem = setup
    di_sp = _sparse(di)
    assert di_sp.n_dense > 0
    hy_f = HybridIndex(di, sem, beta=0.5)
    hy_s = HybridIndex(di_sp, sem, beta=0.5)
    queries = [
        [("covid", 1.0), ("virus", 1.0)],
        [("banana", 1.0)],
        [("covid", 1.0)],
        [("zzz", 1.0)],
    ]
    handle = hy_s.search_batch_async(queries, 4, candidates=4)
    assert handle[0] == "hybrid"
    res_s = hy_s.search_batch_gather(handle)
    res_f = hy_f.search_batch(queries, k=4, candidates=4)
    _same_results(res_s, res_f, rtol=1e-5)


def test_hybrid_sparse_guard_trip_fixup(setup):
    di, sem = setup
    di_sp = _sparse(di, fast_heavy=True, fast_heavy_eps=1e9)
    hy_f = HybridIndex(di, sem, beta=0.5)
    hy_s = HybridIndex(di_sp, sem, beta=0.5)
    queries = [
        [("covid", 1.0), ("virus", 1.0)],
        [("banana", 1.0)],
        [("covid", 1.0)],
        [("zzz", 1.0)],
    ]
    res_s = hy_s.search_batch(queries, k=4, candidates=4)
    res_f = hy_f.search_batch(queries, k=4, candidates=4)
    _same_results(res_s, res_f, rtol=1e-5)


def test_hybrid_all_fill_batch(setup):
    di, sem = setup
    di_sp = _sparse(di)
    hy_f = HybridIndex(di, sem, beta=0.5)
    hy_s = HybridIndex(di_sp, sem, beta=0.5)
    queries = [[("covid", 1.0)], [("banana", 1.0)]]
    h = hy_s.search_batch_async(queries, 3, candidates=4)
    res_s = hy_s.search_batch_gather(h)
    res_f = hy_f.search_batch(queries, k=3, candidates=4)
    _same_results(res_s, res_f, rtol=1e-5)
