"""The launch cache (nextsearch_tpu_torch/ops/graphs.py) on the CPU, through
a stand-in capture backend: one capture per key and replays after it, the
key's statics and shapes, the pinned envelope's one key, the launch
counters, results that do not alias, the off switch, a capture that fails,
the cache going with its index, Engine.warmup capturing each pinned scope,
and TorchIndex through the cache bit-equal to the JAX DeviceIndex and to
the same index run eagerly."""

import contextlib
import gc
import weakref

import numpy as np
import pytest
import torch

from nextsearch_tpu.config import DeviceConfig, EngineConfig
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu_torch import config as tconfig
from nextsearch_tpu_torch.index.segment import TorchIndex
from nextsearch_tpu_torch.ops import graphs
from nextsearch_tpu_torch.ops import heavy_kernels as hk

from test_pinning import _mk_segments, _queries
from test_torch_index import port_config

torch.set_num_threads(1)


class FakeGraphs:
    """Capture and replay without a card: a "graph" recomputes the captured
    call on its static inputs and writes the result into the static output
    in place, with the launch counters held still (the cache adds what the
    capture recorded)."""

    def __init__(self, fail=None):
        self.warmed = self.captured = self.replayed = 0
        self.fail = fail

    def pool(self, device):
        return object()

    def warm(self, fn, device):
        self.warmed += 1
        fn()

    def capture(self, fn, pool, device):
        if self.fail is not None:
            raise self.fail
        self.captured += 1
        out = fn()

        def graph():
            saved = graphs.read_counters()
            new = fn()
            graphs.write_counters(saved)
            for o, n in zip((out,) if torch.is_tensor(out) else out,
                            (new,) if torch.is_tensor(new) else new):
                o.copy_(n)

        return graph, out

    def replay(self, graph):
        self.replayed += 1
        graph()


def affine(x, *, table, scale, offset=0):
    """A stand-in launch: counts one K3 launch per call, as a wrapper does."""
    hk.gather_rows.launches += 1
    return x * scale + table[: x.shape[0]] + offset


@pytest.fixture
def cache():
    return graphs.LaunchCache("cpu", backend=FakeGraphs())


def _x(seed, n=6):
    return torch.from_numpy(np.random.default_rng(seed).random(n, np.float32))


TABLE = torch.arange(16, dtype=torch.float32)


def test_one_capture_per_key_then_replays(cache):
    outs = [cache.run(affine, {"x": _x(s)}, dict(table=TABLE, scale=2.0))
            for s in range(4)]
    assert (cache.captures, cache.replays, cache.eager) == (1, 4, 0)
    assert (cache.backend.warmed, cache.backend.captured) == (1, 1)
    assert cache.copies == 4 * 2  # each replay: x in, the result out
    for s, out in enumerate(outs):
        assert torch.equal(out, affine(_x(s), table=TABLE, scale=2.0))
    assert len(cache.keys()) == 1
    name, shapes, statics = cache.keys()[0]
    assert name == "affine" and shapes == (("x", (6,), torch.float32),)
    assert ("table", ("tensor", id(TABLE), TABLE.data_ptr(), (16,),
                      torch.float32)) in statics


STATICS = dict(U=32, C=256, L2=128, H2=128, w_max=0, fast_heavy=True, K=10)


def keyed(x, **statics):
    return x + sum(float(v) for v in statics.values())


@pytest.mark.parametrize("name,value", [
    ("U", 48), ("C", 1024), ("L2", 256), ("H2", 256), ("w_max", 512),
    ("fast_heavy", False), ("K", 32), ("plan", None),
])
def test_each_static_and_plan_shape_makes_a_key(cache, name, value):
    cache.run(keyed, {"x": _x(0)}, STATICS)
    if name == "plan":
        cache.run(keyed, {"x": _x(0, n=7)}, STATICS)
    else:
        cache.run(keyed, {"x": _x(0)}, {**STATICS, name: value})
    cache.run(keyed, {"x": _x(1)}, STATICS)  # the first key again
    assert (cache.captures, cache.replays) == (2, 3)


def test_ambient_switches_make_a_key(fake_backend, monkeypatch):
    """The switches a sparse launch reads from the environment
    (NEXTSEARCH_SORT2_2LEVEL, NEXTSEARCH_H_BF16) are read where TorchIndex
    calls the cache and passed as statics, so each makes its own key, and
    the first key replays once they are back."""
    ti = TorchIndex(_mk_segments(), config=port_config(_sparse_cfg()),
                    device="cpu")
    batch = _queries(np.random.default_rng(5), 48, 8, tmin=2)
    ti.search_batch(batch, k=10)
    monkeypatch.setenv("NEXTSEARCH_SORT2_2LEVEL", "1")
    ti.search_batch(batch, k=10)
    monkeypatch.setenv("NEXTSEARCH_SORT2_2LEVEL", "0")
    monkeypatch.setenv("NEXTSEARCH_H_BF16", "1")
    ti.search_batch(batch, k=10)
    monkeypatch.setenv("NEXTSEARCH_H_BF16", "0")
    ti.search_batch(batch, k=10)
    cache = ti.launch_cache
    assert (cache.captures, cache.replays) == (3, 4)
    switches = {(dict(s)["two_level"], dict(s)["h_bf16"])
                for _n, _sh, s in cache.keys()}
    assert switches == {(False, False), (True, False), (False, True)}


def test_counters_are_registered_by_their_modules():
    """Every kernel wrapper's counter is in cuda_build.COUNTERS, where its
    own module put it, and nowhere twice."""
    from nextsearch_tpu_torch.ops import bm25_sparse, cuda_build
    from nextsearch_tpu_torch.ops import probe_kernels as pk
    from nextsearch_tpu_torch.ops import score_kernels as se
    from nextsearch_tpu_torch.ops import select_kernels as sk

    want = {(id(fn), "launches") for fn in (*hk._WRAPPERS, *pk._WRAPPERS,
                                            sk.per_query_topk,
                                            se.score_epilogue)}
    want.add((id(bm25_sparse.topk_quantized_reduce), "calls"))
    got = [(id(obj), attr) for obj, attr in cuda_build.COUNTERS]
    assert set(got) == want and len(got) == len(want)


def test_a_replay_advances_a_registered_counter(cache):
    from nextsearch_tpu_torch.ops import select_kernels as sk

    def select(x):
        sk.per_query_topk.launches += 2
        return x + 1

    n0 = sk.per_query_topk.launches
    for i in range(3):
        cache.run(select, {"x": _x(i)}, {})
    assert sk.per_query_topk.launches == n0 + 2 + 3 * 2


def test_capture_stream_is_one_per_device(monkeypatch):
    """CudaGraphs captures on a stream of the cache's own card, one per
    card and reused, never torch.cuda.graph's one default stream, which
    lies on the card that captured first."""
    made, used = [], []

    class Stream:
        def __init__(self, device):
            self.device = device
            made.append(self)

    class Graph:
        def __init__(self, graph, pool=None, stream=None, **kw):
            used.append(stream)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    cuda = torch.cuda
    monkeypatch.setattr(cuda, "Stream", Stream)
    monkeypatch.setattr(cuda, "graph", Graph)
    monkeypatch.setattr(cuda, "CUDAGraph", lambda: "graph")
    monkeypatch.setattr(cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(graphs.CudaGraphs, "_capture", {})
    backend = graphs.CudaGraphs()
    devs = [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    for d in devs:
        assert backend.capture(lambda: torch.zeros(1), None, d)[0] == "graph"
    assert [s.device for s in made] == devs[:2]
    assert used == [made[0], made[1], made[0], made[1]]


def test_enabled_false_runs_eagerly_without_the_env_log(monkeypatch, capsys):
    """eager_cache (the A/B's eager side) is LaunchCache(enabled=False):
    eager, and silent about a variable nobody set."""
    from nextsearch_tpu_torch.benchmarks.common import eager_cache

    monkeypatch.setattr(graphs, "CPU_BACKEND", FakeGraphs())
    cache = eager_cache("cpu")
    assert cache.backend is None and not cache.enabled
    assert "NEXTSEARCH_CUDA_GRAPHS" not in capsys.readouterr().err
    cache.run(affine, {"x": _x(0)}, dict(table=TABLE, scale=2.0))
    assert (cache.captures, cache.eager) == (0, 1)


@pytest.mark.parametrize("env", ["0", "1"])
def test_two_level_argument_overrides_the_environment(monkeypatch, env):
    """per_query_topk_flat's two_level, as a graphed launch passes it,
    decides the 2-level reduction whatever NEXTSEARCH_SORT2_2LEVEL says;
    None reads the variable."""
    from nextsearch_tpu_torch.ops import bm25_sparse as tsp

    monkeypatch.setenv("NEXTSEARCH_SORT2_2LEVEL", env)
    Q, n = 8, 32768
    rng = np.random.default_rng(6)
    sq = torch.from_numpy(np.sort(rng.integers(0, Q, n)).astype(np.int32))
    score = torch.from_numpy(rng.random(n, np.float32))
    payload = torch.arange(n, dtype=torch.int32)
    outs = []
    for two_level, taken in ((True, 1), (False, 0), (None, int(env))):
        c0 = tsp.topk_quantized_reduce.calls
        outs.append(tsp.per_query_topk_flat(sq, score, payload, Q, 16,
                                            quantized=True,
                                            two_level=two_level))
        assert tsp.topk_quantized_reduce.calls == c0 + taken
    for d, v in outs[1:]:
        assert torch.equal(d, outs[0][0]) and torch.equal(v, outs[0][1])


def test_counters_advance_by_the_captured_amount(cache):
    n0 = hk.gather_rows.launches
    cache.run(affine, {"x": _x(0)}, dict(table=TABLE, scale=1.0))
    # the eager call of the miss launched once, the capture nothing, the
    # replay once
    assert hk.gather_rows.launches == n0 + 2
    for i in range(3):
        cache.run(affine, {"x": _x(i)}, dict(table=TABLE, scale=1.0))
    assert hk.gather_rows.launches == n0 + 5


def test_pipelined_results_do_not_alias(cache):
    first = cache.run(affine, {"x": _x(0)}, dict(table=TABLE, scale=3.0))
    keep = first.clone()
    second = cache.run(affine, {"x": _x(1)}, dict(table=TABLE, scale=3.0))
    assert torch.equal(first, keep)
    assert not torch.equal(first, second)
    assert first.data_ptr() != second.data_ptr()


def test_tuple_outputs_are_copied(cache):
    def pair(x):
        return x + 1, x * 2

    a = cache.run(pair, {"x": _x(0)}, {})
    b = cache.run(pair, {"x": _x(1)}, {})
    assert torch.equal(a[0], _x(0) + 1) and torch.equal(b[1], _x(1) * 2)
    assert cache.copies == 2 * 3


def test_off_switch_runs_eagerly_and_logs(monkeypatch, capsys):
    monkeypatch.setenv("NEXTSEARCH_CUDA_GRAPHS", "0")
    cache = graphs.LaunchCache("cpu", backend=FakeGraphs())
    assert "NEXTSEARCH_CUDA_GRAPHS=0" in capsys.readouterr().err
    n0 = hk.gather_rows.launches
    out = cache.run(affine, {"x": _x(0)}, dict(table=TABLE, scale=2.0))
    assert torch.equal(out, affine(_x(0), table=TABLE, scale=2.0))
    assert (cache.captures, cache.replays, cache.eager) == (0, 0, 1)
    assert hk.gather_rows.launches == n0 + 2  # ours and the check's


def test_cpu_cache_without_backend_runs_as_is():
    cache = graphs.LaunchCache("cpu")
    assert cache.backend is None and cache.enabled
    cache.run(affine, {"x": _x(0)}, dict(table=TABLE, scale=2.0))
    assert (cache.captures, cache.eager) == (0, 1)


def test_capture_error_propagates():
    cache = graphs.LaunchCache(
        "cpu", backend=FakeGraphs(fail=RuntimeError("host sync in capture")))
    n0 = hk.gather_rows.launches
    for _ in range(2):  # nothing cached, nothing run eagerly in its place
        with pytest.raises(RuntimeError, match="host sync"):
            cache.run(affine, {"x": _x(0)}, dict(table=TABLE, scale=2.0))
    assert (cache.captures, cache.replays, cache.eager) == (0, 0, 0)
    assert hk.gather_rows.launches == n0 + 2  # the two eager warm calls


def test_non_tensor_output_raises(cache):
    with pytest.raises(TypeError, match="tensor"):
        cache.run(lambda x: [x], {"x": _x(0)}, {})


# ---------------------------------------------------------- TorchIndex


def _sparse_cfg(**kw):
    return EngineConfig(device=DeviceConfig(
        mode="sparse", dense_df_ratio=1 / 8, **kw))


@pytest.fixture
def fake_backend(monkeypatch):
    fake = FakeGraphs()
    monkeypatch.setattr(graphs, "CPU_BACKEND", fake)
    return fake


def _same(a, b):
    for x, y in zip(a, b):
        assert x.found == y.found
        assert np.array_equal(np.asarray(x.scores, np.float32).view(np.uint32),
                              np.asarray(y.scores, np.float32).view(np.uint32))
        assert np.array_equal(x.doc_slots, y.doc_slots)


def test_pinned_sparse_envelope_captures_one_key(fake_backend):
    """The port of test_pinned_sparse_shapes_are_batch_invariant: inside
    the pinned envelope a stream of differing batches makes one key, and
    every result equals the JAX DeviceIndex's and the eager index's."""
    segs = _mk_segments()
    cfg = _sparse_cfg()
    di = DeviceIndex(segs, config=cfg)
    ti = TorchIndex(segs, config=port_config(cfg), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CPU_BACKEND", None)
        eager = TorchIndex(segs, config=port_config(cfg), device="cpu")
    assert ti.launch_cache.backend is fake_backend
    assert eager.launch_cache.backend is None
    rng = np.random.default_rng(0)
    probe = [_queries(rng, 48, n) for n in (8, 16)]
    for index in (di, ti, eager):
        index.pin_shapes(probe)
    for n in (1, 3, 8, 11, 16):
        batch = _queries(rng, 48, n)
        got = ti.search_batch(batch, k=10)
        _same(got, di.search_batch(batch, k=10))
        _same(got, eager.search_batch(batch, k=10))
    keys = {(name, shapes) for name, shapes, _s in ti.launch_cache.keys()}
    assert len(keys) == 1, keys
    assert ti.launch_cache.captures == 1
    assert ti.launch_cache.replays >= 4


def test_guard_trip_relaunch_is_its_own_key(fake_backend, monkeypatch):
    """fast_heavy_eps so large that every guard trips: the exact full-table
    relaunch is a second key (U 0, fast_heavy off), replayed on the next
    trip, and the results stay the JAX DeviceIndex's."""
    monkeypatch.setenv("NEXTSEARCH_TRIP_RESCUE", "0")
    segs = _mk_segments()
    cfg = _sparse_cfg(fast_heavy_eps=1e9)
    di = DeviceIndex(segs, config=cfg)
    ti = TorchIndex(segs, config=port_config(cfg), device="cpu")
    rng = np.random.default_rng(4)
    probe = [_queries(rng, 48, 16, tmin=2) for _ in range(2)]
    di.pin_shapes(probe)
    ti.pin_shapes(probe)
    for _ in range(3):
        batch = _queries(rng, 48, 16, tmin=2)
        _same(ti.search_batch(batch, k=10), di.search_batch(batch, k=10))
    assert ti.relaunches == 3
    statics = [dict(s) for _n, _sh, s in ti.launch_cache.keys()]
    assert sorted((s["fast_heavy"], s["U"] == 0) for s in statics) == [
        (False, True), (True, False)]
    assert ti.launch_cache.captures == 2 and ti.launch_cache.replays == 6


@pytest.mark.parametrize("mode", ["fused", "fast"])
def test_fused_and_fast_launches_through_the_cache(fake_backend, mode):
    segs = _mk_segments()
    cfg = EngineConfig(device=DeviceConfig(mode=mode, dense_df_ratio=1 / 8))
    di = DeviceIndex(segs, config=cfg)
    ti = TorchIndex(segs, config=port_config(cfg), device="cpu")
    rng = np.random.default_rng(3)
    probe = [_queries(rng, 48, n) for n in (4, 12)]
    di.pin_shapes(probe)
    ti.pin_shapes(probe)
    for n in (2, 5, 9, 12):
        batch = _queries(rng, 48, n)
        got, want = ti.search_batch(batch, k=10), di.search_batch(batch, k=10)
        if mode == "fused":
            _same(got, want)
        else:  # fast mode's scatter adds in any order: found and docs
            assert [x.found for x in got] == [y.found for y in want]
    assert ti.launch_cache.captures == 1 and ti.launch_cache.replays == 4


def test_exact_mode_stays_eager(fake_backend):
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(
        mode="exact", dense_df_ratio=1 / 8))
    ti = TorchIndex(_mk_segments(), config=cfg, device="cpu")
    ti.search_batch(_queries(np.random.default_rng(1), 48, 4), k=10)
    assert ti.launch_cache.captures == 0 and ti.launch_cache.replays == 0


def test_the_cache_goes_with_its_index(fake_backend):
    ti = TorchIndex(_mk_segments(), config=port_config(_sparse_cfg()),
                    device="cpu")
    ti.search_batch(_queries(np.random.default_rng(2), 48, 8, tmin=2), k=10)
    assert ti.launch_cache.captures == 1
    refs = [weakref.ref(ti), weakref.ref(ti.launch_cache),
            weakref.ref(ti.dense_rows)]
    del ti
    gc.collect()
    assert all(r() is None for r in refs)


# ---------------------------------------------------------- Engine.warmup


@pytest.mark.parametrize("mode", ["sparse", "fused"])
def test_engine_warmup_captures_one_graph_per_pinned_scope(
        tmp_path, monkeypatch, fake_backend, mode):
    """The scopes as test_engine_warmup_pins_scopes computes them: warmup
    captures one launch per pinned Q envelope and T envelope, keyword
    queries' (T 4) and questions' (T 8) (a guard trip may add the relaunch
    of the same envelope)."""
    from nextsearch_tpu.index.segmentio import save_manifest, write_segment
    from nextsearch_tpu_torch.engine import Engine
    from nextsearch_tpu_torch.index.planner import _bucket as _b

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    rng = np.random.default_rng(9)
    docs = [
        {"cord_uid": f"d{i}",
         "tokens": [f"w{t:03d}" for t in rng.integers(0, 48, size=12)]}
        for i in range(200)
    ]
    write_segment(build_segment_arrays(docs), d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    monkeypatch.chdir(tmp_path)
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(mode=mode))
    eng = Engine(d, config=cfg, cache_dir=tmp_path, device="cpu")
    assert eng.reload()
    assert eng.warmup(k_values=(10,)) > 0
    mb = eng.config.batching.max_batch
    buckets = list(eng.index.Q_BUCKETS)
    sizes = {q for q in buckets if q < mb}
    sizes |= set(range(buckets[-1] * 2, mb, buckets[-1]))
    sizes.add(mb)
    expected = {_b(s, eng.index.Q_BUCKETS) for s in sizes}
    assert set(eng.index._qpins) == expected
    cache = eng.index.launch_cache
    captured = set()
    for _n, shapes, statics in cache.keys():
        by_name = {name: shape for name, shape, _dt in shapes}
        plan = by_name.get("plan", by_name.get("plan_ints"))
        captured.add((plan[-2], plan[-1], dict(statics).get("fast_heavy")))
    # sparse: the guarded fast launch and its exact relaunch per envelope
    want = {(q, t, f) for q in expected for t in (4, 8)
            for f in ((True, False) if mode == "sparse" else (None,))}
    assert captured == want
    assert cache.captures == len(want)
    # a second warmup over the same pins replays every graph
    n = cache.captures
    eng.warmup(k_values=(10,))
    assert cache.captures == n


def test_reload_warm_captures_on_the_new_index(tmp_path, monkeypatch,
                                               fake_backend):
    from nextsearch_tpu.index.segmentio import save_manifest, write_segment
    from nextsearch_tpu_torch.engine import Engine

    d = tmp_path / "index"
    (d / "segments").mkdir(parents=True)
    segs = _mk_segments(n_docs=120)
    write_segment(segs[0], d / "segments" / "seg_000001")
    save_manifest(d / "manifest.bin", ["seg_000001"])
    monkeypatch.chdir(tmp_path)
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(mode="sparse"))
    eng = Engine(d, config=cfg, cache_dir=tmp_path, device="cpu")
    assert eng.reload()
    old = weakref.ref(eng.index.launch_cache)
    assert eng.reload(warm=True)
    assert eng.index.launch_cache.captures > 0
    gc.collect()
    assert old() is None


# ---------------------------------------------------------- ShardedIndex


@pytest.mark.parametrize("mode,dp,seg", [("sparse", 2, 2), ("sparse", 1, 4),
                                         ("fused", 2, 2)])
def test_sharded_local_steps_through_the_cache(fake_backend, mode, dp, seg):
    """Each (dp group, shard) local step replays its graph (one cache per
    distinct mesh device; the merge stays eager): results bit-equal to the
    same sharded index run eagerly and to the oracle, one capture per
    shard and key, none after the first pinned batch."""
    from conftest import make_synthetic_docs
    from nextsearch_tpu_torch.parallel.mesh import make_mesh
    from nextsearch_tpu_torch.parallel.sharded import ShardedIndex
    from test_torch_sharded import _oracle_parity

    segs = [build_segment_arrays(make_synthetic_docs(n, 200, seed=s))
            for n, s in ((60, 10), (90, 11), (40, 12), (75, 13))]
    cfg = tconfig.EngineConfig(device=tconfig.DeviceConfig(
        mode=mode, dense_df_ratio=1 / 16, posting_block=64))
    mesh = make_mesh(dp=dp, seg=seg, devices=[torch.device("cpu")] * dp * seg)
    si = ShardedIndex(segs, mesh, config=cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(graphs, "CPU_BACKEND", None)
        eager = ShardedIndex(segs, mesh, config=cfg)
    (cache,) = si.launch_caches.values()
    assert cache.backend is fake_backend
    words = [f"w{i:04d}" for i in range(200)]
    rng = np.random.default_rng(8)
    batches = [[[(words[int(rng.integers(0, 200))], 1.0)
                 for _ in range(int(rng.integers(2, 4)))] for _ in range(8)]
               for _ in range(4)]
    for index in (si, eager):
        index.pin_shapes(batches, scope_q=True)
    si.warm_batch(batches[0], k=10)
    caps = cache.captures
    assert 0 < caps <= 2 * seg
    for b in batches:
        _same(_oracle_parity(si, segs, b), eager.search_batch(b, k=10))
    assert cache.captures == caps
    assert cache.replays >= caps + len(batches) * seg
