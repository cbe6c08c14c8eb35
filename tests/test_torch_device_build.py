"""The index build switches of the torch port against nextsearch_tpu on the
CPU: build_light_on_device and build_row_topk_on_device against the JAX
functions, and TorchIndex under NEXTSEARCH_DEVICE_BUILD=0,
NEXTSEARCH_LIGHT_BUILD=device and NEXTSEARCH_ROW_TOPK_BUILD=device against
the JAX DeviceIndex under the same switch (mirroring tests/test_sparse.py's
device-build and row top-k cases).

Every comparison is bit for bit: tables, occupancies, row top-k values and
slots, search results (and the oracle's scores and doc order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextsearch_tpu.index import device_build as jdb
from nextsearch_tpu.index.builder import build_segment_arrays
from nextsearch_tpu.index.segment import DeviceIndex
from nextsearch_tpu_torch.index import device_build as tdb
from nextsearch_tpu_torch.index.segment import TorchIndex
from conftest import make_synthetic_docs
from test_torch_index import MIXED, _cfg, _random_queries, check, port_config

torch.set_num_threads(1)

SWITCHES = {
    "host_build": {"NEXTSEARCH_DEVICE_BUILD": "0"},
    "light_device": {"NEXTSEARCH_LIGHT_BUILD": "device"},
    "row_topk_device": {"NEXTSEARCH_ROW_TOPK_BUILD": "device"},
    # the light switch only acts beside a device build, as in the reference
    "host_build_light_device": {"NEXTSEARCH_DEVICE_BUILD": "0",
                                "NEXTSEARCH_LIGHT_BUILD": "device",
                                "NEXTSEARCH_ROW_TOPK_BUILD": "device"},
}


@pytest.fixture(scope="module")
def segs():
    return [
        build_segment_arrays(make_synthetic_docs(80, 220, seed=60)),
        build_segment_arrays(make_synthetic_docs(120, 220, seed=61, avg_len=35)),
        build_segment_arrays(make_synthetic_docs(50, 220, seed=62, avg_len=90)),
    ]


def _light_entries(ti):
    """(starts, dfs) per light row of a sparse TorchIndex, in row order."""
    starts = np.zeros(ti.n_light, np.int64)
    dfs = np.zeros(ti.n_light, np.int64)
    for seg_i, lmap in enumerate(ti._light_row):
        for t, row in lmap.items():
            starts[row], dfs[row] = ti.lex[seg_i][t][:2]
    return starts, dfs


@pytest.mark.parametrize("log2", [9, 6, 11])
def test_build_light_on_device_matches_jax(segs, log2):
    """The light table and its occupancy equal the JAX build's at the
    default granularity and at a finer and a coarser one, and the default
    one equals the host-built table the index uploads."""
    ti = TorchIndex(segs, config=port_config(_cfg()), device="cpu")
    starts, dfs = _light_entries(ti)
    assert ti.n_light > 100
    ref, ref_occ = jdb.build_light_on_device(
        jnp.asarray(ti.post_doc.numpy()), starts, dfs,
        n_rows_pad=ti.n_light + 1, n_slots=ti.n_slots, bucket_log2=log2)
    got, occ = tdb.build_light_on_device(
        ti.post_doc, starts, dfs, n_rows_pad=ti.n_light + 1,
        n_slots=ti.n_slots, bucket_log2=log2)
    assert got.dtype == torch.int32 and occ == ref_occ > 1
    assert np.array_equal(got.numpy(), np.asarray(ref))
    if log2 == ti._lb_log2:
        assert np.array_equal(got.numpy(), ti.light_bucket_pos.numpy())
    empty, zero = tdb.build_light_on_device(
        ti.post_doc, starts[:0], dfs[:0], n_rows_pad=1, n_slots=ti.n_slots,
        bucket_log2=log2)
    assert zero == 0 and not empty.any()


def _tie_rows(rows: int, n_slots: int, seed: int) -> np.ndarray:
    """f32 rows with vast tie runs: values on a quarter grid, every third
    row nearly empty (fewer nonzeros than k), one row all zero."""
    rng = np.random.default_rng(seed)
    d = np.zeros((rows, n_slots), np.float32)
    for r in range(rows - 1):
        m = rng.random(n_slots) < (0.002 if r % 3 == 0 else 0.05)
        d[r, m] = (rng.integers(1, 4, int(m.sum())) * 0.25).astype(np.float32)
    return d


def _canonical_topk(row: np.ndarray, k: int):
    order = np.lexsort((np.arange(row.shape[0]), -row))[:k]
    return row[order], order.astype(np.int32)


@pytest.mark.parametrize("k,n_rows,group", [
    (20, 128, 64),
    (20, 100, 64),    # n_rows not a multiple of the group
    (200, 37, 16),    # k past one block's lanes
    (5, 40, 64),      # one group, smaller than the group size
])
def test_build_row_topk_on_device_matches_jax(k, n_rows, group):
    """vals/slots equal the JAX device function's: ties in slot order, rows
    with fewer than k nonzeros ending in zero lanes with real slot ids."""
    d = _tie_rows(128, 2048, seed=k + n_rows)
    v, s = jdb.build_row_topk_on_device(
        jnp.asarray(d.reshape(128, 16, 128)), n_rows, k=k, n_slots=2048,
        group=group)
    tv, ts = tdb.build_row_topk_on_device(
        torch.from_numpy(d), n_rows, k=k, n_slots=2048, group=group)
    assert tv.dtype == np.float32 and ts.dtype == np.int32
    assert tv.shape == ts.shape == (n_rows, k)
    assert np.array_equal(tv.view(np.uint32), np.asarray(v).view(np.uint32))
    assert np.array_equal(ts, np.asarray(s))
    short = (d[:n_rows] > 0).sum(axis=1) < k
    assert short.any() and (tv[short][:, -1] == 0).all()
    for r in range(n_rows):
        cv, cs = _canonical_topk(d[r], k)
        assert np.array_equal(tv[r], cv) and np.array_equal(ts[r], cs)


def test_row_topk_last_partial_group_reads_its_rows():
    """A last group that would run past the table: the JAX function's
    lax.dynamic_slice_in_dim clamps it back inside and reads rows 40-75 for
    rows 64-99; the port reads rows 64-99 (the canonical top-k)."""
    d = _tie_rows(104, 1024, seed=7)
    tv, ts = tdb.build_row_topk_on_device(
        torch.from_numpy(d), 100, k=8, n_slots=1024, group=64)
    for r in range(100):
        cv, cs = _canonical_topk(d[r], 8)
        assert np.array_equal(tv[r], cv) and np.array_equal(ts[r], cs)
    _v, s = jdb.build_row_topk_on_device(
        jnp.asarray(d.reshape(104, 8, 128)), 100, k=8, n_slots=1024)
    assert np.array_equal(ts[:64], np.asarray(s)[:64])


CONFIGS = {
    "sparse_merged": dict(segs=3, kw={}),
    "sparse_one_segment": dict(segs=1, kw={}),
    "bf16_rows": dict(segs=3, kw=dict(dense_rows_bf16=True)),
    "fused": dict(segs=3, kw=dict(mode="fused")),
}


def _tables_equal(ti, di):
    """Dense rows, heavy and light bucket tables, row top-k and search
    depth of a TorchIndex equal a JAX DeviceIndex's."""
    assert ti._device_build == di._device_build
    for name in ("n_dense", "n_light", "_bs_depth", "_lb_log2"):
        assert getattr(ti, name) == getattr(di, name), name
    rows = ti.dense_rows.shape[0]
    ref = np.asarray(di.dense_rows.astype(jnp.float32)).reshape(
        di.dense_rows.shape[0], -1)
    assert rows == ((ti.n_dense + 1 + 7) // 8) * 8
    assert np.array_equal(ti.dense_rows.float().numpy().view(np.uint32),
                          ref[:rows].view(np.uint32))
    assert not ref[rows:].any()
    for name in ("bucket_pos", "light_bucket_pos"):
        a, b = getattr(ti, name), getattr(di, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert np.array_equal(a.numpy(), np.asarray(b)), name
    assert (ti._row_topk is None) == (di._row_topk is None)
    if ti._row_topk is not None:
        for a, b in zip(ti._row_topk, di._row_topk):
            assert np.array_equal(a, np.asarray(b))


@pytest.mark.parametrize("switch", list(SWITCHES))
@pytest.mark.parametrize("config", list(CONFIGS))
def test_index_under_switch_matches_reference(segs, monkeypatch, config,
                                              switch):
    """TorchIndex under each build switch equals the JAX DeviceIndex under
    the same switch (tables and results), and its results equal the
    oracle's; 1-term head queries exercise the row top-k shortcut."""
    for env, val in SWITCHES[switch].items():
        monkeypatch.setenv(env, val)
    c = CONFIGS[config]
    cfg = _cfg(**c["kw"])
    use = segs[:c["segs"]]
    di = DeviceIndex(use, config=cfg)
    ti = TorchIndex(use, config=port_config(cfg), device="cpu")
    _tables_equal(ti, di)
    heavy = sorted({t for lex in ti.lex for t, v in lex.items() if v[2] >= 0})
    assert heavy
    queries = [[(t, 1.0)] for t in heavy[:4]] + MIXED + _random_queries(44)
    check(ti, use, queries, di)


def test_switches_build_the_same_index(segs, monkeypatch):
    """Every build path of the port gives the default path's tables bit for
    bit. The row top-k's values are equal; its slots are equal above the
    row's last value. Past a short row the device build's zero lanes carry
    real slot ids where the host path pads 2^30, and in a tie run that
    crosses lane k the host path's argpartition keeps any members of the
    run, the device build the lowest slots."""
    cfg = port_config(_cfg())
    base = TorchIndex(segs, config=cfg, device="cpu")
    for env in SWITCHES["host_build"], {
            "NEXTSEARCH_LIGHT_BUILD": "device",
            "NEXTSEARCH_ROW_TOPK_BUILD": "device"}:
        for name, val in env.items():
            monkeypatch.setenv(name, val)
        ti = TorchIndex(segs, config=cfg, device="cpu")
        assert np.array_equal(ti.dense_rows.numpy(), base.dense_rows.numpy())
        assert np.array_equal(ti.light_bucket_pos.numpy(),
                              base.light_bucket_pos.numpy())
        assert ti._bs_depth == base._bs_depth
        (v, s), (bv, bs) = ti._row_topk, base._row_topk
        assert np.array_equal(v, bv)
        above = bv > bv[:, -1:]
        assert above.sum() > bv.size // 2
        assert np.array_equal(s[above], bs[above])
        for name in env:
            monkeypatch.delenv(name)
