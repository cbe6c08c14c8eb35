"""The port's probe kernels and scripts against the JAX package's on the CPU:
P1-P5 (ops/probe_kernels.py) against benchmarks/mosaic_probe.py's kernel
bodies, P6 (heavy_kernels.heavy_fused_variant) against
benchmarks/probe_fusedmm.py's fused_variant, both run in Pallas TPU
interpret mode, and the probe scripts under nextsearch_tpu_torch/benchmarks/
(profile_sparse's variants against the original's on a bf16-rows index,
kernel_probe, and the micro-probes' rows at small shapes).

Tolerances: P1 within 2 * 512 * 2^-24 relative (the bound on two orders
of a 512-term positive f32 sum; measured 1.4e-6 here);
P3 within 1e-6 (a scatter-add; one cell holds four entries); P2, P4, P5
bit for bit; P6 as K6 (tests/test_torch_heavy2d.py): H and smax within
3e-7 relative, cnt exact, a bf16 H equal to the nearest bf16 of the port's
own f32 H; profile_sparse's outputs bit for bit.
"""

import contextlib
import importlib.util
import io
from pathlib import Path

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nextsearch_tpu_torch.ops import heavy_kernels as hk
from nextsearch_tpu_torch.ops import probe_kernels as pk
from test_torch_bf16rows import _bf16_arrays, bf16_index
from test_torch_sparse_ops import _queries, _t

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


def _load_jax_probe(name: str, tmp):
    """Import benchmarks/<name>.py with its prints silenced, inside TPU
    interpret mode (mosaic_probe runs its probes as it is imported). Its
    compile-cache setup is pointed at `tmp` and undone afterwards."""
    saved = (jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp))
        spec = importlib.util.spec_from_file_location(
            f"jax_{name}", REPO / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        with pltpu.force_tpu_interpret_mode(), \
                contextlib.redirect_stdout(io.StringIO()):
            spec.loader.exec_module(mod)
    jax.config.update("jax_compilation_cache_dir", saved[0])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[1])
    return mod


@pytest.fixture(scope="module")
def mosaic(tmp_path_factory):
    return _load_jax_probe("mosaic_probe", tmp_path_factory.mktemp("jc"))


@pytest.fixture(scope="module")
def fusedmm(tmp_path_factory):
    return _load_jax_probe("probe_fusedmm", tmp_path_factory.mktemp("jc"))


def _interpret(kernel, out_shape, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(pl.pallas_call(kernel, out_shape=out_shape, **kw)(*args))


# ------------------------------------------------------------ P1-P5


def test_p1_nt_dot_matches_mosaic_body(mosaic):
    r = np.random.default_rng(1)
    a = r.random((mosaic.Q, mosaic.W), dtype=np.float32)
    b = r.random((mosaic.TILE, mosaic.W), dtype=np.float32)
    ref = _interpret(mosaic.k1, jax.ShapeDtypeStruct((mosaic.Q, mosaic.TILE),
                                                     jnp.float32),
                     jnp.asarray(a), jnp.asarray(b))
    got = pk.nt_dot(_t(a), _t(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2 * mosaic.W * 2.0 ** -24, atol=0)


def test_p2_row_copy_matches_mosaic_body(mosaic):
    e = np.random.default_rng(2).random((16, 512), dtype=np.float32)
    for off in (3, 15):
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(pl.pallas_call(
                mosaic.k2,
                grid_spec=pltpu.PrefetchScalarGridSpec(
                    num_scalar_prefetch=1, grid=(1,),
                    in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
                    out_specs=pl.BlockSpec((8, 512), lambda i, o: (0, 0)),
                    scratch_shapes=[pltpu.VMEM((1, 512), jnp.float32),
                                    pltpu.SemaphoreType.DMA],
                ),
                out_shape=jax.ShapeDtypeStruct((8, 512), jnp.float32),
            )(jnp.asarray([off], jnp.int32), jnp.asarray(e)))
        got = pk.row_copy(_t(e), torch.tensor([off], dtype=torch.int32), 8)
        assert np.array_equal(got.numpy(), ref)


def test_p3_window_op_matches_mosaic_body(mosaic):
    Q, W, TILE = mosaic.Q, mosaic.W, mosaic.TILE
    r = np.random.default_rng(3)
    wq = r.integers(0, Q, W).astype(np.int32)
    wd = r.integers(0, TILE, W).astype(np.int32)
    wq[:4], wd[:4] = 5, 9  # one cell with four entries
    wv = r.uniform(0.5, 1.5, W).astype(np.float32)
    ref = _interpret(mosaic.k3, jax.ShapeDtypeStruct((Q, TILE), jnp.float32),
                     jnp.asarray(wq[None]), jnp.asarray(wv[None]),
                     jnp.asarray(wd[None]))
    got = pk.window_op(_t(wq), _t(wv), _t(wd), q=Q, tile=TILE).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    assert (ref > 0).sum() > 400


def test_p4_p5_reshape_and_transpose_match_mosaic_bodies(mosaic):
    Q = mosaic.Q
    r = np.random.default_rng(4)
    a = r.random((4, 128, Q), dtype=np.float32)
    ref4 = _interpret(mosaic.k4, jax.ShapeDtypeStruct((512, Q), jnp.float32),
                      jnp.asarray(a))
    assert np.array_equal(pk.reshape_copy(_t(a), (512, Q)).numpy(), ref4)
    t = r.random((1, 128), dtype=np.float32)
    ref5 = _interpret(mosaic.k5, jax.ShapeDtypeStruct((128, 1), jnp.float32),
                      jnp.asarray(t))
    assert np.array_equal(pk.transpose(_t(t)).numpy(), ref5)


def test_probe_wrappers_reject_bad_arguments():
    with pytest.raises(ValueError):
        pk.nt_dot(torch.ones(4, 8), torch.ones(5, 7))
    with pytest.raises(ValueError):
        pk.window_op(torch.zeros(2000, dtype=torch.int32), torch.ones(2000),
                     torch.zeros(2000, dtype=torch.int32), q=4, tile=8)
    with pytest.raises(ValueError):
        pk.reshape_copy(torch.ones(4, 4), (3, 5))
    with pytest.raises(TypeError):
        pk.transpose(torch.ones(4, 4, dtype=torch.float64))


def test_kernel_probe_script_passes_on_plain_versions():
    from nextsearch_tpu_torch.benchmarks import kernel_probe

    pk.reset_launch_counts()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = kernel_probe.run(CPU)
    names = kernel_probe.calls(kernel_probe.inputs(CPU))
    assert result == {name: True for name in names} and len(names) == 6
    assert out.getvalue().count("PASS") == 6 and "SUMMARY" in out.getvalue()
    assert pk.nt_dot.launches == 0  # CPU tensors launch nothing


def test_chip_smoke_probe_bounds_count_outputs():
    """chip_smoke's P1-P5 bounds count each input read once and each output
    written once: inputs (one row of e for P2) plus the probe's output."""
    import chip_smoke
    from nextsearch_tpu_torch.benchmarks import kernel_probe

    args = kernel_probe.inputs(CPU)
    lib = chip_smoke.probe_library(args)
    nb = chip_smoke.nbytes
    e, off = args["row_copy"]
    read = {name: nb(*ts) for name, ts in args.items()}
    read["row_copy"] = e.shape[1] * 4 + nb(off)
    calls = kernel_probe.calls(args)
    assert set(lib) == set(calls)
    for name, (_label, kern, _plain, _tol) in calls.items():
        out = kern()
        assert lib[name][1] == read[name] + nb(out), name
    assert lib["window_op"][1] == 3 * 512 * 4 + 128 * 1024 * 4
    assert lib["nt_dot"][2] == 2.0 * 128 * 1024 * 512


# ------------------------------------------------------------ P6


@pytest.mark.parametrize("variant", [
    {}, dict(epilogue=False), dict(smax_store=False), dict(store_h=False),
    dict(h_dtype="bf16"),
], ids=["full", "no_epilogue", "no_smax_store", "no_store_h", "bf16_h"])
def test_p6_heavy_fused_variant_matches_fused_variant(fusedmm, variant):
    """Over a bf16 table (the probe's), where the TPU probe's one-pass dot
    and the port's rounded operands agree: each variant's outputs in K6's
    layouts (the probe's smax [16, tiles_pad, Q] regrouped to [sub_pad,
    Q])."""
    r = np.random.default_rng(5)
    Q, ND, n_slots = 8, 16, 3 * 2048
    mix = np.where(r.random((Q, ND)) < 0.4, r.random((Q, ND)), 0).astype(np.float32)
    dense = r.random((ND, n_slots), dtype=np.float32)
    dense[:, 5000:] = 0.0
    kw = dict(variant)
    jkw = dict(variant)
    if kw.get("h_dtype"):
        kw["h_dtype"], jkw["h_dtype"] = torch.bfloat16, jnp.bfloat16
    d16 = jnp.asarray(dense).astype(jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        h_r, smax3, cnt_r = (np.asarray(x) for x in fusedmm.fused_variant(
            jnp.asarray(mix), d16, **jkw))
    smax_r = smax3.transpose(1, 0, 2).reshape(-1, Q)
    t16 = _t(np.asarray(d16.astype(jnp.float32))).to(torch.bfloat16)
    h, smax, cnt = hk.heavy_fused_variant(_t(mix), t16, **kw)
    assert smax.shape == smax_r.shape and cnt.shape == cnt_r.shape
    assert np.array_equal(cnt.numpy(), cnt_r)
    fin = np.isfinite(smax_r)
    assert np.array_equal(np.isfinite(smax.numpy()), fin)
    np.testing.assert_allclose(smax.numpy()[fin], smax_r[fin], rtol=3e-7, atol=0)
    if kw.get("h_dtype") == torch.bfloat16:
        h32 = hk.heavy_fused_variant(_t(mix), t16)[0]
        assert torch.equal(h.view(torch.int16), h32.to(torch.bfloat16).view(torch.int16))
        np.testing.assert_allclose(h.float().numpy(),
                                   h_r.astype(np.float32), rtol=2.0 ** -8, atol=0)
    else:
        np.testing.assert_allclose(h.numpy(), h_r, rtol=3e-7, atol=0)
    if variant == dict(smax_store=False):
        assert fin.sum() == 3 * 16 * Q and np.all(cnt_r == 0)


# ------------------------------------------------------------ probe scripts


@pytest.fixture(scope="module")
def jax_profile_sparse(tmp_path_factory):
    return _load_jax_probe("profile_sparse", tmp_path_factory.mktemp("jc"))


def test_profile_sparse_variants_match_original(jax_profile_sparse):
    """Every variant of the ported profile_sparse (K6 exact over the full
    bf16 table, v2 rescore) equals the original's variant_kernel
    (use_pallas=False) on a bf16-rows index, bit for bit."""
    from nextsearch_tpu_torch.benchmarks import profile_sparse as ps

    di = bf16_index()
    plan, _u = di.plan_sparse(_queries(61))
    a = _bf16_arrays(di)

    class _Index:  # the fields chunk_budget reads
        config = di.config

    C = ps.chunk_budget(_Index, [plan])
    st = dict(n_slots=di.n_slots, K=ps.K, K2=ps.K2, C=C,
              block=di.config.device.posting_block, bs_steps=di._bs_depth,
              nd=di.n_dense, nl=di.n_light)
    assert di._lb_log2 == ps.LIGHT_BUCKET_LOG2
    for name, kw in ps.VARIANTS.items():
        ref = np.asarray(jax_profile_sparse.variant_kernel(
            jnp.asarray(a["post_doc"]), jnp.asarray(a["post_score"]),
            a["dense3"], jnp.asarray(a["bp"]), jnp.asarray(a["lbp"]),
            jnp.asarray(plan), U=0, use_pallas=False, **st, **kw))
        got = ps.variant_kernel(
            _t(a["post_doc"]), _t(a["post_score"]), a["dense2"], _t(a["bp"]),
            _t(a["lbp"]), _t(plan), **st, **kw).numpy()
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32)), name
        if name == "full":
            assert (ref[:, 2 * ps.K] > 0).sum() > 15


def test_micro_probe_rows_run_on_small_shapes():
    """The micro-probes' rows at small shapes on the CPU (plain versions):
    every row runs, and the parts that compute a result agree with the
    functions they take apart."""
    from nextsearch_tpu_torch.benchmarks import probe_bf16h, probe_candsel
    from nextsearch_tpu_torch.benchmarks import probe_fusedmm
    from nextsearch_tpu_torch.ops.bm25_sparse import heavy_candidates

    mix, dense = probe_fusedmm.operands(CPU, q=8, uc=16, n_slots=4096)
    rows = probe_fusedmm.calls(mix, dense)
    assert list(rows)[2:7] == list(probe_fusedmm.VARIANTS)
    outs = {label: fn() for label, fn in rows.items()}
    assert torch.equal(outs["variant full (parity check)"][0],
                       outs["plain bare dot -> f32 H"])
    ops = probe_bf16h.operands(CPU, q=16, u=8, s=4096, n=2048)
    for fn in probe_bf16h.calls(ops).values():
        fn()
    c = probe_candsel.operands(CPU, q=8, n_slots=16384, uc=16)
    for fn in probe_candsel.calls(c).values():
        fn()
    n_sub = 16384 // 128
    vals, docs = heavy_candidates(c["H"], c["smax"], 32, 8, 16384)
    tidx = probe_candsel.topk_smax(c["smax"], n_sub)
    flat = probe_candsel.gather_tiles(c["H"], tidx).reshape(8, -1)
    assert torch.equal(probe_candsel.topk_flat(flat)[0], vals)
    hv, hd = probe_candsel.hier(c["H"], c["smax"], c["smax32"], n_sub)
    assert hv.shape == hd.shape == (8, 32)
