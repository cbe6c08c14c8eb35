"""roofline_sparse.py on a hand-worked batch: which queries and rows count,
the byte and operation counts of K2 and K1, the kernel names each share
reads, and the share itself."""

from __future__ import annotations

import numpy as np
import pytest

from searchbench import roofline, roofline_sparse as rs
from searchbench.corpus import term_name

# ten terms; 0, 1 and 2 have a dense row at n_slots 4096 (threshold 16)
DF = np.array([900, 700, 500, 10, 10, 12, 0, 3, 3, 3], np.int32)
N_DOCS = 3000  # 4096 slots
DEVICE_CFG = {"dense_df_ratio": 1 / 256, "dense_max_rows": 4096,
              "dense_max_bytes": 2 << 30}


def q(*ids):
    return [(term_name(i), 1.0) for i in ids]


# one launch's queries, as the index was handed them
LAUNCH = [
    q(0),            # one term: the shortcut may answer it, not counted
    q(0, 1),         # counted: rows 0 and 1
    q(1, 5),         # counted: row 1 again (once a launch)
    q(5, 5),         # one distinct term: not counted
    q(2, 6),         # term 6 has no posting: one known term, not counted
    q(3, 4, 7),      # counted, light terms only
    [],              # empty
]


class Corpus:
    n_docs = N_DOCS
    term_df = DF


def test_dense_rows_and_slots():
    assert roofline.dense_terms(DF, N_DOCS, DEVICE_CFG) == {0, 1, 2}
    assert rs.n_slots(N_DOCS) == 4096 and rs.n_slots(4096) == 4096


def test_counted_queries_and_rows():
    """Only queries of two or more distinct known terms count; each dense
    row counts once a launch, one-term queries' rows not at all."""
    assert rs.counted(LAUNCH, DF, {0, 1, 2}) == (3, 2)
    assert rs.counted([q(0), q(2)], DF, {0, 1, 2}) == (0, 0)
    assert rs.counted([q(2, 9), q(0, 2)], DF, {0, 1, 2}) == (2, 2)


def test_byte_and_operation_counts():
    """K2: 2 rows of 4096 slots read in f32 and written in bf16. K1: the
    2-row bf16 table read once, H (f32) and 32 sub-block maxima written
    for 3 queries; its dense product 2 * 3 * 2 * 4096 operations."""
    assert rs.gather_bytes(2, 4096) == 6 * 2 * 4096 == 49152
    assert rs.product_bytes(3, 2, 4096) == (2 * 2 * 4096 + 4 * 3 * 4096
                                            + 4 * 3 * 32) == 65920
    assert rs.product_flops(3, 2, 4096) == 2 * 3 * 2 * 4096
    assert rs.bound_s("gather_rows_bf16", 3, 2, 4096) == pytest.approx(
        49152 / 3.35e12)
    # bytes bind here; operations where U is large against H
    assert rs.bound_s("heavy_product", 3, 2, 4096) == pytest.approx(
        65920 / 3.35e12)
    flops = rs.product_flops(1024, 4096, 4096) / 989e12
    assert rs.bound_s("heavy_product", 1024, 4096, 4096) == pytest.approx(
        flops)
    assert flops > rs.product_bytes(1024, 4096, 4096) / 3.35e12


PREFIX = "void (anonymous namespace)::"
TRACE_NAMES = {
    # the fast launch: K2, then K1 (mix lists, gather, tensor-core blocks)
    "gather_rows_kernel<float, __nv_bfloat16>(int const*, float const*, "
    "__nv_bfloat16*, int, int, long long)": (2, 0.004),
    "mix_lists_kernel<true>(float const*, int, int, int, int*, int*, "
    "float*, __nv_bfloat16*, int)": (2, 0.0002),
    "heavy_gather_kernel<true, __nv_bfloat16, false, 0, false>"
    "(__nv_bfloat16 const*, Lists, Entries, Outs, int, long long, int)":
        (2, 0.006),
    "heavy_dense_tc_kernel<__nv_bfloat16, false, 0, false>"
    "(__nv_bfloat16 const*, int, __nv_bfloat16 const*, Lists, Entries, "
    "Outs, int, int, long long, int)": (2, 0.0008),
    # an exact relaunch over the f32 table, and other kernels: not counted
    "mix_lists_kernel<false>(float const*, int, int, int, int*, int*, "
    "float*, __nv_bfloat16*, int)": (1, 0.5),
    "heavy_gather_kernel<false, float, false, 0, false>(float const*, "
    "Lists, Entries, Outs, int, long long, int)": (1, 0.5),
    "heavy_dense_exact_kernel<false, 0>(float const*, float const*, Lists, "
    "Entries, Outs, int, int, long long, int)": (1, 0.5),
    "gather_rows_kernel<float, float>(int const*, float const*, float*, "
    "int, int, long long)": (1, 0.5),
    "gather_rows_unrolled_kernel(int const*, uint4 const*, uint4*, int, "
    "int, long long)": (1, 0.5),
}
REDUCED = {"kernel_count": {PREFIX + n: c for n, (c, _s) in
                            TRACE_NAMES.items()},
           "kernel_s": {PREFIX + n: s for n, (_c, s) in TRACE_NAMES.items()}}


def test_kernel_names():
    """K2 is the f32-to-bf16 row gather alone; K1 counts one launch per
    fast product and takes the time of its three kernels."""
    assert rs.kernel_time(REDUCED, "gather_rows_bf16") == (2, 0.004)
    n, s = rs.kernel_time(REDUCED, "heavy_product")
    assert n == 2 and s == pytest.approx(0.0002 + 0.006 + 0.0008)


def test_share_of_two_launches():
    """The mean bound of the launches, times the kernel's launches, over
    its time; None without launches or without the kernel."""
    launches = [LAUNCH, [q(0, 1, 2), q(2)]]  # (3, 2) and (1, 3)
    k2 = rs.share(launches, REDUCED, Corpus, DEVICE_CFG, "gather_rows_bf16")
    mean = (rs.gather_bytes(2, 4096) + rs.gather_bytes(3, 4096)) / 2
    assert k2 == pytest.approx(100 * mean / 3.35e12 * 2 / 0.004)
    k1 = rs.share(launches, REDUCED, Corpus, DEVICE_CFG, "heavy_product")
    mean = (rs.bound_s("heavy_product", 3, 2, 4096)
            + rs.bound_s("heavy_product", 1, 3, 4096)) / 2
    assert k1 == pytest.approx(100 * mean * 2 / 0.007)
    assert rs.share([], REDUCED, Corpus, DEVICE_CFG, "heavy_product") is None
    empty = {"kernel_count": {}, "kernel_s": {}}
    assert rs.share(launches, empty, Corpus, DEVICE_CFG,
                    "gather_rows_bf16") is None
