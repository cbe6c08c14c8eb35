"""The sparse launch's heavy kernels against the card's roofline: K2 (the
compact bf16 heavy table) and K1 (the heavy product of the fast launch).

The counts read the work that a launch's queries need, whatever implements
it: they come from the queries the index was handed (readers.
traced_launches) and the corpus, with the dense rows that the
configuration's budget grants (roofline.dense_terms), and never from the
program's own counters. They read low, never high: only the queries with
at least two distinct known terms count (the 1-term shortcut may answer
the others on the host), the batch's padding rows and the padded compact
table are left out, and each dense row counts once a launch.

  K2   the launch's distinct dense rows read as f32 and written as bf16:
       6 bytes a row and slot
  K1   the larger of two bounds: its bytes (the compact bf16 table read
       once, H written in f32 and the per-128-slot maxima, for the counted
       queries) over the HBM peak, and its operations (2 * Q * U * n_slots,
       a dense product over the compact table) over the card's published
       bf16 dense peak

The peaks are NVIDIA's published H100 SXM figures: 3.35 TB/s of HBM3
(roofline.HBM_BYTES_PER_S) and 989 TFLOP/s in bf16 without sparsity.
"""

from __future__ import annotations

import re

from . import roofline

BF16_FLOP_PER_S = 989e12
CSUB = 128  # slots per selection sub-block: one f32 maximum per query each

# kernel names as the profiler reports them (csrc/heavy.cu's templates):
# `count` matches one kernel a launch, `time` every kernel of the stage.
# K1 of the fast launch is the bf16 mix lists, the gather product over the
# bf16 compact table, and the tensor-core kernel that takes the 64-query
# blocks holding a longer list (the exact relaunch's f32 kernels are not
# the fast launch's, and are not counted).
KERNELS = {
    "gather_rows_bf16": {
        "count": re.compile(r"gather_rows_kernel<float, ?__nv_bfloat16>"),
        "time": re.compile(r"gather_rows_kernel<float, ?__nv_bfloat16>"),
    },
    "heavy_product": {
        "count": re.compile(r"heavy_gather_kernel<true, ?__nv_bfloat16\b"),
        "time": re.compile(r"heavy_gather_kernel<true, ?__nv_bfloat16\b"
                           r"|heavy_dense_tc_kernel<__nv_bfloat16\b"
                           r"|mix_lists_kernel<true>"),
    },
}


def n_slots(n_docs: int) -> int:
    """The index's doc slots: the doc count rounded up to 2048."""
    return -(-int(n_docs) // 2048) * 2048


def term_id(term: str) -> int:
    """The id of a term as corpus.term_name writes it ("t0000123")."""
    return int(term[1:])


def counted(queries, term_df, dense: set):
    """(queries counted, distinct dense rows among their terms): the
    queries with at least two distinct terms that have a posting."""
    q, rows = 0, set()
    for terms in queries:
        ids = {term_id(t) for t, _w in terms}
        ids = {i for i in ids if 0 <= i < term_df.shape[0] and term_df[i] > 0}
        if len(ids) < 2:
            continue
        q += 1
        rows |= ids & dense
    return q, len(rows)


def gather_bytes(u: int, slots: int) -> float:
    """K2: u dense rows read as f32 and written as bf16."""
    return 6.0 * u * slots


def product_bytes(q: int, u: int, slots: int) -> float:
    """K1: the bf16 compact table of u rows read once; H (f32) and the
    per-sub-block maxima of q queries written."""
    return 2.0 * u * slots + 4.0 * q * slots + 4.0 * q * (slots // CSUB)


def product_flops(q: int, u: int, slots: int) -> float:
    """K1 as a dense product of q queries over u rows."""
    return 2.0 * q * u * slots


def bound_s(kernel: str, q: int, u: int, slots: int) -> float:
    """The least time the card could take for a launch's kernel."""
    if kernel == "gather_rows_bf16":
        return gather_bytes(u, slots) / roofline.HBM_BYTES_PER_S
    return max(product_bytes(q, u, slots) / roofline.HBM_BYTES_PER_S,
               product_flops(q, u, slots) / BF16_FLOP_PER_S)


def kernel_time(reduced: dict, kernel: str):
    """(launches, seconds) of the kernel in a reduced trace: the launches
    of its `count` kernel, the time of all its `time` kernels."""
    pats = KERNELS[kernel]
    n, s = 0, 0.0
    for name, cnt in reduced["kernel_count"].items():
        if pats["count"].search(name):
            n += cnt
        if pats["time"].search(name):
            s += reduced["kernel_s"][name]
    return n, s


def share(launches, reduced: dict, corpus, device_cfg: dict, kernel: str):
    """Percent of the roofline: the mean bound of the launches' queries
    times the kernel's launches in the trace, over their time; None where
    the trace holds none."""
    if not launches:
        return None
    n, secs = kernel_time(reduced, kernel)
    if n <= 0 or secs <= 0:
        return None
    df = corpus.term_df
    dense = roofline.dense_terms(df, corpus.n_docs, device_cfg)
    slots = n_slots(corpus.n_docs)
    mean = sum(bound_s(kernel, *counted(q, df, dense), slots)
               for q in launches) / len(launches)
    return 100.0 * mean * n / secs
