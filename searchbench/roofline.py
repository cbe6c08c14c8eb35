"""Peaks of the card, and the bytes that a kernel's inputs need.

The peak is NVIDIA's published H100 SXM figure (3.35 TB/s of HBM3), the
one chip_smoke.py's bounds use (commit df737fb). Bytes count each input
byte read once and each output byte written once, for the batch's real
queries: padding rows that a pinned launch also moves are not counted, so
a share reads low, never high, where a launch pads.
"""

from __future__ import annotations

import re

import numpy as np

HBM_BYTES_PER_S = 3.35e12

# kernel names as the profiler reports them (csrc/heavy.cu's templates)
KERNELS = {
    "score_epilogue": re.compile(r"score_epilogue_kernel<float\b"),
}


def epilogue_bytes(n_queries: int, n_docs: int) -> float:
    """The fused mode's score epilogue over f32 scores: S read, the heavy
    product H read, S written (chip_smoke's check_epilogue), for the
    batch's queries over the corpus's documents."""
    return 12.0 * n_queries * n_docs


def dense_terms(term_df: np.ndarray, n_docs: int, device_cfg: dict) -> set:
    """The terms that the configuration's dense-row budget grants a row:
    the highest-df terms with df at least n_slots * dense_df_ratio, as
    many as dense_max_bytes holds at 4 bytes a slot (at most
    dense_max_rows), where n_slots is the doc count rounded up to 2048."""
    n_slots = -(-n_docs // 2048) * 2048
    thr = max(1, int(n_slots * float(device_cfg["dense_df_ratio"])))
    cap = min(int(device_cfg["dense_max_rows"]),
              int(device_cfg["dense_max_bytes"]) // (4 * n_slots))
    cand = np.flatnonzero(term_df >= thr)
    order = np.lexsort((-cand, -term_df[cand]))[:cap]
    return set(cand[order].tolist())


def share(bytes_per_launch: float, launches: int, seconds: float):
    """Percent of the HBM roofline: the launches' bytes over their time;
    None where the trace holds no such launch."""
    if launches <= 0 or seconds <= 0:
        return None
    return 100.0 * bytes_per_launch * launches / seconds / HBM_BYTES_PER_S


def kernel_time(reduced: dict, kernel: str):
    """(launches, seconds) of the named kernel in a reduced trace."""
    pat = KERNELS[kernel]
    n, s = 0, 0.0
    for name, cnt in reduced["kernel_count"].items():
        if pat.search(name):
            n += cnt
            s += reduced["kernel_s"][name]
    return n, s
