"""kernel.gather_rows_bf16.roofline: K2's (gather_rows_kernel<float, bf16>,
the fast launch's compact bf16 heavy table) share of the HBM roofline in
the traced stretch; a launch needs its distinct dense rows read in f32 and
written in bf16 (roofline_sparse.py)."""

from searchbench import roofline_sparse
from searchbench.readers import traced_launches


def read(run):
    if run.trace is None:
        return None
    return roofline_sparse.share(traced_launches(run), run.trace, run.corpus,
                                 run.device_cfg, "gather_rows_bf16")
