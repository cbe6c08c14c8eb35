"""kernel.heavy_product.roofline: K1's (the fast launch's mix_lists, then
heavy_gather_kernel over the bf16 compact table, with the tensor-core
kernel's long-list blocks) share of the larger of its bounds in the traced
stretch: the compact table read once and H written, at the HBM peak, or
2 * Q * U * n_slots operations at the bf16 peak (roofline_sparse.py)."""

from searchbench import roofline_sparse
from searchbench.readers import traced_launches


def read(run):
    if run.trace is None:
        return None
    return roofline_sparse.share(traced_launches(run), run.trace, run.corpus,
                                 run.device_cfg, "heavy_product")
