"""kernel.score_epilogue.roofline: score_epilogue_kernel's share of the HBM
roofline in the traced stretch; each launch needs its queries' f32 scores
read, the heavy product read and the scores written (roofline.py)."""

from searchbench import roofline
from searchbench.readers import kernel_share


def read(run):
    n_docs = run.corpus.n_docs
    return kernel_share(run, "score_epilogue",
                        lambda q: roofline.epilogue_bytes(len(q), n_docs))
