"""PyTorch + CUDA port of nextsearch_tpu (sparse BM25 serving path).

Imports torch and never jax; the host-only numpy modules of nextsearch_tpu
(config, index builder/oracle/segmentio/artifacts/metadata, api front,
utils) are shared with the reference package.
"""
