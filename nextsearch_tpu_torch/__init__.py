"""PyTorch + CUDA port of nextsearch_tpu: everything the JAX package does,
on one NVIDIA H100 or a mesh of them.

The four device modes (fused, the default; exact; fast; sparse) on one
device (index/segment.TorchIndex, with the reference's build switches) or
sharded over a (dp, seg) mesh (parallel/), the hand-written CUDA kernels
for the TPU kernels (csrc/heavy.cu, ops/), autocomplete, semantic
expansion and the hybrid rerank (models/), the Engine and HTTP server with
the NEXTSEARCH_PROFILE_DIR trace, the CLI tools and the benchmark scripts.

Imports torch, never jax, and nothing of the JAX package: the host modules
it shares with nextsearch_tpu (config, index builder/oracle/segmentio/
artifacts/metadata, the numpy planner, api front, engine, utils, native,
tools) are its own copies under the same relative paths.
"""
