"""The benchmark of nextsearch_tpu_torch: one cell of BENCHMARK.json a run,
on the served path (python3 -m searchbench.run; see README.md)."""
