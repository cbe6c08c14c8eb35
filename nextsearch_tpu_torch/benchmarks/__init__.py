"""Probe and profiling scripts of the torch port (run on a CUDA card)."""
