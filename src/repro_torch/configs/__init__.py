"""Benchmark configurations (a copy of the JAX package's Table-1 configs)."""
