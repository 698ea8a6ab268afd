"""Benchmarks over the port (counterparts of `benchmarks/`)."""
