"""Example programs over the port's workloads (counterparts of `examples/`)."""
