"""Tensor parallelism for serving: the tp process group and its ranks."""
