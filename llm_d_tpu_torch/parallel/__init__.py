"""Parallel layer of the port: expert-parallel load balancing on one
device (``eplb``)."""
