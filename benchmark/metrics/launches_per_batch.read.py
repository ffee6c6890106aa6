"""Kernel launches of the program a read batch, from its own count
(``kernels/build.py::launch_counts``)."""

from benchmark import layers


def read(ctx):
    return layers.launches_per_batch(ctx)
