"""The share of the traced window of the read cells in which nothing ran
on the card, from ``torch.profiler``."""

from benchmark import layers


def read(ctx):
    return layers.idle_pct(ctx)
