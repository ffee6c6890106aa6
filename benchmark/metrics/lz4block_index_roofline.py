"""The walk of the LZ4Block stream's headers: its share of its roofline,
the least time of ``lz4block_layers.index_bytes`` (21 bytes a record read,
its index row written) over the device time of everything launched from
``block_stream_index``."""

from benchmark import layers, lz4block_layers


def read(ctx):
    return layers.roofline_pct(ctx, {"block_stream_index"},
                               lz4block_layers.index_bytes)
