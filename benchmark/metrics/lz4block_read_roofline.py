"""The LZ4Block stream's blocks decoded and checked: their share of their
roofline, the least time of ``lz4block_layers.read_bytes`` (every payload
read, the raw blocks written, a length and a code a record) over the
device time of everything launched from ``decompress_block_stream_batch``:
the zero fill, the decode, K3 and the verdict."""

from benchmark import layers, lz4block_layers


def read(ctx):
    return layers.roofline_pct(ctx, {"decompress_block_stream_batch"},
                               lz4block_layers.read_bytes)
