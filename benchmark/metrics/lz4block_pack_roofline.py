"""The LZ4Block stream's body: its share of its roofline, the least time
of ``lz4block_layers.pack_bytes`` (the raw blocks read once, the
compressed payloads and both lengths a block read, the stream written)
over the device time of everything launched from
``block_stream_body_packed``: the scan, K3 and the pack kernel."""

from benchmark import layers, lz4block_layers


def read(ctx):
    return layers.roofline_pct(ctx, {"block_stream_body_packed"},
                               lz4block_layers.pack_bytes)
