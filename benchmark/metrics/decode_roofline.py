"""The safe decode's share of its roofline: the compressed bytes read and
the raw blocks written, over the device time of everything launched from
``decompress_safe_batch``."""

from benchmark import layers, roofline


def read(ctx):
    return layers.roofline_pct(
        ctx, {"decompress_safe_batch"},
        lambda b: roofline.decode_bytes(b.n, b.block_bytes, b.comp_total))
