"""LZ4 HC's share of its roofline: the raw blocks read and the compressed
bytes written, over the device time of everything launched from
``compress_hc_batch``."""

from benchmark import layers, roofline


def read(ctx):
    return layers.roofline_pct(
        ctx, {"compress_hc_batch"},
        lambda b: roofline.compress_bytes(b.n, b.block_bytes, b.comp_total))
