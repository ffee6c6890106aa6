"""The frame body's share of its roofline: each block's payload and both
its lengths read and the body written, over the device time of everything
launched from ``frame_body_packed``."""

from benchmark import layers, roofline


def read(ctx):
    return layers.roofline_pct(
        ctx, {"frame_body_packed"},
        lambda b: roofline.pack_bytes(b.n, b.payload_total, b.body_total))
