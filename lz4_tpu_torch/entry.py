"""Entry point of the port: the batched safe block decoder.

Counterpart of ``__graft_entry__.py::entry``: ``entry()`` returns
``(fn, args)``, where ``fn`` decodes a batch of compressed blocks (the K1
kernel on the card) and ``args`` is such a batch, compressed on the same
device.
"""

from __future__ import annotations

import torch

from .core.constants import max_compressed_length
from .core.device import resolve_device
from .core.errors import Lz4Error
from .kernels.codec import compress_fast_batch, decompress_safe_batch
from .kernels.layout import to_device_layout

BLOCK_LEN = 1024
N_BLOCKS = 8


def example_blocks() -> list[bytes]:
    """Deterministic compressible blocks (the fallback data of
    ``__graft_entry__._example_blocks``)."""
    data = bytes((i * 7 + (i >> 3)) & 0xFF for i in range(BLOCK_LEN * N_BLOCKS))
    return [data[i * BLOCK_LEN:(i + 1) * BLOCK_LEN] for i in range(N_BLOCKS)]


def entry(device: str | torch.device = "cuda"):
    """Returns ``(fn, (comp, comp_lens))``: ``fn(comp, comp_lens)`` is the
    batched safe decode to ``(out, out_lens, err)``."""
    dev = resolve_device(device)
    src, lens = to_device_layout(example_blocks(), BLOCK_LEN, dev)
    comp, comp_lens, err = compress_fast_batch(
        src, lens, max_compressed_length(BLOCK_LEN))
    if bool(err.any()):
        raise Lz4Error("compressing the example blocks failed")

    def forward(comp, comp_lens):
        return decompress_safe_batch(comp, comp_lens, BLOCK_LEN)

    return forward, (comp, comp_lens)
