"""Verification and recovery for sharded runs.

Counterpart of ``lz4_tpu/dist/recovery.py``. Blocks are independent, so a
block whose compressed output fails verification can be compressed again
on its own: a fault costs one block's rerun, not the job.
:func:`compress_blocks_verified` compresses a batch through an engine,
verifies every block by decoding it on the engine's device (one K1 batch
on the card) and comparing the bytes, and compresses each failed block
again through the ``cuda`` tier's fast compressor on that device.
"""

from __future__ import annotations

from ..api.factory import Lz4Factory
from ..core.errors import Lz4Error
from ..kernels.codec import decompress_safe_batch
from ..kernels.layout import from_device_layout, to_device_layout


class BlockVerificationError(Lz4Error):
    def __init__(self, indices):
        super().__init__(f"blocks failed verification after retry: {indices}")
        self.indices = indices


def _failed_blocks(blocks, compressed, indices, device) -> list[int]:
    """Those of ``indices`` whose compressed block does not decode to its
    raw block, decoded in one batch on ``device``."""
    if not indices:
        return []
    comp, comp_lens = to_device_layout([compressed[i] for i in indices],
                                       device=device)
    out, out_lens, err = decompress_safe_batch(
        comp, comp_lens, max(len(blocks[i]) for i in indices))
    decoded = from_device_layout(out, out_lens)
    codes = err.tolist()
    return [i for k, i in enumerate(indices)
            if codes[k] or decoded[k] != bytes(blocks[i])]


def compress_blocks_verified(blocks, engine=None, max_retries: int = 1):
    """Compress ``blocks`` through ``engine`` (default: ``fastest`` on the
    card), verify each, and compress a failed block again, alone, up to
    ``max_retries`` times.

    Returns ``(compressed: list[bytes], retried: list[int])``; raises
    :class:`BlockVerificationError` naming the blocks still failing.
    """
    from ..streams.pipeline import get_engine

    engine = engine or get_engine("fastest")
    compressed = list(engine.compress_batch(blocks))
    failed = _failed_blocks(blocks, compressed, list(range(len(blocks))),
                            engine.device)
    retried = list(failed)
    fast = Lz4Factory.cuda_instance(engine.device).fast_compressor()
    for _ in range(max_retries):
        if not failed:
            break
        for i in failed:
            compressed[i] = fast.compress_alloc(blocks[i])
        failed = _failed_blocks(blocks, compressed, failed, engine.device)
    if failed:
        raise BlockVerificationError(failed)
    return compressed, retried
