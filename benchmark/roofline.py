"""The roofline arithmetic: the least time the card could take for an
operation's bytes.

Copied for the benchmark from ``chip_smoke.py``'s bound: each input byte
read once and each output byte written once, over the HBM bandwidth of one
NVIDIA H100 SXM (its data sheet, at its full power limit of 700 W; a card
set lower runs slower, so a share is stated with the card's limit). The
bytes are the cell's own: the raw bytes, the compressed lengths the batch
produced, and the body, so a share reads the same work whatever kernels
implement it. LZ4 and XXH32 do no floating-point work; the bound is bytes.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def least_seconds(nbytes: int) -> float:
    """Seconds the card needs at least to move ``nbytes`` bytes."""
    return nbytes / HBM_BYTES_PER_S


def compress_bytes(n: int, block_bytes: int, comp_total: int) -> int:
    """A batch compressed: the raw blocks read, the compressed bytes and a
    length and an error code a block written."""
    return n * block_bytes + comp_total + 8 * n


def decode_bytes(n: int, block_bytes: int, comp_total: int) -> int:
    """A batch decoded: the compressed bytes and their lengths read, the
    raw blocks and a length and an error code a block written."""
    return comp_total + 4 * n + n * block_bytes + 8 * n


def pack_bytes(n: int, payload_total: int, body_total: int) -> int:
    """A batch packed: each block's payload (its compressed bytes, or its
    raw bytes where it is stored raw) and both its lengths read; the body
    written."""
    return payload_total + 8 * n + body_total


def share_pct(least_s: float, device_s: float) -> float | None:
    """The least time as a share of the device time, in %; None where no
    device time was read."""
    if device_s <= 0:
        return None
    return 100.0 * least_s / device_s
