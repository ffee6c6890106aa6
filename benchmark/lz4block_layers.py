"""What the ``lz4block_*`` metrics read of a ring slot's stream, and the
least bytes of each layer's work (the arithmetic of ``roofline.py``, which
counts the frame's): the raw blocks, the payloads, the records and the
stream."""

from __future__ import annotations

import dataclasses

from .layers import SlotBytes

INDEX_RECORD = 24       # the index's six int32 fields of a record
LENGTHS = 8             # a block's two lengths, or a length and a code


@dataclasses.dataclass
class StreamBytes(SlotBytes):
    """A slot's batch as one LZ4Block stream: ``comp_total`` the
    compressor's bytes, ``payload_total`` every payload's, ``lz4_total``
    the payloads stored compressed, ``body_total`` the stream's, and
    ``records`` its blocks and its end block."""
    lz4_total: int = 0
    records: int = 0


def pack_bytes(b: StreamBytes) -> int:
    """The stream written: the raw blocks read once (the checks hash them,
    the raw payloads are copied from them), the compressed payloads read,
    both lengths a block read and the stream written."""
    return b.n * b.block_bytes + b.lz4_total + LENGTHS * b.n + b.body_total


def index_bytes(b: StreamBytes) -> int:
    """The headers walked: 21 bytes a record read, its index row
    written."""
    return (21 + INDEX_RECORD) * b.records


def read_bytes(b: StreamBytes) -> int:
    """The blocks read: every payload read, the raw blocks written, a
    length and a code a record."""
    return b.payload_total + b.n * b.block_bytes + LENGTHS * b.records
