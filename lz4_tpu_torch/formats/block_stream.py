"""The LZ4Block stream format (lz4-java's ``LZ4BlockOutputStream``, which
Spark's ``lz4`` I/O codec and Java services wrapping a stream in one
write; Kafka writes LZ4 frames instead), on the card.

Counterpart of ``lz4_tpu/formats/block_stream.py`` with its names,
contracts and messages (``LZ4BlockOutputStream.java:39-69,189-266``,
``LZ4BlockInputStream.java:150-260``)::

    stream = block* end_block
    block  = magic("LZ4Block") token(1) compressed_len(4 LE)
             original_len(4 LE) checksum(4 LE) payload
    token  = method | level, method in {0x10 raw, 0x20 LZ4},
             level = ceil(log2(block_size)) - 10
    end    = token(RAW|level) with zero lengths and zero checksum

The default checksum is XXH32 with seed 0x9747B28C masked to 28 bits (the
reference's ``Checksum`` adapter, StreamingXXHash32.java:101-107), which
K3 computes with that seed. The stream classes go a block at a time (K2,
K1's fast contract, K3). :func:`compress_block_stream` and
:func:`decompress_block_stream` take a batch at a time on the card path of
``kernels/block_stream.py``, with the same bytes and errors as the
classes: a batch of up to 64 MiB is one K2 launch, one K3 and one pack
launch and one download; a window of up to 64 MiB of the stream is one
upload, its headers walked on the card, and its records decoded, checked
and downloaded in batches of up to 64 MiB of output.
"""

from __future__ import annotations

import io

import torch

from ..api import cuda_instances
from ..api.factory import Lz4Factory, XXHashFactory
from ..core.constants import U32
from ..core.device import resolve_device
from ..core.errors import Lz4Error, Lz4FrameError
from ..kernels import block_stream as bs
from ..kernels.block_stream import (
    COMPRESSION_LEVEL_BASE, COMPRESSION_METHOD_LZ4, COMPRESSION_METHOD_RAW,
    DEFAULT_SEED, HEADER_LENGTH, MAGIC, block_header as _block_header,
    compression_level as _compression_level)
from ..kernels.layout import DOWN, from_device_layout, staging, upload_bytes

MAGIC_LENGTH = len(MAGIC)
_BATCH_BYTES = 64 << 20     # the one-shot functions' batch and window
_WINDOW_RECORDS = 1 << 14   # the records one walk of a window lists
_FAULTS = {bs.MALFORMED: (Lz4Error, "Malformed input"),
           bs.CORRUPTED: (Lz4FrameError, "Stream is corrupted"),
           bs.PREMATURE: (Lz4FrameError, "Stream ended prematurely")}


def default_checksum(device: str | torch.device = "cuda"):
    """The reference's default: XXH32 with seed 0x9747B28C through the
    28-bit adapter, on K3."""
    xxh = XXHashFactory.cuda_instance(device).hash32()

    def check(data, off, length) -> int:
        return xxh.hash(data, off, length, DEFAULT_SEED) & bs.CHECK_MASK

    return check


class Lz4BlockOutputStream(io.RawIOBase):
    """File-like LZ4Block writer on ``device``, a block at a time."""

    def __init__(self, out, block_size: int = 1 << 16, compressor=None,
                 checksum=None, sync_flush: bool = False,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self._out = out
        self._block_size = block_size
        self._level = _compression_level(block_size)
        self._compressor = (compressor or Lz4Factory.cuda_instance(device)
                            .fast_compressor())
        self._checksum = checksum or default_checksum(device)
        self._sync_flush = sync_flush
        self._buffer = bytearray()
        self._compressed = bytearray(
            self._compressor.max_compressed_length(block_size))
        self._finished = False

    def writable(self) -> bool:
        return True

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("This stream is already closed")
        data = memoryview(data).cast("B")
        written = len(data)
        while len(data) > 0:
            take = min(self._block_size - len(self._buffer), len(data))
            self._buffer += data[:take]
            data = data[take:]
            if len(self._buffer) == self._block_size:
                self._flush_buffered_data()
        return written

    def _flush_buffered_data(self) -> None:
        if not self._buffer:
            return
        o = len(self._buffer)
        check = self._checksum(self._buffer, 0, o) & U32
        compressed_len = self._compressor.compress(
            self._buffer, 0, o, self._compressed, 0, len(self._compressed))
        if compressed_len >= o:
            method, compressed_len = COMPRESSION_METHOD_RAW, o
            payload = bytes(self._buffer)
        else:
            method = COMPRESSION_METHOD_LZ4
            payload = bytes(self._compressed[:compressed_len])
        self._out.write(_block_header(method, self._level, compressed_len, o,
                                      check) + payload)
        self._buffer.clear()

    def flush(self) -> None:
        if not self._finished and self._sync_flush:
            self._flush_buffered_data()
        if hasattr(self._out, "flush"):
            self._out.flush()

    def finish(self) -> None:
        """Write the data left and the empty-block end marker
        (LZ4BlockOutputStream.java:255-266)."""
        if self._finished:
            return
        self._flush_buffered_data()
        self._out.write(_block_header(COMPRESSION_METHOD_RAW, self._level,
                                      0, 0, 0))
        if hasattr(self._out, "flush"):
            self._out.flush()
        self._finished = True

    def close(self) -> None:
        if not self.closed:
            self.finish()
            super().close()


def _parse_header(header: bytes):
    """(method, level, compressed_len, original_len, check) of a block
    header, with the reader's checks (``kernels/block_stream.py::
    parse_header``), the compressed length against the bound of the block
    size before anything of the payload is read."""
    code, compressed_len, original_len, method, check = bs.parse_header(
        header, 0, HEADER_LENGTH)
    if code != bs.OK:
        raise Lz4FrameError("Stream is corrupted")
    level = COMPRESSION_LEVEL_BASE + (header[MAGIC_LENGTH] & 0x0F)
    return method, level, compressed_len, original_len, check


class Lz4BlockInputStream(io.RawIOBase):
    """File-like LZ4Block reader on ``device``, a block at a time (K1's
    fast contract, the bytes read held to the compressed length).

    ``stop_on_empty_block=False`` reads across concatenated streams
    (LZ4BlockInputStream.java:117-119,223-232).
    """

    def __init__(self, inp, decompressor=None, checksum=None,
                 stop_on_empty_block: bool = True,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self._in = inp
        self._decompressor = (decompressor or Lz4Factory.cuda_instance(device)
                              .fast_decompressor())
        self._checksum = checksum or default_checksum(device)
        self._stop_on_empty_block = stop_on_empty_block
        self._buffer = b""
        self._pos = 0
        self._finished = False

    def readable(self) -> bool:
        return True

    def _try_read_fully(self, n: int):
        data = b""
        while len(data) < n:
            chunk = self._in.read(n - len(data))
            if not chunk:
                if not data:
                    return None
                raise Lz4FrameError("Stream ended prematurely")
            data += chunk
        return data

    def _refill(self) -> None:
        while True:
            header = self._try_read_fully(HEADER_LENGTH)
            if header is None:
                if not self._stop_on_empty_block:
                    self._finished = True
                    return
                raise Lz4FrameError("Stream ended prematurely")
            method, _, compressed_len, original_len, check = \
                _parse_header(header)
            if original_len:
                break
            if self._stop_on_empty_block:
                self._finished = True
                return
            # a concatenated stream: the next block
        payload = self._try_read_fully(compressed_len)
        if payload is None:
            raise Lz4FrameError("Stream ended prematurely")
        if method == COMPRESSION_METHOD_RAW:
            raw = payload
        else:
            dest = bytearray(original_len)
            n_read = self._decompressor.decompress(payload, 0, dest, 0,
                                                   original_len)
            if n_read != compressed_len:
                raise Lz4FrameError("Stream is corrupted")
            raw = bytes(dest)
        if (self._checksum(raw, 0, original_len) & U32) != check:
            raise Lz4FrameError("Stream is corrupted")
        self._buffer = raw
        self._pos = 0

    def _fill(self) -> bool:
        while self._pos >= len(self._buffer):
            if self._finished:
                return False
            self._buffer = b""
            self._pos = 0
            self._refill()
            if self._finished:
                return False
        return True

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            chunks = []
            while self._fill():
                chunks.append(self._buffer[self._pos:])
                self._pos = len(self._buffer)
            return b"".join(chunks)
        if n == 0:
            return b""
        if not self._fill():
            return b""
        take = min(n, len(self._buffer) - self._pos)
        out = self._buffer[self._pos:self._pos + take]
        self._pos += take
        return out

    def readinto(self, b) -> int:
        data = self.read(len(b))
        b[:len(data)] = data
        return len(data)


def compress_block_stream(data, block_size: int = 1 << 16,
                          device: str | torch.device = "cuda") -> bytes:
    """One call: ``data`` as a complete LZ4Block stream, the bytes of
    :class:`Lz4BlockOutputStream`. A batch of up to 64 MiB is one upload,
    one K2 launch over its blocks, then ``block_stream_body_packed`` (one
    K3 launch for the checks, seed 0x9747B28C, and one pack launch), and
    one download of its part of the stream."""
    _compression_level(block_size)
    dev = resolve_device(device)
    raw = memoryview(data).cast("B")
    step = max(1, _BATCH_BYTES // block_size) * block_size
    out = bytearray()
    for at in range(0, len(raw), step):
        src, lens, comp, comp_lens, err = cuda_instances.compress_rows(
            upload_bytes(raw[at:at + step], dev), block_size)
        cuda_instances.check_compressed(err)
        body, total = bs.block_stream_body_packed(src, lens, comp, comp_lens,
                                                  block_size)
        # every batch's body ends with the end block; the stream's only
        out += staging(dev, DOWN).download(
            body[:total - HEADER_LENGTH]).tobytes()
    out += _block_header(COMPRESSION_METHOD_RAW,
                         _compression_level(block_size), 0, 0, 0)
    return bytes(out)


def decompress_block_stream(data, stop_on_empty_block: bool = True,
                            device: str | torch.device = "cuda") -> bytes:
    """One call: decode an LZ4Block stream (concatenated streams with
    ``stop_on_empty_block=False``), as :class:`Lz4BlockInputStream` does,
    error for error. A window of up to 64 MiB of the stream is one upload
    and one walk of its headers on the card (``block_stream_index``), read
    back with its records; the records are decoded and checked on the card
    (``decompress_block_stream_batch``) in batches of up to 64 MiB of
    output, each read back once. The first faulty record's error wins, as
    in the stream reader: a fault of the walk is its last record."""
    dev = resolve_device(device)
    mv = memoryview(data).cast("B")
    out = bytearray()
    pos = 0
    while True:
        win = mv[pos:pos + _BATCH_BYTES]
        final = pos + len(win) == len(mv)
        stream = upload_bytes(win, dev)
        index = bs.block_stream_index(stream, len(win), _WINDOW_RECORDS,
                                      stop_on_empty_block)
        meta = torch.cat((index.meta, index.table.flatten())).tolist()
        count, end = meta[:2]
        records = [meta[2 + k::_WINDOW_RECORDS][:bs.FIELDS]
                   for k in range(count)]
        if not final and records and records[-1][bs.CODE] == bs.PREMATURE:
            # cut by the window's end, not the stream's: the next window
            end = records.pop()[bs.AT]
        _decode_records(stream, index, records, out)
        last = records[-1] if records else None
        if last is not None and stop_on_empty_block and last[bs.OLEN] == 0:
            return bytes(out)
        if final and len(records) == count and count < _WINDOW_RECORDS:
            return bytes(out)
        if end == 0:
            raise Lz4Error("LZ4Block walk made no progress")
        pos += end


def _decode_records(stream: torch.Tensor, index: bs.BlockStreamIndex,
                    records: list, out: bytearray) -> None:
    """The records of one walk, decoded and checked in order in batches of
    up to 64 MiB of output, appended to ``out``; raises the first faulty
    record's error."""
    a = 0
    while a < len(records):
        b, size = a, 0
        while b < len(records) and (b == a or size + records[b][bs.OLEN]
                                    <= _BATCH_BYTES):
            size += records[b][bs.OLEN]
            b += 1
        width = max(r[bs.OLEN] for r in records[a:b])
        rows, lens, err = bs.decompress_block_stream_batch(
            stream, index[a:b], width)
        codes, sizes = torch.stack((err, lens)).tolist()
        good = next((k for k, c in enumerate(codes) if c != bs.OK), len(codes))
        out += b"".join(from_device_layout(rows[:good], sizes[:good]))
        if good < len(codes):
            kind, message = _FAULTS.get(codes[good],
                                        (Lz4Error, "Malformed input"))
            raise kind(message)
        a = b
