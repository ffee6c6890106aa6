"""The LZ4Block stream format (lz4-java's ``LZ4BlockOutputStream``, which
Kafka and Spark write), on the card.

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
K1's fast contract, K3); :func:`compress_block_stream` and
:func:`decompress_block_stream` take a batch of blocks at a time: one K2
or K1-fast launch (one a decoded length: a batch's full blocks and its
short one) and one K3 launch a batch, with the same bytes as the classes.
"""

from __future__ import annotations

import io
import struct

import numpy as np
import torch

from ..api import cuda_instances
from ..api.factory import Lz4Factory, XXHashFactory
from ..core.constants import U32, max_compressed_length
from ..core.device import resolve_device
from ..core.errors import Lz4Error, Lz4FrameError
from ..kernels import codec
from ..kernels.layout import (
    from_device_layout, row_stride, to_device_layout, upload_bytes)
from ..kernels.xxhash import xxh32_batch

MAGIC = b"LZ4Block"
MAGIC_LENGTH = len(MAGIC)
HEADER_LENGTH = MAGIC_LENGTH + 1 + 4 + 4 + 4  # 21

COMPRESSION_LEVEL_BASE = 10
MIN_BLOCK_SIZE = 64
MAX_BLOCK_SIZE = 1 << (COMPRESSION_LEVEL_BASE + 0x0F)  # 32 MB

COMPRESSION_METHOD_RAW = 0x10
COMPRESSION_METHOD_LZ4 = 0x20

DEFAULT_SEED = 0x9747B28C
_CHECK_MASK = 0xFFFFFFF     # the 28-bit Checksum adapter
_BATCH_BYTES = 64 << 20     # the one-shot functions' batch

_U32 = struct.Struct("<I")
_HEADER = struct.Struct("<8sBIII")


def _compression_level(block_size: int) -> int:
    if block_size < MIN_BLOCK_SIZE:
        raise ValueError(f"blockSize must be >= {MIN_BLOCK_SIZE}, got {block_size}")
    if block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"blockSize must be <= {MAX_BLOCK_SIZE}, got {block_size}")
    return max(0, (block_size - 1).bit_length() - COMPRESSION_LEVEL_BASE)


def default_checksum(device: str | torch.device = "cuda"):
    """The reference's default: XXH32 with seed 0x9747B28C through the
    28-bit adapter, on K3."""
    xxh = XXHashFactory.cuda_instance(device).hash32()

    def check(data, off, length) -> int:
        return xxh.hash(data, off, length, DEFAULT_SEED) & _CHECK_MASK

    return check


def _block_header(method: int, level: int, comp_len: int, orig_len: int,
                  check: int) -> bytes:
    return _HEADER.pack(MAGIC, method | level, comp_len, orig_len, check)


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
    header, with the reader's checks, the compressed length against the
    bound of the block size before anything of the payload is read."""
    magic, token, compressed_len, original_len, check = _HEADER.unpack(header)
    if magic != MAGIC:
        raise Lz4FrameError("Stream is corrupted")
    method = token & 0xF0
    level = COMPRESSION_LEVEL_BASE + (token & 0x0F)
    if method not in (COMPRESSION_METHOD_RAW, COMPRESSION_METHOD_LZ4):
        raise Lz4FrameError("Stream is corrupted")
    if (original_len > (1 << level)
            or (original_len == 0) != (compressed_len == 0)
            or (method == COMPRESSION_METHOD_RAW
                and original_len != compressed_len)):
        raise Lz4FrameError("Stream is corrupted")
    # compressed_len is up to 4 GB - 1 from the input; a payload never
    # exceeds the bound of its block size, so it is refused before the
    # payload is read
    if compressed_len > max_compressed_length(1 << level):
        raise Lz4FrameError("Stream is corrupted")
    if original_len == 0 and check != 0:
        raise Lz4FrameError("Stream is corrupted")
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
    one K2 launch over its blocks and one K3 launch (seed 0x9747B28C) over
    the same rows for their checksums, then one download."""
    level = _compression_level(block_size)
    dev = resolve_device(device)
    raw = memoryview(data).cast("B")
    step = max(1, _BATCH_BYTES // block_size) * block_size
    out = bytearray()
    for at in range(0, len(raw), step):
        chunk = raw[at:at + step]
        src, lens, comp, comp_lens, err = cuda_instances.compress_rows(
            upload_bytes(chunk, dev), block_size)
        cuda_instances.check_compressed(err)
        checks = xxh32_batch(src, lens, DEFAULT_SEED).to(torch.int64)
        comp_lens, checks = torch.stack((comp_lens.to(torch.int64),
                                         checks)).cpu().tolist()
        comps = from_device_layout(comp, comp_lens)
        for i, (cl, c) in enumerate(zip(comp_lens, comps)):
            block = chunk[i * block_size:(i + 1) * block_size]
            o = len(block)
            if cl >= o:
                out += _block_header(COMPRESSION_METHOD_RAW, level, o, o,
                                     checks[i] & _CHECK_MASK)
                out += block
            else:
                out += _block_header(COMPRESSION_METHOD_LZ4, level, cl, o,
                                     checks[i] & _CHECK_MASK)
                out += c
    out += _block_header(COMPRESSION_METHOD_RAW, level, 0, 0, 0)
    return bytes(out)


def decompress_block_stream(data, stop_on_empty_block: bool = True,
                            device: str | torch.device = "cuda") -> bytes:
    """One call: decode an LZ4Block stream (concatenated streams with
    ``stop_on_empty_block=False``), as :class:`Lz4BlockInputStream` does,
    error for error. The walk collects up to 64 MiB of blocks; their LZ4
    payloads are one upload and one K1-fast launch a decoded length, and
    the checksums one K3 launch (seed 0x9747B28C) over the decoded rows.
    A fault of the walk is raised after the blocks before it are checked,
    so the first faulty block's error wins, as in the stream reader."""
    dev = resolve_device(device)
    mv = memoryview(data).cast("B")
    out = bytearray()
    pos, done = 0, False
    while not done:
        batch, fault, budget = [], None, _BATCH_BYTES
        while budget > 0:
            if pos == len(mv):
                if stop_on_empty_block:
                    fault = Lz4FrameError("Stream ended prematurely")
                done = True
                break
            if pos + HEADER_LENGTH > len(mv):
                fault = Lz4FrameError("Stream ended prematurely")
                break
            try:
                method, _, cl, ol, check = _parse_header(
                    bytes(mv[pos:pos + HEADER_LENGTH]))
            except Lz4FrameError as e:
                fault = e
                break
            pos += HEADER_LENGTH
            if ol == 0:
                if stop_on_empty_block:
                    done = True
                    break
                continue
            if pos + cl > len(mv):
                fault = Lz4FrameError("Stream ended prematurely")
                break
            batch.append((method, mv[pos:pos + cl], ol, check))
            pos += cl
            budget -= ol
        out += _decode_batch(batch, dev)
        if fault is not None:
            raise fault
    return bytes(out)


def _decode_batch(batch, dev: torch.device) -> bytes:
    """The blocks of one walk, checked in order: each LZ4 payload decoded by
    K1's fast contract to its original length with the bytes read equal to
    its compressed length, and each block's checksum; raises the first
    block's fault."""
    if not batch:
        return b""
    n = len(batch)
    width = max(ol for _, _, ol, _ in batch)
    rows = torch.zeros((n, row_stride(width)), dtype=torch.uint8, device=dev)
    codes = [codec.OK] * n
    reads = [len(p) for _, p, _, _ in batch]
    lz4 = [i for i, b in enumerate(batch) if b[0] == COMPRESSION_METHOD_LZ4]
    raw = [i for i, b in enumerate(batch) if b[0] == COMPRESSION_METHOD_RAW]
    if raw:
        r, _ = to_device_layout([batch[i][1] for i in raw], cap=width,
                                device=dev)
        rows[raw] = r
    for ol in sorted({batch[i][2] for i in lz4}):
        idx = [i for i in lz4 if batch[i][2] == ol]
        comp, avail = to_device_layout([batch[i][1] for i in idx], device=dev)
        dec, src_read, err = codec.decompress_fast_batch(comp, avail, ol)
        rows[idx, :dec.shape[1]] = dec
        got = torch.stack((err, src_read)).cpu().tolist()
        for k, i in enumerate(idx):
            codes[i], reads[i] = got[0][k], got[1][k]
    lens = torch.tensor([ol for _, _, ol, _ in batch], dtype=torch.int32,
                        device=dev)
    sums = (xxh32_batch(rows, lens, DEFAULT_SEED).to(torch.int64)
            & _CHECK_MASK).cpu().tolist()
    for i, (_, payload, _, check) in enumerate(batch):
        if codes[i] != codec.OK:
            raise Lz4Error("Malformed input")
        if reads[i] != len(payload) or sums[i] != check:
            raise Lz4FrameError("Stream is corrupted")
    return b"".join(from_device_layout(rows, lens))
