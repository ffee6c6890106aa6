"""LZ4 Frame v1.5.1: the serial writer and reader, the one-shot codecs,
the frame constants and the header parsers.

Counterpart of ``lz4_tpu/formats/frame.py`` with its names, its contracts
and its error messages, byte-compatible with the ``lz4`` CLI and
lz4-java's ``LZ4FrameOutputStream``/``LZ4FrameInputStream``; the port keeps
its own copies of the constants and parsers, so it imports nothing from
the JAX package. Every codec runs on the card (``device="cpu"`` runs the
kernels' plain versions):

- :class:`Lz4FrameOutputStream` compresses the blocks it holds in batches
  of up to 64 MiB, one launch each (K2, K6 for an HC compressor, or K2
  with a dictionary, and K2 again only on the blocks the dictionary did
  not shrink, as the JAX writer compresses them twice); block checksums
  are one K3 launch a batch, the content checksum the card's streaming
  XXH32. Blocks are independent, so the bytes equal those of a writer
  that compresses one block at a time.
- :class:`Lz4FrameInputStream` reads a block at a time: independent
  blocks through K1, linked blocks (``allow_dependent_blocks``, ``lz4
  -BD``) through K1 with a history, against the up to 64 KiB of the
  frame's own output kept on the card, and blocks of a dictionary frame
  against the dictionary's tail.
- :func:`compress_frame` is the writer in one call; :func:`decompress_frame`
  decodes a batch of independent blocks in one launch
  (``streams/pipeline.py``, one K1 with a history a batch in a dictionary
  frame) and a batch of linked blocks in one walk and one resolve
  (``kernels/linked_decode.py``).

frame  = magic(4, LE 0x184D2204) FLG BD [content_size(8)] [dict_id(4)] HC
         block* endmark(4 x 0) [content_checksum(4)]
block  = size(4 LE; high bit set => stored uncompressed) payload
         [block_checksum(4)]
"""

from __future__ import annotations

import enum
import io
import struct

import numpy as np
import torch

from ..api import cuda_instances
from ..api.factory import Lz4Factory, XXHashFactory
from ..core.constants import PRIME1, PRIME2, PRIME3, PRIME4, PRIME5, U32
from ..core.device import resolve_device
from ..core.errors import Lz4Error, Lz4FrameError
from ..kernels import codec
from ..kernels.layout import (
    DOWN, row_stride, staging, to_device_layout, upload_bytes)

MAGIC = 0x184D2204
MAGIC_SKIPPABLE_BASE = 0x184D2A50
INCOMPRESSIBLE_MASK = 0x80000000
_VERSION = 1
_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")
# the writer's batch: the pending bytes compressed in one launch
_BATCH_BYTES = 64 << 20


class FrameFlag(enum.IntEnum):
    """FLG bit positions (LZ4FrameOutputStream.java:313-321).

    DICT_ID (bit 0, frame spec v1.6+) is written only with a dictionary,
    and read only when a dictionary is supplied."""
    DICT_ID = 0
    CONTENT_CHECKSUM = 2
    CONTENT_SIZE = 3
    BLOCK_CHECKSUM = 4
    BLOCK_INDEPENDENCE = 5


class BlockSize(enum.IntEnum):
    """BD block-maximum-size indicators (LZ4FrameOutputStream.java:62-80)."""
    SIZE_64KB = 4
    SIZE_256KB = 5
    SIZE_1MB = 6
    SIZE_4MB = 7

    @property
    def num_bytes(self) -> int:
        return 1 << (2 * self.value + 8)

    @classmethod
    def from_indicator(cls, indicator: int) -> "BlockSize":
        try:
            return cls(indicator)
        except ValueError:
            raise Lz4FrameError(
                f"Block size must be 4-7. Cannot use value of [{indicator}]")


DEFAULT_FEATURES = (FrameFlag.BLOCK_INDEPENDENCE,)


def _flg_to_byte(flags: frozenset[FrameFlag]) -> int:
    b = (_VERSION & 3) << 6
    for f in flags:
        b |= 1 << f.value
    return b


def _flg_from_byte(b: int, allow_dependent: bool = False,
                   allow_dict_id: bool = False) -> frozenset[FrameFlag]:
    """FLG byte -> flags; raises on a version other than 1, on reserved
    bits, on the DictID bit unless ``allow_dict_id`` (a dictionary was
    supplied) and on linked blocks unless ``allow_dependent``, with the
    JAX package's messages."""
    version = (b >> 6) & 3
    if version != _VERSION:
        raise Lz4FrameError(f"Version {version} is unsupported")
    if b & 0b10:
        raise Lz4FrameError("Reserved bits must be 0")
    if (b & 0b01) and not allow_dict_id:
        raise Lz4FrameError(
            "Reserved bits must be 0 (bit 0 is DictID in frame spec "
            "v1.6+ — pass dictionary= to read dictionary frames)")
    flags = frozenset(f for f in FrameFlag if b & (1 << f.value))
    if FrameFlag.BLOCK_INDEPENDENCE not in flags and not allow_dependent:
        raise Lz4FrameError(
            "Dependent block stream is unsupported (BLOCK_INDEPENDENCE must be set)")
    return flags


def _bd_from_byte(b: int) -> BlockSize:
    if b & 0x8F:
        raise Lz4FrameError("Reserved fields must be 0")
    return BlockSize.from_indicator((b >> 4) & 7)


def make_skippable_frame(payload: bytes, subtype: int = 0) -> bytes:
    """A skippable frame (magic 0x184D2A5x) wrapping arbitrary bytes."""
    if not 0 <= subtype <= 0xF:
        raise ValueError("subtype must be 0..15")
    return (_U32.pack(MAGIC_SKIPPABLE_BASE + subtype)
            + _U32.pack(len(payload)) + payload)


def _rotl32(v: int, r: int) -> int:
    return ((v << r) | (v >> (32 - r))) & 0xFFFFFFFF


def xxh32_bytes(data: bytes, seed: int = 0) -> int:
    """XXH32 of ``data`` on the host in plain Python (a few MB/s).

    It gives the header checksum byte, and checks a frame's content
    checksum with no code in common with the K3 kernel.
    """
    m = 0xFFFFFFFF
    seed &= m
    n = len(data)
    n_stripes = n // 16
    if n_stripes:
        v1, v2 = (seed + PRIME1 + PRIME2) & m, (seed + PRIME2) & m
        v3, v4 = seed, (seed - PRIME1) & m
        words = np.frombuffer(data, "<u4", count=4 * n_stripes)
        for c in range(0, words.size, 1 << 18):
            w = words[c:c + (1 << 18)].tolist()
            for i in range(0, len(w), 4):
                v1 = _rotl32((v1 + w[i] * PRIME2) & m, 13) * PRIME1 & m
                v2 = _rotl32((v2 + w[i + 1] * PRIME2) & m, 13) * PRIME1 & m
                v3 = _rotl32((v3 + w[i + 2] * PRIME2) & m, 13) * PRIME1 & m
                v4 = _rotl32((v4 + w[i + 3] * PRIME2) & m, 13) * PRIME1 & m
        h = _rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)
    else:
        h = seed + PRIME5
    h = (h + n) & m
    i = 16 * n_stripes
    while i + 4 <= n:
        w = struct.unpack_from("<I", data, i)[0]
        h = _rotl32((h + w * PRIME3) & m, 17) * PRIME4 & m
        i += 4
    for b in data[i:]:
        h = _rotl32((h + b * PRIME5) & m, 11) * PRIME1 & m
    h ^= h >> 15
    h = h * PRIME2 & m
    h ^= h >> 13
    h = h * PRIME3 & m
    return h ^ (h >> 16)


def frame_header(block_size: int, content_checksum: bool) -> bytes:
    """Magic, FLG, BD and HC of a frame of independent blocks."""
    sizes = {b.num_bytes: b for b in BlockSize}
    if block_size not in sizes:
        raise ValueError("block_size must be one of 64KB/256KB/1MB/4MB")
    flags = {FrameFlag.BLOCK_INDEPENDENCE}
    if content_checksum:
        flags.add(FrameFlag.CONTENT_CHECKSUM)
    desc = bytes([_flg_to_byte(frozenset(flags)),
                  (sizes[block_size].value & 7) << 4])
    hc = (xxh32_bytes(desc) >> 8) & 0xFF
    return _U32.pack(MAGIC) + desc + bytes([hc])


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

def _writer_flags(features, known_size: int, dictionary, dict_id,
                  compressor):
    """The FLG flags and DictID of a writer, with the JAX writer's refusals
    (``lz4_tpu/formats/frame.py:138-168``)."""
    features = frozenset(features)
    if FrameFlag.DICT_ID in features and dictionary is None:
        raise Lz4FrameError(
            "DICT_ID requires a dictionary (the parity writer never "
            "emits a dictID)")
    if dict_id is not None and dictionary is None:
        raise Lz4FrameError("dict_id requires a dictionary")
    if dictionary is not None and compressor is not None:
        raise Lz4FrameError(
            "dictionary frames use the built-in dictionary compressor; "
            "a custom compressor is not supported with dictionary=")
    flags = features | {FrameFlag.BLOCK_INDEPENDENCE}
    if dict_id is not None or (dictionary is not None
                               and FrameFlag.DICT_ID in features):
        dict_id = 0 if dict_id is None else dict_id
        flags = flags | {FrameFlag.DICT_ID}
    else:
        flags = flags - {FrameFlag.DICT_ID}
    if known_size >= 0:
        flags = flags | {FrameFlag.CONTENT_SIZE}
    return flags, dict_id


class Lz4FrameOutputStream(io.RawIOBase):
    """File-like LZ4 Frame writer over an underlying binary stream, on
    ``device``.

    The header is written on construction, the blocks once 64 MiB of them
    wait (each batch compressed in one launch), at :meth:`flush` (with the
    short block there is) and at :meth:`close`, then the end mark and the
    content checksum. A block that does not shrink is stored raw.
    ``dictionary`` writes a dictionary frame: every block's window is the
    dictionary's last 64 KiB, and ``dict_id`` (optional) is recorded as the
    DictID field; blocks stay independent. ``compressor`` (no dictionary)
    is one of the ``cuda`` tier's, which compress a batch in one launch:
    ``fast_compressor()`` (K2, the default) or ``high_compressor(level)``
    (K6); ``checksum`` is the tier's ``hash32()`` (K3) unless given.
    """

    def __init__(self, out, block_size: BlockSize = BlockSize.SIZE_4MB,
                 known_size: int = -1,
                 features: tuple[FrameFlag, ...] = DEFAULT_FEATURES,
                 compressor=None, checksum=None,
                 dictionary: bytes | None = None,
                 dict_id: int | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self._out = out
        self._flags, self._dict_id = _writer_flags(
            features, known_size, dictionary, dict_id, compressor)
        self._dev = resolve_device(device)
        self._dict_tail = bytes(dictionary)[-65536:] if dictionary else None
        self._block_size = block_size
        self._max_block = block_size.num_bytes
        self._known_size = known_size
        self._compressor = (compressor
                            or Lz4Factory.cuda_instance(self._dev)
                            .fast_compressor())
        hashes = XXHashFactory.cuda_instance(self._dev)
        self._checksum = checksum or hashes.hash32()
        self._content_hash = (hashes.new_streaming_hash32(0)
                              if FrameFlag.CONTENT_CHECKSUM in self._flags
                              else None)
        self._buffer = bytearray()
        self._finished = False
        self._write_header()

    def writable(self) -> bool:
        return True

    def _write_header(self) -> None:
        desc = bytearray()
        desc.append(_flg_to_byte(self._flags))
        desc.append((self._block_size.value & 7) << 4)
        if FrameFlag.CONTENT_SIZE in self._flags:
            desc += _U64.pack(self._known_size)
        if FrameFlag.DICT_ID in self._flags:
            desc += _U32.pack(self._dict_id)
        hc = ((self._checksum.hash(bytes(desc), 0, len(desc), 0) & U32)
              >> 8) & 0xFF
        self._out.write(_U32.pack(MAGIC) + bytes(desc) + bytes([hc]))

    def write(self, data) -> int:
        if self._finished:
            raise ValueError("The stream is already closed")
        data = memoryview(data).cast("B")
        self._buffer += data
        if len(self._buffer) >= max(_BATCH_BYTES, self._max_block):
            full = len(self._buffer) // self._max_block * self._max_block
            self._write_blocks(memoryview(self._buffer)[:full])
            del self._buffer[:full]
        return len(data)

    def _write_blocks(self, data: memoryview) -> None:
        """``data`` cut into blocks of the frame's size (the last may be
        short), compressed in one batch and written."""
        if not len(data):
            return
        if self._content_hash is not None:
            self._content_hash.update(data)
        mb = self._max_block
        blocks = [data[i:i + mb] for i in range(0, len(data), mb)]
        parts, payloads = [], []
        for raw, comp in zip(blocks, self._compress(blocks)):
            if len(comp) < len(raw):
                parts.append(_U32.pack(len(comp)))
                payloads.append(comp)
            else:   # incompressible: stored raw with the high-bit mask
                parts.append(_U32.pack(len(raw) | INCOMPRESSIBLE_MASK))
                payloads.append(raw)
            parts.append(payloads[-1])
        if FrameFlag.BLOCK_CHECKSUM in self._flags:   # one K3 launch
            rows, lens = to_device_layout(payloads,
                                          device=self._checksum.device)
            sums = [h & U32 for h in
                    self._checksum.hash_batch(rows, lens, 0).tolist()]
            parts = [p for i in range(len(payloads))
                     for p in (parts[2 * i], parts[2 * i + 1],
                               _U32.pack(sums[i]))]
        self._out.write(b"".join(parts))

    def _compress(self, blocks) -> list[bytes]:
        """Each block's compressed bytes. With a dictionary, one launch of
        K2 with the dictionary, then, on the blocks it did not shrink, the
        plain compressor, as the JAX writer compresses such a block again
        (``lz4_tpu/formats/frame.py:211-245``)."""
        if self._dict_tail is None:
            return self._compressor.compress_batch(blocks)
        comps = cuda_instances.compress_blocks_with_dict(
            blocks, self._dict_tail, self._dev)
        again = [i for i, (b, c) in enumerate(zip(blocks, comps))
                 if len(c) >= len(b)]
        if again:
            for i, c in zip(again, self._compressor.compress_batch(
                    [blocks[i] for i in again])):
                comps[i] = c
        return comps

    def flush(self) -> None:
        if not self._finished:
            self._write_blocks(memoryview(self._buffer))
            self._buffer.clear()
        if hasattr(self._out, "flush"):
            self._out.flush()

    def _write_end_mark(self) -> None:
        self._out.write(_U32.pack(0))
        if self._content_hash is not None:
            self._out.write(_U32.pack(self._content_hash.get_value() & U32))
        self._finished = True

    def close(self) -> None:
        if not self.closed:
            if not self._finished:
                self.flush()
                self._write_end_mark()
            super().close()

    def close_keep_underlying(self) -> None:
        """Finish the frame without closing the wrapped stream."""
        if not self._finished:
            self.flush()
            self._write_end_mark()


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

class _Window:
    """The up to 64 KiB of output before the next block of a frame, on the
    device, with a row for that block right behind it: a linked block
    decodes (K1 with a history) into the row against the bytes before it,
    which are the frame's own earlier output (or a dictionary's tail)."""

    def __init__(self, device: torch.device, max_block: int, history: bytes):
        self._dev = device
        self._max = max_block
        self._buf = torch.zeros((codec.WINDOW + row_stride(max_block),),
                                dtype=torch.uint8, device=device)
        self._len = len(history)
        if history:
            self._buf[codec.WINDOW - self._len:codec.WINDOW] = upload_bytes(
                history, device)

    def decode(self, payload, advance: bool) -> bytes:
        """Decode one block against the window; ``advance`` makes its output
        part of the window (a linked block)."""
        w = codec.WINDOW
        comp, comp_lens = to_device_layout([payload], device=self._dev)
        hist = self._buf[w - max(self._len, 1):w].view(1, -1)
        hist_lens = torch.full((1,), self._len, dtype=torch.int32,
                               device=self._dev)
        out = self._buf[w:w + self._max].view(1, -1)
        _, out_lens, err = codec.decompress_safe_hist_batch(
            comp, comp_lens, self._max, hist, hist_lens, out=out)
        code, n = torch.stack((err, out_lens)).view(-1).tolist()
        if code == codec.ERR_DEST_TOO_SMALL:
            raise Lz4Error("maxDestLen is too small")
        if code != codec.OK:
            raise Lz4Error("Malformed input")
        raw = staging(self._dev, DOWN).download(out[0, :n]).tobytes()
        if advance:
            self._advance(n)
        return raw

    def push(self, raw: bytes) -> None:
        """A block stored raw becomes part of the window."""
        if raw:
            w = codec.WINDOW
            self._buf[w:w + len(raw)] = upload_bytes(raw, self._dev)
        self._advance(len(raw))

    def _advance(self, n: int) -> None:
        w = codec.WINDOW
        k = min(w, self._len + n)
        self._buf[w - k:w] = self._buf[w + n - k:w + n].clone()
        self._len = k


class Lz4FrameInputStream(io.RawIOBase):
    """File-like LZ4 Frame reader on ``device``: concatenated and skippable
    frames, header, block and content checksums, the declared content size,
    a lazy header read (``LZ4FrameInputStream.java:132-345``), a block at a
    time.

    ``allow_dependent_blocks`` also reads linked-block frames (``lz4
    -BD``), refused by default as the reference refuses them; their blocks
    decode on the card against the frame's own earlier output, which stays
    there (``_Window``), and the window starts afresh at each frame.
    ``dictionary`` reads dictionary frames (``lz4 -D``, LZ4F's usingDict)
    and accepts the DictID field: its last 64 KiB are the window of every
    independent block and the first window of a linked frame. In those two
    modes the blocks go to K1 with a history, not to ``decompressor``, as
    the JAX reader sends them to its history decoder.
    """

    def __init__(self, inp, read_single_frame: bool = False,
                 decompressor=None, checksum=None,
                 allow_dependent_blocks: bool = False,
                 dictionary: bytes | None = None,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self._in = inp
        self._read_single_frame = read_single_frame
        self._dev = resolve_device(device)
        self._decompressor = (decompressor
                              or Lz4Factory.cuda_instance(self._dev)
                              .safe_decompressor())
        self._hashes = XXHashFactory.cuda_instance(self._dev)
        self._checksum = checksum or self._hashes.hash32()
        self._allow_dependent = allow_dependent_blocks
        self._dependent = False
        self._dict_tail = bytes(dictionary)[-65536:] if dictionary else b""
        self._has_dict = dictionary is not None
        self._dict_id: int | None = None
        self._window: _Window | None = None
        self._buffer = b""
        self._pos = 0
        self._first_header_read = False
        self._frame_finished = False
        self._flags: frozenset[FrameFlag] = frozenset()
        self._max_block = 0
        self._content_hash = None
        self._expected_content_size = -1
        self._total_content_size = 0

    def readable(self) -> bool:
        return True

    @property
    def expected_content_size(self) -> int:
        """Content size declared in the current frame header, or -1
        (``getExpectedContentSize``, LZ4FrameInputStream.java:416-445)."""
        return self._expected_content_size

    @property
    def dict_id(self) -> int | None:
        """DictID declared in the current frame header, or None. Only set
        when a dictionary was supplied."""
        return self._dict_id

    def _read_exact(self, n: int, *, allow_eof_at_start: bool = False):
        data = b""
        while len(data) < n:
            chunk = self._in.read(n - len(data))
            if not chunk:
                if allow_eof_at_start and not data:
                    return None
                raise Lz4FrameError("Stream ended prematurely")
            data += chunk
        return data

    def _next_frame_info(self) -> bool:
        while True:
            word = self._read_exact(4,
                                    allow_eof_at_start=self._first_header_read)
            if word is None:
                return False
            magic = _U32.unpack(word)[0]
            if magic == MAGIC:
                self._read_header()
                return True
            if (magic >> 4) == (MAGIC_SKIPPABLE_BASE >> 4):
                remaining = _U32.unpack(self._read_exact(4))[0]
                while remaining:   # in pieces: the size comes from the input
                    remaining -= len(self._read_exact(min(remaining, 1 << 20)))
                self._first_header_read = True
                continue
            raise Lz4FrameError("Stream unsupported (not an LZ4 frame)")

    def _read_header(self) -> None:
        desc = bytearray(self._read_exact(2))
        self._flags = _flg_from_byte(desc[0], self._allow_dependent,
                                     self._has_dict)
        self._dependent = FrameFlag.BLOCK_INDEPENDENCE not in self._flags
        block_size = _bd_from_byte(desc[1])
        if FrameFlag.CONTENT_SIZE in self._flags:
            raw = self._read_exact(8)
            desc += raw
            self._expected_content_size = _U64.unpack(raw)[0]
        else:
            self._expected_content_size = -1
        if FrameFlag.DICT_ID in self._flags:
            raw = self._read_exact(4)
            desc += raw           # the DictID is under the header checksum
            self._dict_id = _U32.unpack(raw)[0]
        else:
            self._dict_id = None
        self._total_content_size = 0
        expected_hc = self._read_exact(1)[0]
        hc = ((self._checksum.hash(bytes(desc), 0, len(desc), 0) & U32)
              >> 8) & 0xFF
        if hc != expected_hc:
            raise Lz4FrameError("Frame header checksum mismatch")
        self._max_block = block_size.num_bytes
        # the window starts afresh at each frame, from the dictionary
        self._window = (_Window(self._dev, self._max_block, self._dict_tail)
                        if self._dependent or self._has_dict else None)
        self._content_hash = (self._hashes.new_streaming_hash32(0)
                              if FrameFlag.CONTENT_CHECKSUM in self._flags
                              else None)
        self._first_header_read = True
        self._frame_finished = False

    def _read_block(self) -> None:
        size_word = _U32.unpack(self._read_exact(4))[0]
        compressed = (size_word & INCOMPRESSIBLE_MASK) == 0
        block_size = size_word & ~INCOMPRESSIBLE_MASK

        if block_size == 0:  # end mark
            if self._content_hash is not None:
                expect = _U32.unpack(self._read_exact(4))[0]
                if expect != (self._content_hash.get_value() & U32):
                    raise Lz4FrameError("Content checksum mismatch")
            if (self._expected_content_size >= 0
                    and self._expected_content_size != self._total_content_size):
                raise Lz4FrameError("Size check mismatch")
            self._frame_finished = True
            return

        if block_size > self._max_block:
            raise Lz4FrameError(
                f"Block size {block_size} exceeded max: {self._max_block}")
        payload = self._read_exact(block_size)

        if FrameFlag.BLOCK_CHECKSUM in self._flags:
            expect = _U32.unpack(self._read_exact(4))[0]
            if expect != (self._checksum.hash(payload, 0, block_size, 0) & U32):
                raise Lz4FrameError("Block checksum mismatch")

        if compressed and self._window is not None:
            raw = self._window.decode(payload, advance=self._dependent)
        elif compressed:
            raw = self._decompressor.decompress_alloc(
                payload, 0, block_size, self._max_block)
        else:
            raw = payload
            if self._dependent:
                self._window.push(raw)
        if self._content_hash is not None:
            self._content_hash.update(raw, 0, len(raw))
        self._total_content_size += len(raw)
        self._buffer = raw
        self._pos = 0

    def _fill(self) -> bool:
        """At least one readable byte buffered; False at the end."""
        while self._pos >= len(self._buffer):
            if not self._first_header_read or self._frame_finished:
                if self._first_header_read and self._read_single_frame:
                    return False
                if not self._next_frame_info():
                    return False
            self._read_block()
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


# ---------------------------------------------------------------------------
# one-shot
# ---------------------------------------------------------------------------

def compress_frame(data, block_size: BlockSize = BlockSize.SIZE_4MB,
                   features: tuple[FrameFlag, ...] = DEFAULT_FEATURES,
                   known_size: bool = False, compressor=None,
                   dictionary: bytes | None = None,
                   dict_id: int | None = None,
                   device: str | torch.device = "cuda") -> bytes:
    """One call: ``data`` as a complete LZ4 frame, through
    :class:`Lz4FrameOutputStream` (its blocks in batches of 64 MiB, one
    launch each). The bytes equal ``lz4_tpu.formats.compress_frame``'s: the
    content size is declared when ``known_size`` is set or ``features``
    names it, as the JAX package's one-call codec declares it.
    ``dictionary`` writes a dictionary frame (each block's window is the
    dictionary's tail), ``dict_id`` its DictID field."""
    content_size = known_size
    if dictionary is None and compressor is None:
        # the JAX one-call codec's flags: the checksums asked for, and the
        # content size when known_size is set or features name it
        fl = frozenset(features)
        content_size = known_size or FrameFlag.CONTENT_SIZE in fl
        features = tuple(f for f in (FrameFlag.CONTENT_CHECKSUM,
                                     FrameFlag.BLOCK_CHECKSUM) if f in fl)
    out = io.BytesIO()
    stream = Lz4FrameOutputStream(
        out, block_size=block_size,
        known_size=len(data) if content_size else -1,
        features=features, compressor=compressor,
        dictionary=dictionary, dict_id=dict_id, device=device)
    stream.write(data)
    stream.close_keep_underlying()
    return out.getvalue()


def decompress_frame(data, read_single_frame: bool = False,
                     allow_dependent_blocks: bool = False,
                     dictionary: bytes | None = None,
                     device: str | torch.device = "cuda") -> bytes:
    """One call: decode one or more concatenated LZ4 frames.

    Frames of independent blocks decode through the stream pipeline's
    packed path, a batch of up to 64 MiB of blocks in one launch (with a
    dictionary, one
    launch of K1 with the dictionary as the history of every row); linked
    frames (``allow_dependent_blocks``, refused by default like the
    reference) a batch of up to 64 MiB at a time too, in one walk of every
    block's tokens and one pointer-doubling resolve against the output
    before the batch (``kernels/linked_decode.py``), with the output and
    errors of :class:`Lz4FrameInputStream`, which reads a block at a time.
    ``read_single_frame`` stops after the first frame. Empty input decodes
    to nothing, as the JAX package's one-call codec has it."""
    from ..streams.pipeline import decode_frames

    if not len(data):
        return b""
    out = io.BytesIO()
    decode_frames(io.BytesIO(data), out, "cuda", device=device,
                  allow_dependent=allow_dependent_blocks,
                  dictionary=dictionary, single_frame=read_single_frame,
                  batch_bytes=_BATCH_BYTES)
    return out.getvalue()
