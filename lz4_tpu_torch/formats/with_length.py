"""Length-prefixed block codec.

Counterpart of ``lz4_tpu/formats/with_length.py`` (lz4-java's
``LZ4CompressorWithLength`` / ``LZ4DecompressorWithLength``,
``LZ4CompressorWithLength.java:45-57,155-159``,
``LZ4DecompressorWithLength.java:41-131``): the 4-byte little-endian
original length, then the compressed block. It wraps any compressor and
decompressor, the ``cuda`` tier's included, whose kernels do the work.
Not interoperable with any other format (LZ4CompressorWithLength.java:22-28).
"""

from __future__ import annotations

import struct

from ..api.abstract import Lz4FastDecompressor, Lz4SafeDecompressor
from ..core.errors import Lz4Error

_U32 = struct.Struct("<I")
PREFIX_LENGTH = 4


class Lz4CompressorWithLength:
    """Wraps any compressor; output = length(4 LE) + compressed block."""

    def __init__(self, compressor):
        self._compressor = compressor

    def max_compressed_length(self, length: int) -> int:
        return self._compressor.max_compressed_length(length) + PREFIX_LENGTH

    def compress(self, src, src_off: int, src_len: int, dest, dest_off: int,
                 max_dest_len: int) -> int:
        if max_dest_len < PREFIX_LENGTH:
            raise Lz4Error("maxDestLen is too small")
        n = self._compressor.compress(
            src, src_off, src_len, dest, dest_off + PREFIX_LENGTH,
            max_dest_len - PREFIX_LENGTH)
        dest[dest_off:dest_off + PREFIX_LENGTH] = _U32.pack(src_len)
        return n + PREFIX_LENGTH

    def compress_alloc(self, src, src_off: int = 0,
                       src_len: int | None = None) -> bytes:
        if src_len is None:
            src_len = len(src) - src_off
        dest = bytearray(self.max_compressed_length(src_len))
        n = self.compress(src, src_off, src_len, dest, 0, len(dest))
        return bytes(dest[:n])


def get_decompressed_length(src, src_off: int = 0) -> int:
    """The original length from the prefix
    (LZ4DecompressorWithLength.java:41-75)."""
    return _U32.unpack_from(src, src_off)[0]


class Lz4DecompressorWithLength:
    """Wraps a fast or a safe decompressor
    (LZ4DecompressorWithLength.java:84-131)."""

    def __init__(self, decompressor):
        if isinstance(decompressor, Lz4FastDecompressor):
            self._fast, self._safe = decompressor, None
        elif isinstance(decompressor, Lz4SafeDecompressor):
            self._fast, self._safe = None, decompressor
        else:
            raise TypeError("expected a fast or safe decompressor")

    def decompress(self, src, src_off: int, dest, dest_off: int,
                   src_len: int | None = None) -> int:
        """Decompress a length-prefixed block; returns the bytes written."""
        dest_len = get_decompressed_length(src, src_off)
        if dest_len > len(dest) - dest_off:
            raise Lz4Error("Output buffer too small")
        if self._fast is not None:
            self._fast.decompress(src, src_off + PREFIX_LENGTH, dest,
                                  dest_off, dest_len)
            return dest_len
        if src_len is None:
            src_len = len(src) - src_off
        return self._safe.decompress(
            src, src_off + PREFIX_LENGTH, src_len - PREFIX_LENGTH,
            dest, dest_off, dest_len)

    def decompress_alloc(self, src, src_off: int = 0,
                         src_len: int | None = None) -> bytes:
        dest = bytearray(get_decompressed_length(src, src_off))
        self.decompress(src, src_off, dest, 0, src_len)
        return bytes(dest)
