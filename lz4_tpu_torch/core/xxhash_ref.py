"""Pure-Python reference implementation of xxHash32 / xxHash64, on the host.

The port's own copy of ``lz4_tpu/core/xxhash_ref.py`` (``lz4_tpu_torch``
imports nothing from the JAX package). It backs the ``cuda`` tier's
streaming hashes, and gives the tests and ``chip_smoke.py`` a host hash that
shares no code with the K3 and K4 kernels.

Semantics match the reference generated classes
(``src/build/source_templates/xxhash32_hash.template:27-83``,
``xxhash64_hash.template:27-103``, ``xxhash32_streaming.template:26-139``,
``xxhash64_streaming.template``), which in turn implement the canonical
XXH32/XXH64 algorithms.

All arithmetic is done on unsigned Python ints masked to 32/64 bits; the
public API returns *signed* canonical values where the Java API does (Java
ints/longs are signed) — helpers ``as_s32``/``as_s64`` convert. Hash values
returned by ``xxh32``/``xxh64`` here are unsigned (0..2^32-1 / 0..2^64-1);
use ``as_s32``/``as_s64`` when comparing against Java outputs.
"""

from __future__ import annotations

import struct

from .constants import (
    PRIME1, PRIME2, PRIME3, PRIME4, PRIME5,
    PRIME64_1, PRIME64_2, PRIME64_3, PRIME64_4, PRIME64_5,
    U32, U64,
)

__all__ = [
    "xxh32", "xxh64", "StreamingXXH32", "StreamingXXH64",
    "as_s32", "as_s64", "as_u32", "as_u64",
]


def as_s32(v: int) -> int:
    v &= U32
    return v - (1 << 32) if v >= (1 << 31) else v


def as_s64(v: int) -> int:
    v &= U64
    return v - (1 << 64) if v >= (1 << 63) else v


def as_u32(v: int) -> int:
    return v & U32


def as_u64(v: int) -> int:
    return v & U64


def _rotl32(v: int, n: int) -> int:
    v &= U32
    return ((v << n) | (v >> (32 - n))) & U32


def _rotl64(v: int, n: int) -> int:
    v &= U64
    return ((v << n) | (v >> (64 - n))) & U64


def _round32(v: int, x: int) -> int:
    return (_rotl32(v + x * PRIME2, 13) * PRIME1) & U32


def _round64(v: int, x: int) -> int:
    return (_rotl64(v + x * PRIME64_2, 31) * PRIME64_1) & U64


def _avalanche32(h32: int) -> int:
    h32 &= U32
    h32 ^= h32 >> 15
    h32 = (h32 * PRIME2) & U32
    h32 ^= h32 >> 13
    h32 = (h32 * PRIME3) & U32
    h32 ^= h32 >> 16
    return h32


def _avalanche64(h64: int) -> int:
    h64 &= U64
    h64 ^= h64 >> 33
    h64 = (h64 * PRIME64_2) & U64
    h64 ^= h64 >> 29
    h64 = (h64 * PRIME64_3) & U64
    h64 ^= h64 >> 32
    return h64


def _tail32(h32: int, buf, off: int, end: int) -> int:
    """Consume the <16-byte tail and apply the final avalanche."""
    while off <= end - 4:
        h32 = (h32 + struct.unpack_from("<I", buf, off)[0] * PRIME3) & U32
        h32 = (_rotl32(h32, 17) * PRIME4) & U32
        off += 4
    while off < end:
        h32 = (h32 + buf[off] * PRIME5) & U32
        h32 = (_rotl32(h32, 11) * PRIME1) & U32
        off += 1
    return _avalanche32(h32)


def _tail64(h64: int, buf, off: int, end: int) -> int:
    """Consume the <32-byte tail and apply the final avalanche."""
    while off <= end - 8:
        k1 = _round64(0, struct.unpack_from("<Q", buf, off)[0])
        h64 ^= k1
        h64 = (_rotl64(h64, 27) * PRIME64_1 + PRIME64_4) & U64
        off += 8
    if off <= end - 4:
        h64 ^= (struct.unpack_from("<I", buf, off)[0] * PRIME64_1) & U64
        h64 = (_rotl64(h64, 23) * PRIME64_2 + PRIME64_3) & U64
        off += 4
    while off < end:
        h64 ^= (buf[off] * PRIME64_5) & U64
        h64 = (_rotl64(h64, 11) * PRIME64_1) & U64
        off += 1
    return _avalanche64(h64)


def xxh32(buf, off: int = 0, length: int | None = None, seed: int = 0) -> int:
    """One-shot XXH32. Returns an unsigned 32-bit value."""
    if length is None:
        length = len(buf) - off
    if off < 0 or length < 0 or off + length > len(buf):
        raise IndexError(f"range [{off}, {off + length}) out of bounds for buffer of {len(buf)}")
    seed &= U32
    end = off + length

    if length >= 16:
        limit = end - 16
        v1 = (seed + PRIME1 + PRIME2) & U32
        v2 = (seed + PRIME2) & U32
        v3 = seed
        v4 = (seed - PRIME1) & U32
        while off <= limit:
            x1, x2, x3, x4 = struct.unpack_from("<IIII", buf, off)
            v1 = _round32(v1, x1)
            v2 = _round32(v2, x2)
            v3 = _round32(v3, x3)
            v4 = _round32(v4, x4)
            off += 16
        h32 = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & U32
    else:
        h32 = (seed + PRIME5) & U32

    h32 = (h32 + length) & U32
    return _tail32(h32, buf, off, end)


def xxh64(buf, off: int = 0, length: int | None = None, seed: int = 0) -> int:
    """One-shot XXH64. Returns an unsigned 64-bit value."""
    if length is None:
        length = len(buf) - off
    if off < 0 or length < 0 or off + length > len(buf):
        raise IndexError(f"range [{off}, {off + length}) out of bounds for buffer of {len(buf)}")
    seed &= U64
    end = off + length

    if length >= 32:
        limit = end - 32
        v1 = (seed + PRIME64_1 + PRIME64_2) & U64
        v2 = (seed + PRIME64_2) & U64
        v3 = seed
        v4 = (seed - PRIME64_1) & U64
        while off <= limit:
            x1, x2, x3, x4 = struct.unpack_from("<QQQQ", buf, off)
            v1 = _round64(v1, x1)
            v2 = _round64(v2, x2)
            v3 = _round64(v3, x3)
            v4 = _round64(v4, x4)
            off += 32
        h64 = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & U64
        for v in (v1, v2, v3, v4):
            h64 ^= _round64(0, v)
            h64 = (h64 * PRIME64_1 + PRIME64_4) & U64
    else:
        h64 = (seed + PRIME64_5) & U64

    h64 = (h64 + length) & U64
    return _tail64(h64, buf, off, end)


class StreamingXXH32:
    """Incremental XXH32 with a non-destructive ``get_value``.

    State layout mirrors the reference
    (``AbstractStreamingXXHash32Java.java:22-44``): four lane accumulators, a
    16-byte remainder buffer, and the total length seen so far.
    """

    _MEM = 16

    def __init__(self, seed: int = 0):
        self.seed = seed & U32
        self._memory = bytearray(self._MEM)
        self.reset()

    def reset(self) -> None:
        s = self.seed
        self._v1 = (s + PRIME1 + PRIME2) & U32
        self._v2 = (s + PRIME2) & U32
        self._v3 = s
        self._v4 = (s - PRIME1) & U32
        self._mem_size = 0
        self._total_len = 0

    def update(self, buf, off: int = 0, length: int | None = None) -> None:
        if length is None:
            length = len(buf) - off
        if off < 0 or length < 0 or off + length > len(buf):
            raise IndexError("range out of bounds")
        self._total_len += length

        if self._mem_size + length < self._MEM:
            self._memory[self._mem_size:self._mem_size + length] = buf[off:off + length]
            self._mem_size += length
            return

        end = off + length
        if self._mem_size > 0:
            take = self._MEM - self._mem_size
            self._memory[self._mem_size:] = buf[off:off + take]
            x1, x2, x3, x4 = struct.unpack_from("<IIII", self._memory, 0)
            self._v1 = _round32(self._v1, x1)
            self._v2 = _round32(self._v2, x2)
            self._v3 = _round32(self._v3, x3)
            self._v4 = _round32(self._v4, x4)
            off += take
            self._mem_size = 0

        limit = end - self._MEM
        v1, v2, v3, v4 = self._v1, self._v2, self._v3, self._v4
        while off <= limit:
            x1, x2, x3, x4 = struct.unpack_from("<IIII", buf, off)
            v1 = _round32(v1, x1)
            v2 = _round32(v2, x2)
            v3 = _round32(v3, x3)
            v4 = _round32(v4, x4)
            off += 16
        self._v1, self._v2, self._v3, self._v4 = v1, v2, v3, v4

        if off < end:
            self._memory[0:end - off] = buf[off:end]
            self._mem_size = end - off

    def get_value(self) -> int:
        if self._total_len >= 16:
            h32 = (_rotl32(self._v1, 1) + _rotl32(self._v2, 7)
                   + _rotl32(self._v3, 12) + _rotl32(self._v4, 18)) & U32
        else:
            h32 = (self.seed + PRIME5) & U32
        h32 = (h32 + self._total_len) & U32
        return _tail32(h32, self._memory, 0, self._mem_size)

    # Checksum-view quirk of the reference: value masked to 28 bits
    # (StreamingXXHash32.java:101-107 masks with 0xFFFFFFFL — seven F's).
    def checksum_value(self) -> int:
        return self.get_value() & 0xFFFFFFF

    def close(self) -> None:  # API parity with the JNI-backed tier
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class StreamingXXH64:
    """Incremental XXH64 with a non-destructive ``get_value``."""

    _MEM = 32

    def __init__(self, seed: int = 0):
        self.seed = seed & U64
        self._memory = bytearray(self._MEM)
        self.reset()

    def reset(self) -> None:
        s = self.seed
        self._v1 = (s + PRIME64_1 + PRIME64_2) & U64
        self._v2 = (s + PRIME64_2) & U64
        self._v3 = s
        self._v4 = (s - PRIME64_1) & U64
        self._mem_size = 0
        self._total_len = 0

    def update(self, buf, off: int = 0, length: int | None = None) -> None:
        if length is None:
            length = len(buf) - off
        if off < 0 or length < 0 or off + length > len(buf):
            raise IndexError("range out of bounds")
        self._total_len += length

        if self._mem_size + length < self._MEM:
            self._memory[self._mem_size:self._mem_size + length] = buf[off:off + length]
            self._mem_size += length
            return

        end = off + length
        if self._mem_size > 0:
            take = self._MEM - self._mem_size
            self._memory[self._mem_size:] = buf[off:off + take]
            x1, x2, x3, x4 = struct.unpack_from("<QQQQ", self._memory, 0)
            self._v1 = _round64(self._v1, x1)
            self._v2 = _round64(self._v2, x2)
            self._v3 = _round64(self._v3, x3)
            self._v4 = _round64(self._v4, x4)
            off += take
            self._mem_size = 0

        limit = end - self._MEM
        v1, v2, v3, v4 = self._v1, self._v2, self._v3, self._v4
        while off <= limit:
            x1, x2, x3, x4 = struct.unpack_from("<QQQQ", buf, off)
            v1 = _round64(v1, x1)
            v2 = _round64(v2, x2)
            v3 = _round64(v3, x3)
            v4 = _round64(v4, x4)
            off += 32
        self._v1, self._v2, self._v3, self._v4 = v1, v2, v3, v4

        if off < end:
            self._memory[0:end - off] = buf[off:end]
            self._mem_size = end - off

    def get_value(self) -> int:
        if self._total_len >= 32:
            v1, v2, v3, v4 = self._v1, self._v2, self._v3, self._v4
            h64 = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & U64
            for v in (v1, v2, v3, v4):
                h64 ^= _round64(0, v)
                h64 = (h64 * PRIME64_1 + PRIME64_4) & U64
        else:
            h64 = (self.seed + PRIME64_5) & U64
        h64 = (h64 + self._total_len) & U64
        return _tail64(h64, self._memory, 0, self._mem_size)

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
