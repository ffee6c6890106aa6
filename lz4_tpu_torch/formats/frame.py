"""LZ4 Frame v1.5.1, writer side: header bytes and frame constants.

Own copies of ``lz4_tpu/formats/frame.py:33-82`` (``MAGIC``,
``INCOMPRESSIBLE_MASK``, ``FrameFlag``, ``BlockSize``, ``_flg_to_byte``) and
the header checksum byte (:func:`xxh32_bytes`), so the port imports
nothing from the JAX package. There is no frame reader here.

frame  = magic(4, LE 0x184D2204) FLG BD HC block* endmark(4 x 0)
         [content_checksum(4)]
block  = size(4 LE; high bit set => stored uncompressed) payload
"""

from __future__ import annotations

import enum
import struct

import numpy as np

from ..core.constants import PRIME1, PRIME2, PRIME3, PRIME4, PRIME5

MAGIC = 0x184D2204
INCOMPRESSIBLE_MASK = 0x80000000
_VERSION = 1


class FrameFlag(enum.IntEnum):
    """FLG bit positions (LZ4FrameOutputStream.java:313-321)."""
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


def _flg_to_byte(flags: frozenset[FrameFlag]) -> int:
    b = (_VERSION & 3) << 6
    for f in flags:
        b |= 1 << f.value
    return b


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
    return struct.pack("<I", MAGIC) + desc + bytes([hc])
