"""The plain reference of the LZ4Block stream (lz4-java's
``LZ4BlockOutputStream`` and ``LZ4BlockInputStream``): XXH32 across rows
in NumPy, the writer's headers and end block, and a reader with the input
stream's checks. Payloads are the reference codec's (``reference.py``).

Written for the benchmark from the two Java sources, independent of the
program: it imports neither torch nor anything of the program, so that
its worker processes start in a blink::

    stream = block* end_block
    block  = "LZ4Block" token(1) compressed_len(4 LE) original_len(4 LE)
             check(4 LE) payload
    token  = method | level, method 0x10 raw or 0x20 LZ4,
             level = ceil(log2(block_size)) - 10
    end    = token(RAW | level), zero lengths and check

A block is stored raw where compressing did not make it smaller; its check
is XXH32 of the raw block with the stream's seed, masked by the
``Checksum`` adapter.
"""

from __future__ import annotations

import dataclasses
import importlib
import struct

import numpy as np

from . import reference

MAGIC = b"LZ4Block"
HEADER = struct.Struct("<8sBIII")
HEADER_LENGTH = HEADER.size         # 21
METHOD_RAW = 0x10
METHOD_LZ4 = 0x20
LEVEL_BASE = 10

_P1, _P2, _P3, _P4, _P5 = (2654435761, 2246822519, 3266489917, 668265263,
                           374761393)
_M = 0xFFFFFFFF


class MalformedStream(ValueError):
    """The stream breaks a rule of ``LZ4BlockInputStream``."""


def level_of(block_size: int) -> int:
    """The token's level: ceil(log2(block_size)) - 10, at least 0."""
    return max(0, (block_size - 1).bit_length() - LEVEL_BASE)


def header(method: int, level: int, comp_len: int, orig_len: int,
           check: int) -> bytes:
    return HEADER.pack(MAGIC, method | level, comp_len, orig_len, check)


def end_block(level: int) -> bytes:
    return header(METHOD_RAW, level, 0, 0, 0)


def write_block(raw: bytes, comp: bytes, level: int, check: int) -> bytes:
    """One block as the writer writes it, given the compressor's bytes
    ``comp`` of ``raw`` and the masked check."""
    if len(comp) >= len(raw):
        return header(METHOD_RAW, level, len(raw), len(raw), check) + raw
    return header(METHOD_LZ4, level, len(comp), len(raw), check) + comp


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def xxh32_rows(rows: np.ndarray, length: int, seed: int) -> np.ndarray:
    """XXH32 (seed ``seed``) of the first ``length`` bytes of every row of
    ``rows`` (uint8[N, W]), as uint32[N]: NumPy across the rows, a step a
    16-byte stripe, then the tail and the avalanche."""
    n = rows.shape[0]
    data = np.ascontiguousarray(rows[:, :length])
    u = np.uint32
    s = seed & _M
    with np.errstate(over="ignore"):
        stripes = length // 16
        if stripes:
            words = data[:, :16 * stripes].view("<u4").reshape(n, stripes, 4)
            v = np.tile(np.array([(s + _P1 + _P2) & _M, (s + _P2) & _M, s,
                                  (s - _P1) & _M], np.uint32), (n, 1))
            for i in range(stripes):
                v = _rotl(v + words[:, i, :] * u(_P2), 13) * u(_P1)
            h = (_rotl(v[:, 0], 1) + _rotl(v[:, 1], 7) + _rotl(v[:, 2], 12)
                 + _rotl(v[:, 3], 18))
        else:
            h = np.full(n, (s + _P5) & _M, np.uint32)
        h = h + u(length & _M)
        at = 16 * stripes
        while at + 4 <= length:
            x = data[:, at:at + 4].copy().view("<u4")[:, 0]
            h = _rotl(h + x * u(_P3), 17) * u(_P4)
            at += 4
        while at < length:
            h = _rotl(h + data[:, at].astype(np.uint32) * u(_P5), 11) * u(_P1)
            at += 1
        h ^= h >> u(15)
        h *= u(_P2)
        h ^= h >> u(13)
        h *= u(_P3)
        h ^= h >> u(16)
    return h


@dataclasses.dataclass
class Block:
    method: int
    level: int
    comp_len: int
    orig_len: int
    check: int
    payload: bytes


def read_header(stream: bytes, at: int) -> tuple[int, int, int, int]:
    """``(method, level, comp_len, orig_len, check)`` of the header at
    ``at``, with ``LZ4BlockInputStream``'s rules (the magic, the method,
    the original length within the level's block size, both lengths zero
    or neither, a raw block's lengths equal, the compressed length within
    the bound of the block size, a zero check on an empty block)."""
    if at + HEADER_LENGTH > len(stream):
        raise MalformedStream(f"a header cut off at {at}")
    magic, token, cl, ol, check = HEADER.unpack_from(stream, at)
    method, level = token & 0xF0, token & 0x0F
    size = 1 << (LEVEL_BASE + level)
    if (magic != MAGIC or method not in (METHOD_RAW, METHOD_LZ4)
            or ol > size or (ol == 0) != (cl == 0)
            or (method == METHOD_RAW and ol != cl)
            or cl > reference.max_compressed_length(size)
            or (ol == 0 and check != 0)):
        raise MalformedStream(f"a header that breaks a rule at {at}")
    return method, level, cl, ol, check


def read_stream(stream: bytes) -> tuple[list[Block], int]:
    """The data blocks of one stream, as its reader walks them up to the
    end block, and the level of that end block. :class:`MalformedStream`
    where a header breaks a rule, a payload is cut off, the end block is
    missing, or bytes follow it."""
    blocks, at = [], 0
    while True:
        method, level, cl, ol, check = read_header(stream, at)
        at += HEADER_LENGTH
        if ol == 0:
            if at != len(stream):
                raise MalformedStream(f"{len(stream) - at} bytes after the "
                                      "end block")
            return blocks, level
        if at + cl > len(stream):
            raise MalformedStream(f"a payload cut off at {at}")
        blocks.append(Block(method, level, cl, ol, check,
                            stream[at:at + cl]))
        at += cl


def stored_as_stated(codec: str, config: dict, raw: bytes, method: int,
                     payload: bytes) -> bool:
    """Whether a block of the stream is what the writer stores for ``raw``
    with the codec of ``codecs/<codec>.py``: the reference's compressed
    bytes where they are shorter than ``raw`` (and decode back to it),
    else ``raw`` stored raw."""
    comp = importlib.import_module(f"benchmark.codecs.{codec}").reference(
        raw, config)
    if len(comp) >= len(raw):
        return method == METHOD_RAW and payload == raw
    return (method == METHOD_LZ4 and payload == comp
            and reference.decompress_safe(comp, len(raw)) == raw)


def block_fault(block: Block, raw: bytes, check: int, level: int) -> bool:
    """Whether a data block read from a stream is not ``raw`` as the
    configuration states it, the payload aside where it is LZ4 (which
    the caller decodes): its level, its original length, its check (the
    raw block's, masked), and a raw payload's bytes."""
    return (block.level != level or block.orig_len != len(raw)
            or block.check != check
            or (block.method == METHOD_RAW and block.payload != raw))
