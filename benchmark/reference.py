"""The plain reference: LZ4 fast compress, safe decode and the frame body,
in Python.

A frozen copy, made for the benchmark, of the plain versions that the
program's CPU tests hold its kernels against (LZ4 ``compress.template``
with lz4-java's per-length variant, ``decompress`` with the safe contract,
and the LZ4 frame's block layout). It imports neither torch nor
anything of the program, so that reference workers start in a blink and a
change to the program cannot change the yardstick. HC is in
``reference_hc.py``.
"""

from __future__ import annotations

import struct

# -- the LZ4 block format (LZ4Constants.java:23-53) ---------------------------
MIN_MATCH = 4
HASH_LOG = 12
HASH_LOG_64K = 13
SKIP_STRENGTH = 6
COPY_LENGTH = 8
LAST_LITERALS = 5
MF_LIMIT = COPY_LENGTH + MIN_MATCH   # 12
MIN_LENGTH = MF_LIMIT + 1            # 13
MAX_DISTANCE = 1 << 16
ML_BITS = 4
ML_MASK = (1 << ML_BITS) - 1         # 15
RUN_MASK = 15
LZ4_64K_LIMIT = (1 << 16) + (MF_LIMIT - 1)
HASH_MULT = 2654435761
U32 = 0xFFFFFFFF

# the frame's size word: the high bit marks a block stored raw
# (LZ4FrameOutputStream.java:215-222)
INCOMPRESSIBLE_MASK = 0x80000000

_read32 = struct.Struct("<I").unpack_from


def max_compressed_length(length: int) -> int:
    """LZ4_compressBound (LZ4Utils.java:32-41)."""
    return length + length // 255 + 16


# ---------------------------------------------------------------------------
# LZ4 fast compress, acceleration 1
# ---------------------------------------------------------------------------

def _common_bytes(src: bytes, o1: int, o2: int, limit: int) -> int:
    count = 0
    while o2 + count + 64 <= limit and \
            src[o1 + count:o1 + count + 64] == src[o2 + count:o2 + count + 64]:
        count += 64
    while o2 + count < limit and src[o1 + count] == src[o2 + count]:
        count += 1
    return count


def _write_len(out: bytearray, length: int) -> None:
    while length >= 0xFF:
        out.append(0xFF)
        length -= 0xFF
    out.append(length)


def compress_fast(src: bytes) -> bytes:
    """One block, as lz4-java's ``fastCompressor()`` writes it (LZ4's
    acceleration 1): below ``LZ4_64K_LIMIT`` bytes the 13-bit table with
    no distance check, from it on the 12-bit table within
    ``MAX_DISTANCE``."""
    src_len = len(src)
    out = bytearray()
    small = src_len < LZ4_64K_LIMIT
    shift = 32 - (HASH_LOG_64K if small else HASH_LOG)
    src_limit = src_len - LAST_LITERALS
    mflimit = src_len - MF_LIMIT
    anchor = 0

    if src_len >= MIN_LENGTH:
        table = [0] * (1 << (32 - shift))
        s = 1
        while True:
            fwd = s
            step = 1
            nb = 1 << SKIP_STRENGTH
            found = False
            while True:
                s = fwd
                fwd += step
                step = nb >> SKIP_STRENGTH
                nb += 1
                if fwd > mflimit:
                    break
                cur = _read32(src, s)[0]
                h = ((cur * HASH_MULT) & U32) >> shift
                ref = table[h]
                table[h] = s
                if ((small or s - ref < MAX_DISTANCE)
                        and _read32(src, ref)[0] == cur):
                    found = True
                    break
            if not found:
                break

            while (ref > 0 and s > anchor
                   and src[ref - 1] == src[s - 1]):
                s -= 1
                ref -= 1

            run_len = s - anchor
            token_at = len(out)
            out.append(0)
            if run_len >= RUN_MASK:
                token = RUN_MASK << ML_BITS
                _write_len(out, run_len - RUN_MASK)
            else:
                token = run_len << ML_BITS
            out += src[anchor:s]

            while True:
                back = s - ref
                out.append(back & 0xFF)
                out.append(back >> 8)
                s += MIN_MATCH
                ref += MIN_MATCH
                match_len = _common_bytes(src, ref, s, src_limit)
                s += match_len
                if match_len >= ML_MASK:
                    token |= ML_MASK
                    _write_len(out, match_len - ML_MASK)
                else:
                    token |= match_len
                out[token_at] = token

                if s > mflimit:
                    break
                prev = _read32(src, s - 2)[0]
                table[((prev * HASH_MULT) & U32) >> shift] = s - 2
                cur = _read32(src, s)[0]
                h = ((cur * HASH_MULT) & U32) >> shift
                ref = table[h]
                table[h] = s
                if not ((small or s - ref < MAX_DISTANCE)
                        and _read32(src, ref)[0] == cur):
                    break
                token_at = len(out)
                out.append(0)
                token = 0
            anchor = s
            if s > mflimit:
                break
            s += 1

    run_len = src_len - anchor
    if run_len >= RUN_MASK:
        out.append(RUN_MASK << ML_BITS)
        _write_len(out, run_len - RUN_MASK)
    else:
        out.append(run_len << ML_BITS)
    out += src[anchor:]
    return bytes(out)


# ---------------------------------------------------------------------------
# LZ4 safe decode
# ---------------------------------------------------------------------------

class MalformedBlock(ValueError):
    """The block is not a valid LZ4 block of at most the given size."""


def _len_ext(src: bytes, s: int, src_end: int, length: int):
    """A 0xFF-run length extension; a run cut off by the end adds 0xFF."""
    b = 0xFF
    while s < src_end:
        b = src[s]
        s += 1
        if b != 0xFF:
            break
        length += 0xFF
    return s, length + b


def decompress_safe(comp: bytes, out_max: int) -> bytes:
    """Decode one block of exactly ``len(comp)`` bytes into at most
    ``out_max`` bytes, with the safe decoder's end-of-block rules
    (``LZ4JavaSafeSafeDecompressor``): :class:`MalformedBlock` where it is
    not such a block. A match offset of 0 writes zeros, as every tier of
    the program does."""
    src_end = len(comp)
    if out_max == 0:
        if src_end == 1 and comp[0] == 0:
            return b""
        raise MalformedBlock("an empty block is one zero token")
    out = bytearray(out_max)
    s = d = 0
    while True:
        if s >= src_end:
            raise MalformedBlock("block ends inside a sequence")
        token = comp[s]
        s += 1
        lit_len = token >> ML_BITS
        if lit_len == RUN_MASK:
            s, lit_len = _len_ext(comp, s, src_end, lit_len)
        lit_end = d + lit_len
        if (lit_end > out_max - COPY_LENGTH
                or s + lit_len > src_end - COPY_LENGTH):
            # the last literals: they end the block and the output
            if lit_end > out_max or s + lit_len != src_end:
                raise MalformedBlock("last literals do not end the block")
            out[d:lit_end] = comp[s:src_end]
            return bytes(out[:lit_end])
        out[d:lit_end] = comp[s:s + lit_len]
        s += lit_len
        d = lit_end
        if s + 2 > src_end:
            raise MalformedBlock("offset runs past the block")
        dist = comp[s] | (comp[s + 1] << 8)
        s += 2
        m_len = token & ML_MASK
        if m_len == ML_MASK:
            s, m_len = _len_ext(comp, s, src_end, m_len)
        m_len += MIN_MATCH
        m_end = d + m_len
        if d - dist < 0 or m_end > out_max:
            raise MalformedBlock("match reaches outside the output")
        if dist == 0:
            out[d:m_end] = bytes(m_len)
        elif dist >= m_len:
            out[d:m_end] = out[d - dist:d - dist + m_len]
        else:
            period = bytes(out[d - dist:d])
            out[d:m_end] = (period * (m_len // dist + 1))[:m_len]
        d = m_end


# ---------------------------------------------------------------------------
# the frame body of independent blocks
# ---------------------------------------------------------------------------

def frame_body(raw: list[bytes], comp: list[bytes]) -> bytes:
    """The blocks of an LZ4 frame of independent blocks with no block
    checksum, header and end mark left out: each block a
    little-endian size word and its compressed bytes, or its raw bytes
    with ``INCOMPRESSIBLE_MASK`` set where compressing did not make it
    smaller; an empty block writes nothing."""
    parts = []
    for r, c in zip(raw, comp):
        if not r:
            continue
        if len(c) >= len(r):
            parts += [struct.pack("<I", len(r) | INCOMPRESSIBLE_MASK), r]
        else:
            parts += [struct.pack("<I", len(c)), c]
    return b"".join(parts)


def read_frame_body(body: bytes) -> list[tuple[bool, bytes]]:
    """The blocks of a frame body, as a frame reader walks them: each
    ``(stored raw, payload)``. :class:`MalformedBlock` where a size word
    is 0 (an end mark inside the body) or a payload runs past the end."""
    blocks, at = [], 0
    while at < len(body):
        if at + 4 > len(body):
            raise MalformedBlock("a size word cut off at the body's end")
        word = struct.unpack_from("<I", body, at)[0]
        size = word & ~INCOMPRESSIBLE_MASK
        if size == 0 or at + 4 + size > len(body):
            raise MalformedBlock(f"a block of size {size} at {at}")
        blocks.append((bool(word & INCOMPRESSIBLE_MASK),
                       body[at + 4:at + 4 + size]))
        at += 4 + size
    return blocks
