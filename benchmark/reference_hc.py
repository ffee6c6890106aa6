"""The plain reference of LZ4 HC: the greedy-lazy match optimizer with up
to three overlapping candidates and the chained-hash match finder, byte for
byte lz4-java's ``LZ4HCJavaSafeCompressor`` at levels 1..17 (the search
capped at ``max_attempts = 1 << (level - 1)``,
``compressor_hc.template:27``; ``compress_hc.template:17-162``,
``hashtable.template:23-161``).

A frozen copy, made for the benchmark, of the plain version that the
program's CPU tests hold its HC kernel against. It imports nothing but the
standard library and ``benchmark.reference``'s constants. It is slow
(seconds for 64 KiB of alphabet-4 data at level 9), so the benchmark runs
it on a sample of rows, in worker processes.
"""

from __future__ import annotations

import struct

from .reference import (
    HASH_MULT, LAST_LITERALS, MAX_DISTANCE, MF_LIMIT, MIN_MATCH, ML_BITS,
    ML_MASK, RUN_MASK, U32,
)

__all__ = ["compress_hc", "compress_hc_block"]

HASH_LOG_HC = 15
OPTIMAL_ML = ML_MASK - 1 + MIN_MATCH   # 18


class Lz4Error(RuntimeError):
    """The destination is too small."""


def hash_hc(v: int) -> int:
    return ((v * HASH_MULT) & U32) >> (32 - HASH_LOG_HC)


_U32 = struct.Struct("<I")
_MASK = MAX_DISTANCE - 1


def _common_bytes(buf, o1: int, o2: int, limit: int) -> int:
    """Length of the common prefix of buf[o1:] and buf[o2:], with o2 < limit.

    Chunked comparison for speed; exact same result as the byte loop in
    ``LZ4SafeUtils.commonBytes`` (LZ4SafeUtils.java:60-66).
    """
    count = 0
    # fast path: compare 64-byte chunks while they are fully in range
    step = 64
    while o2 + count + step <= limit and o1 + count + step <= o2 + count:
        # slices never overlap forward reads here only when o2-o1 >= step;
        # fall through to byte loop otherwise
        if bytes(buf[o1 + count:o1 + count + step]) != bytes(buf[o2 + count:o2 + count + step]):
            break
        count += step
    while o2 + count < limit and buf[o1 + count] == buf[o2 + count]:
        count += 1
    return count


def _common_bytes_backward(buf, o1: int, o2: int, l1: int, l2: int) -> int:
    count = 0
    while o1 - count > l1 and o2 - count > l2 and buf[o1 - count - 1] == buf[o2 - count - 1]:
        count += 1
    return count


def _write_len(length: int, dest, d_off: int) -> int:
    while length >= 0xFF:
        dest[d_off] = 0xFF
        d_off += 1
        length -= 0xFF
    dest[d_off] = length
    d_off += 1
    return d_off


def _last_literals(src, s_off: int, run_len: int, dest, d_off: int, dest_end: int) -> int:
    if d_off + run_len + 1 + (run_len + 255 - RUN_MASK) // 255 > dest_end:
        raise Lz4Error("maxDestLen is too small")
    if run_len >= RUN_MASK:
        dest[d_off] = RUN_MASK << ML_BITS
        d_off = _write_len(run_len - RUN_MASK, dest, d_off + 1)
    else:
        dest[d_off] = run_len << ML_BITS
        d_off += 1
    dest[d_off:d_off + run_len] = src[s_off:s_off + run_len]
    return d_off + run_len


def check_range(buf, off: int, length: int) -> None:
    if length < 0:
        raise ValueError("lengths must be >= 0")
    if length > 0 and (off < 0 or off + length > len(buf)):
        raise IndexError(f"range [{off}, {off + length}) out of bounds for length {len(buf)}")


class _Match:
    __slots__ = ("start", "ref", "len")

    def __init__(self):
        self.start = 0
        self.ref = 0
        self.len = 0

    def fix(self, correction: int) -> None:
        self.start += correction
        self.ref += correction
        self.len -= correction

    def end(self) -> int:
        return self.start + self.len

    def copy_from(self, other: "_Match") -> None:
        self.start = other.start
        self.ref = other.ref
        self.len = other.len


class _HashTable:
    """Chained match finder: head table + 16-bit chain-delta table.

    Mirrors ``hashtable.template:23-161``: ``hash_table`` maps a 4-byte hash
    to the most recent position, ``chain_table[pos & MASK]`` holds the
    distance to the previous position with the same hash (saturated at
    MAX_DISTANCE - 1).
    """

    __slots__ = ("base", "next_to_update", "hash_table", "chain_table", "max_attempts")

    def __init__(self, base: int, max_attempts: int):
        self.base = base
        self.next_to_update = base
        self.hash_table = [-1] * (1 << 15)
        self.chain_table = [0] * MAX_DISTANCE
        self.max_attempts = max_attempts

    def _hash_pointer(self, src, off: int) -> int:
        return self.hash_table[hash_hc(_U32.unpack_from(src, off)[0])]

    def _next(self, off: int) -> int:
        return off - self.chain_table[off & _MASK]

    def _add_hash(self, src, off: int) -> None:
        h = hash_hc(_U32.unpack_from(src, off)[0])
        delta = off - self.hash_table[h]
        if delta >= MAX_DISTANCE:
            delta = MAX_DISTANCE - 1
        self.chain_table[off & _MASK] = delta & 0xFFFF
        self.hash_table[h] = off

    def insert(self, off: int, src) -> None:
        while self.next_to_update < off:
            self._add_hash(src, self.next_to_update)
            self.next_to_update += 1

    def insert_and_find_best_match(self, src, off: int, match_limit: int, match: _Match) -> bool:
        match.start = off
        match.len = 0
        delta = 0
        repl = 0

        self.insert(off, src)
        ref = self._hash_pointer(src, off)

        if off - 4 <= ref <= off and ref >= self.base:  # potential repetition
            if src[ref:ref + 4] == src[off:off + 4]:
                delta = off - ref
                repl = match.len = MIN_MATCH + _common_bytes(
                    src, ref + MIN_MATCH, off + MIN_MATCH, match_limit)
                match.ref = ref
            ref = self._next(ref)

        lo = max(self.base, off - MAX_DISTANCE + 1)
        for _ in range(self.max_attempts):
            if ref < lo or ref > off:
                break
            if src[ref:ref + 4] == src[off:off + 4]:
                match_len = MIN_MATCH + _common_bytes(
                    src, ref + MIN_MATCH, off + MIN_MATCH, match_limit)
                if match_len > match.len:
                    match.ref = ref
                    match.len = match_len
            ref = self._next(ref)

        if repl != 0:
            # speed optimization of the reference: propagate the repetition
            # pattern through the chain table without re-hashing every byte
            ptr = off
            end = off + repl - (MIN_MATCH - 1)
            while ptr < end - delta:
                self.chain_table[ptr & _MASK] = delta & 0xFFFF  # pre-load
                ptr += 1
            while ptr < end:
                self.chain_table[ptr & _MASK] = delta & 0xFFFF
                self.hash_table[hash_hc(_U32.unpack_from(src, ptr)[0])] = ptr
                ptr += 1
            self.next_to_update = end

        return match.len != 0

    def insert_and_find_wider_match(self, src, off: int, start_limit: int,
                                    match_limit: int, min_len: int, match: _Match) -> bool:
        match.len = min_len

        self.insert(off, src)

        ref = self._hash_pointer(src, off)
        lo = max(self.base, off - MAX_DISTANCE + 1)
        for _ in range(self.max_attempts):
            if ref < lo or ref > off:
                break
            if src[ref:ref + 4] == src[off:off + 4]:
                match_len_forward = MIN_MATCH + _common_bytes(
                    src, ref + MIN_MATCH, off + MIN_MATCH, match_limit)
                match_len_backward = _common_bytes_backward(
                    src, ref, off, self.base, start_limit)
                match_len = match_len_backward + match_len_forward
                if match_len > match.len:
                    match.len = match_len
                    match.ref = ref - match_len_backward
                    match.start = off - match_len_backward
            ref = self._next(ref)

        return match.len > min_len


def _encode_sequence(src, anchor: int, match_off: int, match_ref: int,
                     match_len: int, dest, d_off: int, dest_end: int) -> int:
    """Emit one token + literals + offset + matchlen (LZ4SafeUtils.java:100-139)."""
    run_len = match_off - anchor
    token_off = d_off
    d_off += 1

    if d_off + run_len + (2 + 1 + LAST_LITERALS) + (run_len >> 8) > dest_end:
        raise Lz4Error("maxDestLen is too small")

    if run_len >= RUN_MASK:
        token = RUN_MASK << ML_BITS
        d_off = _write_len(run_len - RUN_MASK, dest, d_off)
    else:
        token = run_len << ML_BITS

    dest[d_off:d_off + run_len] = src[anchor:anchor + run_len]
    d_off += run_len

    match_dec = match_off - match_ref
    dest[d_off] = match_dec & 0xFF
    dest[d_off + 1] = (match_dec >> 8) & 0xFF
    d_off += 2

    match_len -= 4
    if d_off + (1 + LAST_LITERALS) + (match_len >> 8) > dest_end:
        raise Lz4Error("maxDestLen is too small")
    if match_len >= ML_MASK:
        token |= ML_MASK
        d_off = _write_len(match_len - RUN_MASK, dest, d_off)
    else:
        token |= match_len

    dest[token_off] = token
    return d_off


def compress_hc(src, src_off: int, src_len: int, dest, dest_off: int,
                max_dest_len: int, level: int = 9) -> int:
    """LZ4 HC block compression at the given level (1..17)."""
    if not 1 <= level <= 17:
        raise ValueError(f"level must be in [1, 17], got {level}")
    check_range(src, src_off, src_len)
    check_range(dest, dest_off, max_dest_len)

    src_end = src_off + src_len
    dest_end = dest_off + max_dest_len
    mf_limit = src_end - MF_LIMIT
    match_limit = src_end - LAST_LITERALS

    s_off = src_off
    d_off = dest_off
    anchor = s_off
    s_off += 1

    ht = _HashTable(src_off, 1 << (level - 1))
    match0 = _Match()
    match1 = _Match()
    match2 = _Match()
    match3 = _Match()

    while s_off < mf_limit:
        if not ht.insert_and_find_best_match(src, s_off, match_limit, match1):
            s_off += 1
            continue

        # stash the first candidate: the lazy search below may overshoot
        # and need to restore it
        match0.copy_from(match1)

        # --- search2 loop ---
        while True:
            assert match1.start >= anchor
            if (match1.end() >= mf_limit
                    or not ht.insert_and_find_wider_match(
                        src, match1.end() - 2, match1.start + 1,
                        match_limit, match1.len, match2)):
                # no better match: encode the single sequence
                d_off = _encode_sequence(src, anchor, match1.start, match1.ref,
                                         match1.len, dest, d_off, dest_end)
                anchor = s_off = match1.end()
                break  # continue main

            if match0.start < match1.start:
                # upstream HC's overshoot-restore heuristic; must be mirrored
                # exactly for byte-identical output
                if match2.start < match1.start + match0.len:
                    match1.copy_from(match0)
            assert match2.start > match1.start

            if match2.start - match1.start < 3:  # first match too small
                match1.copy_from(match2)
                continue  # search2

            # --- search3 loop ---
            exit_to = None
            while True:
                if match2.start - match1.start < OPTIMAL_ML:
                    new_match_len = min(match1.len, OPTIMAL_ML)
                    if match1.start + new_match_len > match2.end() - MIN_MATCH:
                        new_match_len = match2.start - match1.start + match2.len - MIN_MATCH
                    correction = new_match_len - (match2.start - match1.start)
                    if correction > 0:
                        match2.fix(correction)

                if (match2.start + match2.len >= mf_limit
                        or not ht.insert_and_find_wider_match(
                            src, match2.end() - 3, match2.start,
                            match_limit, match2.len, match3)):
                    # no better match: two sequences to encode
                    if match2.start < match1.end():
                        match1.len = match2.start - match1.start
                    d_off = _encode_sequence(src, anchor, match1.start, match1.ref,
                                             match1.len, dest, d_off, dest_end)
                    anchor = s_off = match1.end()
                    d_off = _encode_sequence(src, anchor, match2.start, match2.ref,
                                             match2.len, dest, d_off, dest_end)
                    anchor = s_off = match2.end()
                    exit_to = "main"
                    break

                if match3.start < match1.end() + 3:  # not enough space for match 2
                    if match3.start >= match1.end():
                        # can write seq1 immediately; seq2 removed, seq3 becomes seq1
                        if match2.start < match1.end():
                            correction = match1.end() - match2.start
                            match2.fix(correction)
                            if match2.len < MIN_MATCH:
                                match2.copy_from(match3)
                        d_off = _encode_sequence(src, anchor, match1.start, match1.ref,
                                                 match1.len, dest, d_off, dest_end)
                        anchor = s_off = match1.end()
                        match1.copy_from(match3)
                        match0.copy_from(match2)
                        exit_to = "search2"
                        break
                    match2.copy_from(match3)
                    continue  # search3

                # three ascending matches; write at least the first one
                if match2.start < match1.end():
                    if match2.start - match1.start < ML_MASK:
                        if match1.len > OPTIMAL_ML:
                            match1.len = OPTIMAL_ML
                        if match1.end() > match2.end() - MIN_MATCH:
                            match1.len = match2.end() - match1.start - MIN_MATCH
                        correction = match1.end() - match2.start
                        match2.fix(correction)
                    else:
                        match1.len = match2.start - match1.start

                d_off = _encode_sequence(src, anchor, match1.start, match1.ref,
                                         match1.len, dest, d_off, dest_end)
                anchor = s_off = match1.end()
                match1.copy_from(match2)
                match2.copy_from(match3)
                # continue search3

            if exit_to == "main":
                break
            # exit_to == "search2": loop again

    d_off = _last_literals(src, anchor, src_end - anchor, dest, d_off, dest_end)
    return d_off - dest_off


def compress_hc_block(src: bytes, level: int) -> bytes:
    """One block at ``level``, into a buffer that always fits it."""
    cap = len(src) + len(src) // 255 + 16
    dest = bytearray(cap)
    n = compress_hc(src, 0, len(src), dest, 0, cap, level)
    return bytes(dest[:n])
