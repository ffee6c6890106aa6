"""Seeded inputs that hold the kernels against their plain versions, and
the card scripts' timers.

Shared by the CPU tests, ``chip_smoke.py`` and ``design_variants.py``;
every generator takes a ``numpy.random.Generator``.
"""

from __future__ import annotations

import struct
import time

import numpy as np

from .formats.frame import (
    FrameFlag, INCOMPRESSIBLE_MASK, MAGIC, _flg_to_byte, xxh32_bytes)
from .kernels import block_stream as bs

KINDS = ("zeros", "period3", "alphabet4", "incompressible")
SHORT_CASES = ("periods", "dist_vs_len", "runs", "null", "ring_edge")
# The block decode's ring of recent output and the farthest match it
# serves (LZ4TT_RING, LZ4TT_RING_NEAR in csrc/lz4_decode.cuh).
RING = 4096
RING_NEAR = 3072


def block_of(rng: np.random.Generator, kind: str, size: int) -> bytes:
    if kind == "zeros":
        return bytes(size)
    if kind == "period3":
        return (b"abc" * (size // 3 + 1))[:size]
    if kind == "alphabet4":
        return rng.integers(0, 4, size, dtype=np.uint8).tobytes()
    if kind == "incompressible":
        return rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    if kind == "text":   # phrases of a small vocabulary
        words = [rng.integers(32, 127, int(k), dtype=np.uint8).tobytes()
                 for k in rng.integers(4, 48, 64)]
        return b"".join(words[int(i)] for i in
                        rng.integers(0, 64, size // 4 + 1))[:size]
    if kind == "period46":   # test_parallel_compress.py:43
        return (PHRASE * (size // len(PHRASE) + 1))[:size]
    if kind == "runs":       # a run of zeros, then one of ones (:52)
        return bytes(size * 3 // 4) + b"\x01" * (size - size * 3 // 4)
    raise ValueError(f"unknown kind {kind!r}")


def mixed_blocks(rng: np.random.Generator, sizes) -> list[bytes]:
    """One block of every kind at every size."""
    return [block_of(rng, kind, size) for size in sizes for kind in KINDS]


# The parallel compressor's (K7's) edge cases: every kind at the sizes
# about the format's end rules, a segment's and a window's length.
PHRASE = b"the quick brown fox jumps over the lazy dog. "
PARALLEL_KINDS = ("zeros", "alphabet4", "text", "incompressible", "period46",
                  "runs")
PARALLEL_SIZES = tuple(range(17)) + (511, 512, 513, 2047, 2048, 2049)
PARALLEL_BIG_SIZES = (65535, 65536, 65537)


def parallel_blocks(rng: np.random.Generator, sizes=PARALLEL_SIZES):
    """One block of every K7 kind at every size, and a block of 2 KiB of
    words FF FF FF 7F (the sort key of the positions past a block)."""
    return [block_of(rng, kind, size) for size in sizes
            for kind in PARALLEL_KINDS] + [b"\xff\xff\xff\x7f" * 512]


def window_clamp_blocks() -> list[bytes]:
    """Two blocks of 70,028 bytes (``test_parallel_compress.py:80``): 64
    random bytes repeated just outside the 65,536-byte window, and the same
    length with a repeat just inside it."""
    rng = np.random.default_rng(7)
    head = rng.integers(0, 256, 64, dtype=np.uint8).tobytes()
    mid = rng.integers(0, 256, 69_900, dtype=np.uint8).tobytes()
    base = head + mid
    return [base + head, base + base[-65_000:-65_000 + 64]]


def window_rows(rng: np.random.Generator, wl: int = 65536,
                windows: int = 3) -> list[bytes]:
    """Rows of ``windows`` windows of ``wl`` positions (K7's on the card,
    ``parallel_compress.WINDOW``, by default) and 17 bytes more for K7's
    window split: rows of noise with a run of period 1, 2, 3 or 4 (a
    random pattern repeated) across every window end; runs of mixed
    periods and lengths over noise; a text part, an incompressible stretch of
    several windows and a text part again (a literal run that spans
    windows); one repeated byte (one match sequence across the row); and
    rows of text, alphabet-4, runs and zeros a byte around one and two
    windows."""
    n = windows * wl + 17

    def rand(k):
        return rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()

    def run(period, k):
        return (rand(period) * (k // period + 1))[:k]

    rows = []
    for d in (1, 2, 3, 4):
        row = bytearray(rand(n))
        for e in range(wl, n, wl):
            a, b = max(0, e - int(rng.integers(20, 600))), \
                min(n, e + int(rng.integers(20, 600)))
            row[a:b] = run(d, b - a)
        rows.append(bytes(row))
    mixed = bytearray()
    while len(mixed) < n:
        mixed += (run(int(rng.integers(1, 5)), int(rng.integers(4, 3000)))
                  if rng.random() < 0.6 else rand(int(rng.integers(1, 200))))
    rows.append(bytes(mixed[:n]))
    third = n // 5
    rows.append(block_of(rng, "text", third) + rand(n - 2 * third)
                + block_of(rng, "text", third))
    rows.append(bytes([0x61]) * n)
    for size in (wl - 1, wl, wl + 1, 2 * wl - 1, 2 * wl + 1):
        rows += [block_of(rng, kind, size)
                 for kind in ("text", "alphabet4", "runs", "zeros")]
    return rows


# The kinds of data and the long block sizes HC is held at: its chains
# are longest on alphabet-4 data; past 65,536 bytes the chain slots
# (off & 0xFFFF) wrap and the MAX_DISTANCE window cuts the chains.
HC_KINDS = ("zeros", "alphabet4", "text", "incompressible")
HC_BIG_SIZES = (65536, 65547, 70000, 200 << 10)


def hc_edge_blocks(rng: np.random.Generator) -> list[bytes]:
    """Blocks at the edges of the HC compressor's encoding and match
    finder: a literal run of 14, 15, 269, 270 or 271 bytes before a match
    (the token's nibble, one and two extension bytes), matches of 18, 19,
    272, 273 and 274 bytes (OPTIMAL_ML, the extension bytes), runs of one
    byte (the repetition path and its chain propagation), periods 1-8,
    and blocks of 0 and 12 bytes (last literals only)."""
    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    out = [b"", rand(12)]
    for lit in (14, 15, 269, 270, 271):
        p = rand(16)
        out.append(p + p + rand(lit) + p + rand(16))
    for m in (18, 19, 272, 273, 274):
        a = rand(m)
        out.append(rand(8) + a + b"\x01" + rand(5) + a + b"\x02" + rand(16))
    for n in (4, 5, 16, 17, 300, 5000):
        out.append(rand(10) + bytes([7]) * n + rand(10))
    for period in range(1, 9):
        out.append(rand(5) + (rand(period) * (3000 // period + 1))[:3000]
                   + rand(20))
    return out


def hc_hash(words: np.ndarray) -> np.ndarray:
    """The HC match finder's 15-bit hash of little-endian 4-byte words."""
    return ((words.astype(np.uint64) * 2654435761) & 0xFFFFFFFF) >> 17


def _phase_words(patterns: np.ndarray) -> np.ndarray:
    """words[i, j]: the 4-byte word at phase j of pattern i repeated
    (patterns: uint8[n, period])."""
    period = patterns.shape[1]
    cols = (np.arange(period)[:, None] + np.arange(4)[None, :]) % period
    b = patterns[:, cols].astype(np.uint64)        # [n, period, 4]
    return (b[..., 0] | b[..., 1] << 8 | b[..., 2] << 16 | b[..., 3] << 24)


def hc_collision_patterns(rng: np.random.Generator) -> list[bytes]:
    """Periodic patterns whose runs make the HC chain leave its hash
    bucket's position order, found by a seeded brute-force search.

    For periods 3 and 4: exactly two phases' 4-byte words share a hash
    and the others do not, rotated to start on a phase of its own; in a
    run the repetition path writes the period as every chain delta, where
    the bucket holds the colliding phase nearer. Period 2 has no such
    pattern (no two phases of any of the 65,280 collide), so its pattern
    comes with a foreign word of the same hash as its first phase: the
    pattern, then that word, 6 bytes in all."""
    out = []
    while len(out) < 1:
        pat = rng.integers(0, 256, (1 << 16, 2), dtype=np.uint8)
        pat = pat[pat[:, 0] != pat[:, 1]]
        h = hc_hash(_phase_words(pat)[:, 0])
        words = rng.integers(0, 1 << 32, pat.shape[0], dtype=np.uint64)
        hit = np.nonzero(hc_hash(words) == h)[0]
        if hit.size:
            i = int(hit[0])
            out.append(pat[i].tobytes() + int(words[i]).to_bytes(4, "little"))
    for period in (3, 4):
        while True:
            pat = rng.integers(0, 256, (1 << 18, period), dtype=np.uint8)
            w = _phase_words(pat)
            h = hc_hash(w)
            same = (h[:, :, None] == h[:, None, :]).sum(axis=(1, 2)) - period
            distinct = np.array([len(set(r)) == period for r in w])
            hit = np.nonzero((same == 2) & distinct)[0]
            if hit.size:
                row, hrow = pat[int(hit[0])], h[int(hit[0])]
                alone = [j for j in range(period)
                         if (hrow == hrow[j]).sum() == 1][0]
                out.append(np.roll(row, -alone).tobytes())
                break
    return out


def hc_collision_blocks(rng: np.random.Generator) -> list[bytes]:
    """Blocks on which K6's speculated chain walk must fail and follow the
    true chain (``hc_collision_patterns``), and a bucket whose predecessor
    lies more than 65,535 positions back.

    Each period's runs come at every rotation in a 1,000-byte block, at
    the start, the middle and the end of a 65,536-byte block, and at the
    start, the middle and past 65,536 bytes of a 70,000-byte block; the
    period-2 runs are followed by their colliding word. The rest is
    random bytes."""
    def rand(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def run(pat, n, rot=0):
        body = pat[:2] if len(pat) == 6 else pat   # period 2: its word
        body = body[rot % len(body):] + body[:rot % len(body)]
        tail = pat[2:] if len(pat) == 6 else b""
        return (body * (n // len(body) + 1))[:n] + tail

    def place(size, at, parts):
        buf = bytearray(rand(size))
        for pos, part in zip(at, parts):
            buf[pos:pos + len(part)] = part
        return bytes(buf[:size])

    pats = hc_collision_patterns(rng)
    out = []
    for pat in pats:
        period = 2 if len(pat) == 6 else len(pat)
        out.append(place(1000, [30 + 240 * r for r in range(period)],
                         [run(pat, 200, r) for r in range(period)]))
    runs = b"".join(run(pat, 700) + rand(9) for pat in pats)
    out.append(place(65536, [0, 32000, 65536 - len(runs)], [runs] * 3))
    out.append(place(70000, [0, 33000, 66000], [runs] * 3))
    # a word at 100 and again 66,000 and 66,010 bytes later, with no other
    # position of its hash between: the insert's delta is capped at 65,535
    size, marks = 80000, (100, 66100, 66110)
    buf = np.frombuffer(bytearray(rand(size)), np.uint8).copy()
    word = rand(4)
    target = int(hc_hash(np.array([int.from_bytes(word, "little")]))[0])
    while True:
        for m in marks:
            buf[m:m + 4] = np.frombuffer(word, np.uint8)
        b = buf.astype(np.uint64)
        w = b[:-3] | b[1:-2] << 8 | b[2:-1] << 16 | b[3:] << 24
        bad = [int(i) for i in np.nonzero(hc_hash(w) == target)[0]
               if int(i) not in marks]
        if not bad:
            break
        for i in bad:
            buf[i] = rng.integers(0, 256)
    out.append(buf.tobytes())
    return out


def fuzz_blocks(rng: np.random.Generator, comp_blocks: list[bytes],
                n: int) -> list[bytes]:
    """``n`` malformed variants of valid compressed blocks: bit flips,
    truncations, overwritten runs, and streams of random tokens."""
    out = []
    sources = [c for c in comp_blocks if c]
    for i in range(n):
        base = bytearray(sources[int(rng.integers(len(sources)))])
        op = i % 4
        if op == 0:
            for _ in range(int(rng.integers(1, 5))):
                pos = int(rng.integers(len(base)))
                base[pos] ^= 1 << int(rng.integers(8))
        elif op == 1:
            base = base[:int(rng.integers(len(base) + 1))]
        elif op == 2:
            pos = int(rng.integers(len(base)))
            run = rng.integers(0, 256, int(rng.integers(1, 9)), dtype=np.uint8)
            base[pos:pos + run.size] = run.tobytes()
        else:
            base = bytearray(rng.integers(
                0, 256, int(rng.integers(1, 65)), dtype=np.uint8).tobytes())
        out.append(bytes(base))
    return out


def boundary_blocks() -> list[bytes]:
    """Hand-built compressed blocks at the bounds of the decoders and the
    parser: a null match offset (its bytes decode as zeros), a match
    reaching exactly the output start (valid) and one byte before it
    (malformed), and a match length cut off by the end (malformed)."""
    return [bytes([0x10, 42, 0, 0, 0x80]) + b"*" * 8,   # b"*" + 4 zeros + 8 "*"
            bytes([0x10, 65, 1, 0, 0x50]) + b"BBBBB",    # b"AAAAABBBBB"
            bytes([0x10, 65, 2, 0, 0x50]) + b"BBBBB",
            bytes([0x1F, 65, 1, 0]) + b"\xff" * 3]


def encode_block(seqs, tail: bytes) -> bytes:
    """An LZ4 block of ``(literals, dist, match_len)`` sequences and the
    last literals."""
    out = bytearray()

    def ext(n):
        while n >= 255:
            out.append(255)
            n -= 255
        out.append(n)

    for lit, dist, ml in seqs:
        out.append((min(len(lit), 15) << 4) | min(ml - 4, 15))
        if len(lit) >= 15:
            ext(len(lit) - 15)
        out.extend(lit)
        out.extend((dist & 0xFF, dist >> 8))
        if ml - 4 >= 15:
            ext(ml - 19)
    out.append(min(len(tail), 15) << 4)
    if len(tail) >= 15:
        ext(len(tail) - 15)
    return bytes(out + tail)


def expand_block(seqs, tail: bytes, hist: bytes = b"") -> bytes:
    """What ``encode_block``'s block decodes to after the output ``hist``
    (which its matches may reach into); a null offset writes zeros."""
    out = bytearray(hist)
    for lit, dist, ml in seqs:
        out += lit
        if not dist:
            out += bytes(ml)
            continue
        if dist > len(out):
            raise IndexError("a match reaches before the history")
        src = out[len(out) - dist:len(out) - dist + ml]
        out += (src * (ml // dist + 1))[:ml]   # a period of dist bytes
    return bytes(out[len(hist):] + tail)


def chain_blocks(rng: np.random.Generator):
    """``(compressed, decoded)`` blocks whose matches copy matches, for the
    gather decode's rounds: a chain of 8-byte copies at distance 8 (byte p
    is p // 8 - 1 copies from its literal), runs at distance 1 and
    periodic overlaps copied again, and random sequences of short literals
    and matches reaching up to 300 bytes back (often past their own
    start)."""
    def rand(n):
        return rng.integers(0, 256, int(n), dtype=np.uint8).tobytes()

    cases = [[(rand(8), 8, 8)] + [(b"", 8, 8)] * 40,
             [(rand(1), 1, 1000), (rand(3), 3, 60), (b"", 500, 700),
              (rand(2), 61, 200), (b"", 1, 37)]]
    seqs, total = [], 0
    for k in range(300):
        lit = rand(16 if k == 0 else rng.integers(0, 3))
        total += len(lit)
        dist = int(rng.integers(1, min(total, 300) + 1))
        ml = int(rng.integers(4, 40))
        seqs.append((lit, dist, ml))
        total += ml
    cases.append(seqs)
    out = []
    for c in cases:
        tail = rand(5)
        out.append((encode_block(c, tail), expand_block(c, tail)))
    return out


def link_tables(out_len: int = 40, width: int = 48):
    """Sequence tables (``gather_decode`` order: lit_out, lit_src, lit_len,
    m_out, m_dist, m_len; int32[6, N, width], sentinel tails) and
    compressed rows (uint8[N, 64]) for the gather decode's rounds at
    exactly 2^k - 1 and 2^k links (max_depth k resolves the first, not the
    second) and for pointers the tables make outside a row of ``out_len``
    bytes: row 0 is a literal and one-byte matches at distance 1 (byte j
    is j links from it); row 1 two literals and
    two-byte matches at distance 2 (bytes 2k and 2k + 1 are k links from
    them); row 2 a match at the row's start whose parents wrap
    to its end (forward pointers to literals); row 3 two matches whose
    parents point at each other (a cycle) and a match into the cycle and
    bytes no sequence writes; row 4 a self-parent byte, a null offset and a
    match whose chains end in its zeros."""
    S = 1 << 30
    rows = [
        [(0, 0, 1, 1, 1, 1)] + [(j, 0, 0, j, 1, 1)
                                for j in range(2, out_len)],
        [(0, 0, 2, 2, 2, 2)] + [(j, 0, 0, j, 2, 2)
                                for j in range(4, out_len, 2)],
        [(0, 0, 0, 0, 3, 6), (6, 1, out_len - 6, S, 0, 0)],
        [(0, 0, 0, 0, out_len - 12, 4), (12, 0, 0, 12, 12, 4),
         (16, 2, 4, 20, 10, 6)],
        [(0, 5, 0, 0, out_len, 1), (1, 7, 2, 3, 0, 3), (6, 0, 0, 6, 4, 20)],
    ]
    tables = np.zeros((6, len(rows), width), np.int32)
    tables[0] = tables[3] = S
    for i, seqs in enumerate(rows):
        for k, seq in enumerate(seqs):
            tables[:, i, k] = seq
    comp = (np.arange(64 * len(rows)) * 7 + 1).astype(np.uint8)
    return tables, comp.reshape(len(rows), 64)


# The history lengths the window decode and the dictionary compress are
# held at: none, a byte, a word, around the hash table's span and the
# format's 64 KiB window.
HIST_LENS = (0, 1, 4, 4095, 65535, 65536)


def history_blocks(rng: np.random.Generator):
    """``(hist, sequences, tail)`` blocks whose matches reach into a history
    of each of ``HIST_LENS`` bytes (``encode_block`` makes the block,
    ``expand_block(..., hist)`` its bytes): matches at the history's first
    byte, matches that straddle the history's end and the row, periods
    1-40 repeated from the history's tail (short and team-long), sources
    in the history within the decode's ring (``RING_NEAR``) and past it
    after output of every length around it, and null offsets."""
    def rb(n, k=256):
        return rng.integers(0, k, n, dtype=np.uint8).tobytes()

    out = []
    for hl in HIST_LENS:
        hist = rb(hl, 8)
        tail = rb(8)
        if hl:
            out.append((hist, [(b"", min(hl, 65535), 4),
                               (rb(3), min(hl + 7, 65535), 20)], tail))
            for back in (1, 3, 16):     # straddling the history's end
                if back <= hl:
                    out.append((hist, [(rb(2), back + 2, n)
                                       for n in (back + 4, 40, 100)], tail))
            out.append((hist, [(b"", p, n) for p in range(1, min(hl, 40) + 1)
                               for n in (4, 17, 70)][:60], tail))
        for lead in (0, 1000, RING_NEAR - 5, RING + 7):
            seqs, pos = [(rb(lead + 1), 1, 4)], lead + 5
            for d in (pos + 1, RING_NEAR - 1, RING_NEAR, RING_NEAR + 1, RING,
                      RING + 1, 9000, 65535):
                for n in (4, 13, 70):
                    if pos < d <= pos + hl and d <= 65535:
                        seqs.append((b"", d, n))
                        pos += n
            if len(seqs) > 1:
                out.append((hist, seqs, tail))
        out.append((hist, [(rb(5), 0, 4), (b"", 0, 100), (rb(2), 3, 4)], tail))
    return out


def overreach_blocks(rng: np.random.Generator):
    """``(hist, block)``: for each of ``HIST_LENS`` below 65,535, a block
    whose match reaches one byte before its history (malformed), after
    literals and after a valid match into the history."""
    def rb(n, k=256):
        return rng.integers(0, k, n, dtype=np.uint8).tobytes()

    out = []
    for hl in HIST_LENS[:-2]:
        out.append((rb(hl, 8), encode_block([(rb(3), hl + 4, 4)], rb(8))))
        if hl:
            out.append((rb(hl, 8), encode_block(
                [(b"", hl, 4), (b"", hl + 5, 4)], rb(8))))
    return out


def short_sequence_blocks(case: str, rng: np.random.Generator):
    """``(sequences, tail)`` blocks of one of ``SHORT_CASES`` for the block
    decode's one-lane copies (literal runs and matches of at most 64 bytes,
    written into its ring of recent output) and its team copies (longer
    ones); ``encode_block`` makes them blocks."""
    def rb(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    tail = rb(8)
    if case == "periods":          # overlapping matches, periods 1-40
        return [([(rb(p), p, 4)]
                 + [(b"", p, n) for n in (7, 16, 17, 40, 100)], tail)
                for p in range(1, 41)]
    if case == "dist_vs_len":      # dist one below, equal to, one above len
        return [([(rb(40), d, n)], tail)
                for n in (4, 5, 8, 15, 16, 17, 31, 32, 33)
                for d in (n - 1, n, n + 1)]
    if case == "runs":             # literal runs and matches about 16, 32, 64
        sizes = (15, 16, 17, 31, 32, 33, 63, 64, 65)
        return ([([(rb(n), 9, 4), (rb(3), 20, n)], rb(n)) for n in sizes]
                + [([(rb(40), 33, 4), (b"", 33, n), (rb(n), 1, n)], tail)
                   for n in sizes])
    if case == "null":             # null offsets, short and long
        return [([(rb(5), 0, n), (rb(2), 3, 4), (b"", 0, n)], tail)
                for n in (4, 5, 16, 17, 40, 65, 100)]
    # the ring's edge: a long literal run, then short sequences across
    # several write-outs, then one match at the farthest distance the ring
    # serves and past it, short and long
    blocks = []
    for dist in (RING_NEAR - 1, RING_NEAR, RING_NEAR + 1, RING - 1, RING,
                 RING + 1, RING + 16, 9000):
        for n in (4, 13, 16, 17):
            seqs = [(rb(5000), 7, 4)]
            seqs += [(rb(int(rng.integers(0, 4))), int(rng.integers(1, 3000)),
                      int(rng.integers(4, 17))) for _ in range(700)]
            blocks.append((seqs + [(b"", dist, n), (rb(1), dist, n)], tail))
    return blocks


# the most output a row of the CTA-a-row decode keeps (LZ4TT_WHOLE)
WHOLE = 1 << 16
# distances at the ring's edges and beyond it, for far_match_blocks
FAR_DISTS = (RING_NEAR - 1, RING_NEAR, RING_NEAR + 1, RING - 1, RING,
             RING + 1, 32768)


def far_match_blocks(rng: np.random.Generator):
    """``(sequences, tail)`` blocks of at most :data:`WHOLE` bytes out whose
    matches reach far back: after a long literal run and short sequences,
    matches at each of :data:`FAR_DISTS`, short (one lane's copy) and long
    (the team's); then 64 KiB blocks whose last match copies from the
    first byte, 65,524 and 65,527 bytes back, one of long
    matches 31,000-54,500 back, and one that a match 65,535 back takes past
    64 KiB (65,547 bytes out)."""
    def rb(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    blocks = []
    for dist in FAR_DISTS:
        for n in (4, 17, 64, 100):
            seqs = [(rb(40000), 7, 4)]
            seqs += [(rb(int(rng.integers(0, 4))), int(rng.integers(1, 3000)),
                      int(rng.integers(4, 17))) for _ in range(300)]
            blocks.append((seqs + [(b"", dist, n), (rb(1), dist, n)], rb(8)))
    blocks.append(([(rb(WHOLE - 12), WHOLE - 12, 4)], rb(8)))
    # the last 5 bytes are literals, so a match starts at most 9 bytes
    # before the end: 65,527 back is the farthest
    blocks.append(([(rb(WHOLE - 33), 1, 4)] + [(b"", 1, 4)] * 5
                   + [(b"", WHOLE - 9, 4)], rb(5)))
    blocks.append(([(rb(32000), 31000, 1000), (rb(20000), 52000, 500),
                    (rb(1000), 54500, 11000)], rb(36)))
    blocks.append(([(rb(WHOLE - 1), WHOLE - 1, 4)], rb(8)))  # 65,547 B out
    return blocks


def run_block(n_run: int, bad_at: int | None = None,
              tail: bytes | None = b"tail!", lits: int = 0,
              mls: int = 15) -> bytes:
    """A block for the parser's runs and chains: one sequence with 8
    literals, then ``n_run`` sequences (with ``lits`` 0, no literals: 3
    bytes each; else 1 to ``lits`` literals; matches of 4 to ``mls`` + 3
    bytes, offsets 1-8, a null offset every 16), the one at ``bad_at``
    with an offset past the output start, then the last literals
    ``tail``; with ``tail=None`` the block ends on the last of those
    sequences."""
    seqs = [(b"12345678", 1, 4)]
    for i in range(n_run):
        dist = 0xFFFF if i == bad_at else (0 if i % 16 == 7 else 1 + i % 8)
        seqs.append((b"x" * (1 + i % lits if lits else 0), dist, 4 + i % mls))
    blk = encode_block(seqs, tail or b"")
    return blk[:-1] if tail is None else blk


# where RUN_BLOCKS put a malformed offset: in runs of 3-byte sequences,
# lanes 0, 1 and 31 of a 32-lane step, lanes 0 and 1 of the next, lane 31
# of that; in chains of sequences with literals, the 1st, 2nd, 3rd, 6th
# and 32nd, with and without length-extension bytes
RUN_BAD_AT = (0, 1, 31, 32, 33, 63)
CHAIN_BAD_AT = (0, 1, 2, 5, 31)
RUN_MALFORMED = 23      # the malformed rows, first in run_blocks()


def run_blocks() -> list[bytes]:
    """Blocks at the edges of the parser's runs and chains: a malformed
    offset at ``RUN_BAD_AT`` and ``CHAIN_BAD_AT``, runs and chains that end
    exactly at the block end with no last literals (malformed too); then
    runs and chains closed by empty and by 5 last literals, three blocks
    of runs broken at every distance from the window's refills
    (``broken_runs_block``), and last a run of 102 sequences for narrow
    table widths."""
    blocks = [run_block(80, bad_at=j) for j in RUN_BAD_AT]
    blocks += [run_block(80, bad_at=j, lits=14) for j in CHAIN_BAD_AT]
    blocks += [run_block(80, bad_at=j, lits=20, mls=40) for j in CHAIN_BAD_AT]
    blocks += [run_block(n, tail=None) for n in (31, 32, 33, 64)]
    blocks += [run_block(n, tail=None, lits=14) for n in (1, 2, 5)]
    blocks += [run_block(n, tail=t) for n in (0, 31, 32, 33)
               for t in (b"", b"tail!")]
    blocks += [run_block(n, tail=t, lits=14) for n in (1, 5, 40)
               for t in (b"", b"tail!")]
    blocks += [run_block(60, lits=20, mls=40), run_block(60, lits=30, mls=300)]
    # extensions of two bytes and more, literals past the window
    blocks += [encode_block([(b"12345678", 1, 4), (b"y" * 300, 5, 4),
                             (b"", 3, 300), (b"z" * 200, 7, 30),
                             (b"", 2, 4), (b"w" * 16, 9, 19)], b"end")]
    rng = np.random.default_rng(7)
    blocks += [broken_runs_block(rng) for _ in range(3)]
    blocks += [run_block(100)]
    return blocks


def broken_runs_block(rng: np.random.Generator, size: int = 60000) -> bytes:
    """A block of runs of 1-40 3-byte sequences, each broken by a sequence
    with 16-30 literals and a match of 19-60 bytes (one length-extension
    byte each), about ``size`` bytes: the breaks fall at every distance
    from the parser's window refills."""
    seqs, n, d = [(b"12345678", 1, 4)], 12, 12
    while n < size:
        for _ in range(int(rng.integers(1, 41))):
            ml = int(rng.integers(4, 19))
            seqs.append((b"", int(rng.integers(1, min(d, 65535) + 1)), ml))
            n, d = n + 3, d + ml
        lit = bytes(rng.integers(0, 256, int(rng.integers(16, 31)),
                                 dtype=np.uint8))
        ml = int(rng.integers(19, 61))
        seqs.append((lit, int(rng.integers(1, min(d + len(lit), 65535) + 1)),
                     ml))
        n, d = n + len(lit) + 5, d + len(lit) + ml
    return encode_block(seqs, b"tail!")


def pack_cases() -> list[tuple[int, int]]:
    """``(lens, comp_lens)`` of rows for frame-body packing: 16 blocks
    each of payloads of 13, 173, 653 and 4109 bytes, which emit 1 more
    than a multiple of 16, so that their destinations take every
    misalignment 0-15 in turn; payloads of 0-40 bytes, compressed and
    raw; payloads around multiples of 16 up to 4096; ``comp_lens ==
    lens`` and ``comp_lens > lens`` (raw by the ``>=`` rule); ``lens ==
    0`` padding rows; rows of 65,547 bytes. Rows of 70,000 bytes hold
    every payload."""
    cases = [(70000, p) for p in (13, 173, 653, 4109) for _ in range(16)]
    cases += [(1000, p) for p in range(41)]
    cases += [(n, n + r) for n in range(1, 41) for r in (0, 3)]
    for m in (16, 32, 48, 64, 128, 256, 512, 1024, 2048, 4096):
        cases += [(5000, m + r) for r in (-1, 0, 1)]
        cases += [(m + r, m + r) for r in (-1, 0, 1)]
    cases += [(0, 7), (0, 0), (0, 65547)]
    cases += [(65547, 65547), (65547, 65546), (65547, 70000), (65547, 13)]
    return cases


def build_frame(raws, comps, bd: int = 4, block_checksum: bool = True,
                content_checksum: bool = True,
                independent: bool = True, sums=None,
                content_sum: int | None = None) -> bytes:
    """An LZ4 frame of independent blocks, written by hand: block i is
    ``comps[i]`` when that is shorter than ``raws[i]``, else ``raws[i]``
    stored raw, in any mix of sizes (short blocks anywhere in the frame,
    as other writers emit them); ``bd`` is the block-size indicator
    (4: 64 KiB); block and content checksums as asked, hashed on the
    host unless given (``sums``, one a block, and ``content_sum``). With
    ``independent`` off the FLG byte says the blocks are linked (for
    blocks from :func:`linked_blocks`)."""
    flags = {FrameFlag.BLOCK_INDEPENDENCE} if independent else set()
    if block_checksum:
        flags.add(FrameFlag.BLOCK_CHECKSUM)
    if content_checksum:
        flags.add(FrameFlag.CONTENT_CHECKSUM)
    desc = bytes([_flg_to_byte(frozenset(flags)), (bd & 7) << 4])
    out = [struct.pack("<I", MAGIC), desc,
           bytes([(xxh32_bytes(desc) >> 8) & 0xFF])]
    for i, (raw, comp) in enumerate(zip(raws, comps)):
        if len(comp) < len(raw):
            out += [struct.pack("<I", len(comp)), comp]
        else:
            out += [struct.pack("<I", len(raw) | INCOMPRESSIBLE_MASK), raw]
        if block_checksum:
            out.append(struct.pack("<I", xxh32_bytes(out[-1]) if sums is None
                                   else sums[i]))
    out.append(struct.pack("<I", 0))
    if content_checksum:
        out.append(struct.pack("<I", xxh32_bytes(b"".join(raws))
                               if content_sum is None else content_sum))
    return b"".join(out)


def payloads(raws, comps) -> list:
    """What a frame stores for each block: ``comps[i]`` when shorter than
    ``raws[i]``, else ``raws[i]``."""
    return [c if len(c) < len(r) else r for r, c in zip(raws, comps)]


def windows(hists, device):
    """Each history (or dictionary) right-aligned in its row of a
    ``uint8[N, W]`` tensor on ``device`` (W at least 1), and their lengths
    as ``int32[N]``: the window kernels' arguments."""
    import torch

    width = max(1, max(map(len, hists), default=0))
    win = torch.zeros((len(hists), width), dtype=torch.uint8)
    for i, h in enumerate(hists):
        if h:
            win[i, width - len(h):] = torch.frombuffer(bytearray(h),
                                                       dtype=torch.uint8)
    lens = torch.tensor([len(h) for h in hists], dtype=torch.int32)
    return win.to(device), lens.to(device)


# A row's stated length outside [0, S], S the row stride of the compressed
# batch: just below, just past, and the largest int32. K1 makes each the
# row's ERR_MALFORMED (csrc/lz4_decode.cuh, lz4tt_decode_row).
BAD_LENGTHS = {"minus1": lambda s: -1, "past_row": lambda s: s + 1,
               "int32_max": lambda s: (1 << 31) - 1}
# K1's three wrappers, by the contract each keeps
DECODERS = ("safe", "fast", "hist")
# the history of every row of the "hist" wrapper: one shared row
DECODE_HIST = 64


def length_batch(rng: np.random.Generator, device, size: int = 1000):
    """Two blocks of every kind at ``size`` bytes, compressed by K2 (or
    its plain version) on ``device``: ``(comp, comp_lens, size)``, every
    row of which decodes to ``size`` bytes."""
    from .core.constants import max_compressed_length
    from .kernels import codec, layout

    src, lens = layout.to_device_layout(mixed_blocks(rng, (size, size)),
                                        device=device)
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(size))
    return comp, comp_lens, size


def decode_with(name: str, comp, lens, cap: int, out=None):
    """K1 through its wrapper ``name`` (one of :data:`DECODERS`): ``cap``
    is the capacity (safe, hist) or the exact decoded length (fast);
    "hist" decodes every row after the same :data:`DECODE_HIST` bytes of
    history. Returns the wrapper's ``(out, lengths, err)``."""
    import torch

    from .kernels import codec

    if name == "safe":
        return codec.decompress_safe_batch(comp, lens, cap, out=out)
    if name == "fast":
        return codec.decompress_fast_batch(comp, lens, cap, out=out)
    hist = torch.arange(DECODE_HIST, dtype=torch.uint8,
                        device=comp.device).view(1, -1)
    hist_lens = torch.full(lens.shape, DECODE_HIST, dtype=torch.int32,
                           device=comp.device)
    return codec.decompress_safe_hist_batch(comp, lens, cap, hist, hist_lens,
                                            out=out)


def ragged_sizes(rng: np.random.Generator, n: int,
                 block_size: int = 1 << 16) -> list[int]:
    """Sizes of ``n`` frame blocks of ``block_size``: full blocks with
    short ones among them, of 1 to 64 bytes and of a random length below
    the block size, none a multiple of 16, so that a batch's output
    leaves a remainder for the content hash."""
    sizes = []
    for i in range(n):
        kind = i % 5
        if kind in (0, 2):
            sizes.append(block_size)
        elif kind == 1:
            sizes.append(int(rng.integers(1, 65)) | 1)
        else:
            sizes.append(int(rng.integers(16, block_size - 16)) | 1)
    return sizes


def linked_blocks(raw: bytes, block_size: int, device) -> list[bytes]:
    """The blocks of a linked-block frame (``lz4 -BD``) of ``raw`` at
    ``block_size``, compressed as LZ4F's linked mode compresses them: block
    i against the up to 64 KiB of content before it, in one launch of the
    fast scan with a dictionary (``codec.compress_dict_batch``), whose
    dictionaries are a strided view of the content itself. A test helper:
    neither package has a linked-frame writer."""
    import torch

    from .core.constants import max_compressed_length
    from .kernels import codec, layout

    n = -(-len(raw) // block_size)
    if not n:
        return []
    win = codec.WINDOW
    buf = torch.zeros((win + n * block_size,), dtype=torch.uint8)
    buf[win:win + len(raw)] = torch.frombuffer(bytearray(raw),
                                               dtype=torch.uint8)
    buf = buf.to(device)
    src = buf[win:].view(n, block_size)
    dicts = buf.as_strided((n, win), (block_size, 1))  # row i ends at block i
    starts = [i * block_size for i in range(n)]
    lens = torch.tensor([min(block_size, len(raw) - s) for s in starts],
                        dtype=torch.int32, device=device)
    dict_lens = torch.tensor([min(s, win) for s in starts], dtype=torch.int32,
                             device=device)
    comp, comp_lens, err = codec.compress_dict_batch(
        src, lens, max_compressed_length(block_size), dicts, dict_lens)
    if bool(err.any()):
        raise RuntimeError("a linked block failed to compress")
    return layout.from_device_layout(comp, comp_lens)


RESOLVE_CASES = ("chains", "short_blocks", "window_only", "null_seam",
                 "long_record", "big_block", "n_ok")


def resolve_case(case: str, rng: np.random.Generator):
    """A batch of linked blocks for the resolve (``kernels/linked_decode``)
    whose bytes cross its segments' and tiles' seams in one way each:
    ``(window, raws, comps, dest_cap, n_ok)``, the blocks ``comps[i]``
    (compressed, or ``raws[i]`` itself: stored raw) after ``window``, their
    content ``raws``, and the blocks that decode (``n_ok``):

    - ``chains``: matches of distance 1-3 and 4-300 bytes, most without
      literals, over 200 KiB in four blocks;
    - ``short_blocks``: 256 blocks of 20-200 bytes, each starting with a
      match into the block before (or further back);
    - ``window_only``: every match's source in a 64 KiB window (the
      last literals of each block aside);
    - ``null_seam``: null offsets (zeros) of 1-3,000 bytes, and matches
      copying them, over 48 KiB;
    - ``long_record``: a literal run of 40,000 bytes, matches of 50,000
      and 70,000 bytes (distances 1 and 30,000) in a 4 MiB block;
    - ``big_block``: a 4 MiB block of matches of 100-30,000 bytes at
      distances up to 65,535 (the window's 64 KiB first), cut mid-match by
      every segment size;
    - ``n_ok``: six blocks, the fourth reaching before its history (the
      batch decodes three).
    """
    def rb(n, k=256):
        return rng.integers(0, k, int(n), dtype=np.uint8).tobytes()

    def frame(window, blocks, dest_cap, n_ok=None):
        raws, comps, hist = [], [], window
        for seqs, tail in blocks:
            raws.append(expand_block(seqs, tail, hist[-65536:]))
            comps.append(encode_block(seqs, tail))
            hist += raws[-1]
        return (window, raws, comps, dest_cap,
                len(blocks) if n_ok is None else n_ok)

    if case == "chains":
        blocks = []
        for b in range(4):
            seqs, n = [(rb(3), 1, 4)] if b == 0 else [], 0
            while n < 50000:
                lit = rb(int(rng.integers(0, 4))) if rng.random() < 0.2 else b""
                seqs.append((lit, int(rng.integers(1, 4)),
                             int(rng.integers(4, 301))))
                n += len(lit) + seqs[-1][2]
            blocks.append((seqs, rb(6)))
        return frame(b"", blocks, 1 << 16)
    if case == "short_blocks":
        blocks, total = [([], rb(100))], 100
        for _ in range(255):
            n = int(rng.integers(20, 201))
            dist = int(rng.integers(1, min(total, 400) + 1))
            ml = int(rng.integers(4, max(5, n - 6)))
            blocks.append(([(b"", dist, ml)], rb(max(0, n - ml))))
            total += ml + max(0, n - ml)
        return frame(b"", blocks, 256)
    if case == "window_only":
        w = 65536
        blocks, pos = [], w
        for _ in range(4):
            seqs, n = [], 0
            while n < 12000:
                ml = int(rng.integers(4, 600))
                src = int(rng.integers(max(0, pos + n - 65535), w - ml))
                seqs.append((b"", pos + n - src, ml))
                n += ml
            blocks.append((seqs, rb(10)))
            pos += n + 10
        return frame(rb(w), blocks, 1 << 16)
    if case == "null_seam":
        blocks = []
        for b in range(3):
            seqs, n = [], 0
            while n < 16000:
                ml = int(rng.integers(1, 3001)) + 4
                d = 0 if rng.random() < 0.5 else int(rng.integers(1, n + 2))
                lit = rb(int(rng.integers(0, 3))) if d > n else b""
                if d > n + len(lit):
                    d = 0
                seqs.append((lit, d, ml))
                n += len(lit) + ml
            blocks.append((seqs, rb(5)))
        return frame(b"", blocks, 1 << 16)
    if case == "long_record":
        seqs = [(rb(40000), 1, 50000), (rb(7), 30000, 70000),
                (b"", 3, 20000)]
        return frame(b"", [(seqs, rb(40000))], 4 << 20)
    if case == "big_block":
        return far_match_frame(rng, 1)
    if case == "n_ok":
        # blocks 1 and 2 take 51 bytes each; block 3's match reaches one
        # byte before the frame (its raw is a stand-in of its length)
        good = frame(b"", [([], rb(300))] + [
            ([(rb(2), int(rng.integers(1, 250)), 40)], rb(9))
            for _ in range(4)], 1 << 16)
        bad = ([(rb(2), 2 + 300 + 2 * 51 + 1, 8)], rb(9))
        raws, comps = list(good[1]), list(good[2])
        raws.insert(3, bytes(19))
        comps.insert(3, encode_block(*bad))
        return b"", raws, comps, 1 << 16, 3
    raise ValueError(f"no resolve case {case!r}")


def far_match_frame(rng: np.random.Generator, n_blocks: int):
    """``n_blocks`` linked blocks of 4 MiB after a 64 KiB window (bytes of
    an alphabet of 16), each of matches of 100-30,000 bytes at distances
    up to 65,535 behind 0-20 literals, so that most of its bytes are open
    exits of the resolve's segments: ``resolve_case``'s ``(window, raws,
    comps, dest_cap, n_ok)``."""
    window = rng.integers(0, 16, 65536, dtype=np.uint8).tobytes()
    raws, comps, hist = [], [], window
    for _ in range(n_blocks):
        seqs, n = [], 0
        while n < (4 << 20) - 40000:
            lit = rng.integers(0, 256, int(rng.integers(0, 21)),
                               dtype=np.uint8).tobytes()
            ml = int(rng.integers(100, 30001))
            seqs.append((lit, int(rng.integers(1, 65536)), ml))
            n += len(lit) + ml
        tail = rng.integers(0, 256, 9, dtype=np.uint8).tobytes()
        raws.append(expand_block(seqs, tail, hist[-65536:]))
        comps.append(encode_block(seqs, tail))
        hist = hist[-65536:] + raws[-1]
    return window, raws, comps, 4 << 20, n_blocks


def resolve_sets(tables, n_seq, block_at, n_ok, w: int, total: int,
                 seg: int):
    """What the resolve by segments (``csrc/linked_decode.cuh``) must find
    in a walked batch, from its records as the plain version makes its
    nodes (a match byte's parent base + (x mod d), base = m_out - d), as
    bool[total]: the nodes whose chain leaves their segment of ``seg``
    bytes before it reaches a known byte (the open nodes); and those of
    them on which the segments' pass leaves a chain (its parents in the
    period before the match's start in the segment, or before the
    segment): the list."""
    known = np.ones(total, bool)
    plain, by_seg = np.arange(total), np.arange(total)
    tb = tables.cpu().numpy()
    ns, at = n_seq.cpu().numpy(), block_at.cpu().numpy()
    for b in range(int(n_ok)):
        k = int(ns[b])
        mo, md, ml = (tb[f, b, :k].astype(np.int64) for f in (3, 4, 5))
        keep = md > 0
        mo, md, ml = mo[keep], md[keep], ml[keep]
        rec = np.repeat(np.arange(mo.size), ml)
        x = np.arange(rec.size) - np.repeat(np.cumsum(ml) - ml, ml)
        mf = w + int(at[b]) + mo[rec]
        d = md[rec]
        j = mf + x
        known[j] = False
        plain[j] = mf - d + x % d
        bp = np.maximum(mf, j // seg * seg) - d
        by_seg[j] = bp + (j - bp) % d
    s0 = np.arange(total) // seg * seg

    def follow(par):
        ptr = par.copy()
        while True:
            go = ~known & (ptr >= s0) & ~known[ptr] & (ptr != par[ptr])
            if not go.any():
                return ptr
            ptr = np.where(go, par[ptr], ptr)

    leaves = ~known & (follow(plain) < s0)
    exits = follow(by_seg)
    if not np.array_equal(leaves, ~known & (exits < s0)):
        raise AssertionError("the two kinds of parents leave differently")
    listed = np.zeros(total, bool)
    listed[exits[leaves]] = True
    return leaves, listed & leaves


def long_run_frame(case: str) -> bytes:
    """A linked frame (``bd`` 6) of three 1 MiB blocks whose tokens hold
    literal runs of 60,000 bytes and more, so that each block compresses
    to over 64 KiB (``literal_runs``), or 0xFF runs of hundreds of bytes
    (``long_matches``), or the latter with its second block cut in half
    (``fault``)."""
    rng = np.random.default_rng(164)
    raws, comps, hist = [], [], b""
    for k in range(3):
        if case == "literal_runs":
            seqs = [(rng.integers(0, 256, 60_000 + k, dtype=np.uint8)
                     .tobytes(), 5, 20)] + [(b"", 1, 30)] * 100
            tail = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
        else:
            seqs = [(b"ab", 2, 100_000), (b"", 7, 30_000)] + \
                [(b"q", 3, 9)] * 500
            tail = b"tail of the block"
        raw = expand_block(seqs, tail, hist)
        raws.append(raw)
        comps.append(encode_block(seqs, tail))
        hist += raw
    if case == "fault":
        comps[1] = comps[1][:len(comps[1]) // 2]
    return build_frame(raws, comps, bd=6, independent=False,
                       block_checksum=False)


def stalled_rank_job(mesh, job: dict) -> dict:
    """A job for ``dist/multihost.py::run_ranks``'s tests: rank
    ``job["stall"]`` raises ``RuntimeError`` (``job["fault"] == "raise"``)
    or sleeps past any timeout (``"hang"``), while every other rank waits
    for it in a barrier of the group."""
    from .dist.multihost import barrier

    if mesh.rank == job["stall"]:
        if job["fault"] == "raise":
            raise RuntimeError("stalled_rank_job: planted fault")
        time.sleep(3600)
    barrier(mesh)
    return {"rank": mesh.rank}


# ---------------------------------------------------------------------------
# LZ4Block streams
# ---------------------------------------------------------------------------

def lz4block_stream(raws, comps, block_size: int = 1 << 16, end: bool = True,
                    checks=None) -> bytes:
    """An LZ4Block stream written by hand: block i is ``comps[i]`` when
    that is shorter than ``raws[i]``, else ``raws[i]`` stored raw, its
    check ``checks[i]`` (by default the XXH32 of ``raws[i]``, seed
    ``DEFAULT_SEED``, masked to 28 bits); then the end block unless
    ``end`` is false."""
    level = bs.compression_level(block_size)
    out = bytearray()
    for i, (r, c) in enumerate(zip(raws, comps)):
        ck = (xxh32_bytes(r, bs.DEFAULT_SEED) & bs.CHECK_MASK
              if checks is None else checks[i])
        if len(c) >= len(r):
            out += bs.block_header(bs.COMPRESSION_METHOD_RAW, level, len(r),
                                   len(r), ck) + r
        else:
            out += bs.block_header(bs.COMPRESSION_METHOD_LZ4, level, len(c),
                                   len(r), ck) + c
    if end:
        out += bs.block_header(bs.COMPRESSION_METHOD_RAW, level, 0, 0, 0)
    return bytes(out)


# Planted faults of an LZ4Block stream of four 1 KiB blocks (an LZ4 block,
# a raw one, two LZ4), each breaking a rule of the reader in block 2 (or
# after it), with the code of its record: each of the header's rules, a
# header or payload cut off, no end block, an LZ4 payload that does not
# decode, one with bytes past its last sequence, a literal byte flipped, a
# wrong check; and magic bytes inside a raw payload, which read as they
# are.
LZ4BLOCK_FAULTS = {
    "magic": bs.CORRUPTED, "method": bs.CORRUPTED, "level": bs.CORRUPTED,
    "lengths_zero": bs.CORRUPTED, "raw_lengths": bs.CORRUPTED,
    "bound": bs.CORRUPTED, "empty_check": bs.CORRUPTED,
    "header_cut": bs.PREMATURE, "payload_cut": bs.PREMATURE,
    "no_end": bs.PREMATURE, "malformed": bs.MALFORMED,
    "trailing": bs.CORRUPTED, "literal": bs.CORRUPTED, "check": bs.CORRUPTED,
    "magic_inside": bs.OK}
LZ4BLOCK_FAULT_BLOCK = 1 << 10


def _fault_blocks(rng: np.random.Generator):
    from .kernels.codec import compress_fast_plain
    from .kernels.layout import from_device_layout, to_device_layout

    n = LZ4BLOCK_FAULT_BLOCK
    raws = [block_of(rng, "alphabet4", n), block_of(rng, "incompressible", n),
            block_of(rng, "text", n), block_of(rng, "period3", n)]
    src, lens = to_device_layout(raws, device="cpu")
    comp, comp_lens, _ = compress_fast_plain(src, lens, n + n // 255 + 16)
    return raws, from_device_layout(comp, comp_lens)


def _fake_chain(rng: np.random.Generator, size: int) -> bytes:
    """``size`` random bytes holding an LZ4Block stream of two raw blocks
    and, at its end, a header whose payload reaches exactly to the end:
    inside a raw payload its magic links to the header after it."""
    inner = lz4block_stream([block_of(rng, "incompressible", 100)] * 2,
                            [b""] * 2, 1024, end=False)
    tail = size - len(inner) - 2 * bs.HEADER_LENGTH - 50
    fake = bs.block_header(bs.COMPRESSION_METHOD_RAW, 0, tail, tail, 0)
    body = (block_of(rng, "incompressible", 50) + inner + fake
            + block_of(rng, "incompressible", tail))
    return body + block_of(rng, "incompressible", size - len(body))


def lz4block_fault(case: str, rng: np.random.Generator) -> tuple[bytes, int]:
    """The stream of :data:`LZ4BLOCK_FAULTS`' ``case`` (read with an empty
    block stopping the walk), and the record its fault lies in."""
    raws, comps = _fault_blocks(rng)
    at = 2                                  # the faulty block
    if case == "magic_inside":
        raws[1] = _fake_chain(rng, LZ4BLOCK_FAULT_BLOCK)
        return lz4block_stream(raws, comps, LZ4BLOCK_FAULT_BLOCK), -1
    if case == "malformed":
        comps[at] = b"\xf0" * 100
    elif case == "trailing":
        comps[at] = comps[at] + b"\x00\x00\x00"
    elif case == "literal":
        comps[at] = comps[at][:-2] + bytes([comps[at][-2] ^ 1]) + comps[at][-1:]
    checks = [xxh32_bytes(r, bs.DEFAULT_SEED) & bs.CHECK_MASK for r in raws]
    if case == "check":
        checks[at] ^= 1 << 27
    stream = bytearray(lz4block_stream(raws, comps, LZ4BLOCK_FAULT_BLOCK,
                                       checks=checks))
    h = sum(bs.HEADER_LENGTH + min(len(r), len(c))
            for r, c in zip(raws[:at], comps[:at]))
    if case == "magic":
        stream[h + 3] ^= 0x20
    elif case == "method":
        stream[h + 8] = 0x30 | (stream[h + 8] & 0x0F)
    elif case == "level":                   # 1 KiB blocks at level 0
        stream[h + 8] = (stream[h + 8] & 0xF0) | 0
        stream[h + 13:h + 17] = struct.pack("<I", 1025)
    elif case == "lengths_zero":
        stream[h + 9:h + 13] = bytes(4)
    elif case == "raw_lengths":
        stream[h + 8] = bs.COMPRESSION_METHOD_RAW | (stream[h + 8] & 0x0F)
    elif case == "bound":
        stream[h + 9:h + 13] = struct.pack("<I", 0xFFFFFFF0)
    elif case == "empty_check":             # an empty block with a check
        stream[h:h] = bs.block_header(bs.COMPRESSION_METHOD_RAW, 0, 0, 0, 7)
    elif case == "header_cut":
        del stream[h + 10:]
    elif case == "payload_cut":
        del stream[h + bs.HEADER_LENGTH + 5:]
    elif case == "no_end":
        del stream[-bs.HEADER_LENGTH:]
        at = 4
    return bytes(stream), at


# ---------------------------------------------------------------------------
# timing on the card
# ---------------------------------------------------------------------------

def cuda_ms(fn, reps: int) -> float:
    """Milliseconds a call of ``fn`` on the card, by CUDA events around
    ``reps`` calls after one untimed call."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_us(call, reps: int = 5) -> dict:
    """Device microseconds a call of each kernel ``call`` launches, from a
    ``torch.profiler`` trace of ``reps`` calls (empty where the trace has
    no device times)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "device_time_total", None)
        if us is None:
            us = getattr(e, "cuda_time_total", 0)
        if us:
            out[e.key[:60]] = us / reps
    return out
