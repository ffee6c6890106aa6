"""The parallel compressor: the K7 kernel and its plain version.

Counterpart of ``lz4_tpu/kernels/parallel_compress.py``, the JAX package's
device compressor that is free of the reference's byte identity: its
output is valid LZ4 but not the fast scan's bytes. It is deterministic, so
the port is held to its exact bytes. Each block goes through four phases:

1. each position's candidate is the nearest earlier position with the same
   4-byte word (exact, no hash), dropped when it is ``MAX_DISTANCE`` or
   more away;
2. the candidate's match extends by up to 15 words and then 1-3 bytes;
   exact runs at distances 1-4 replace it where they are strictly longer;
   lengths are clamped at the 512-byte segment's end and by the format's
   end rules;
3. a greedy walk from each segment's start selects matches;
4. matches that continue one another at the same distance merge, each is
   extended back by up to 7 bytes into its literal gap, and the sequences
   are written.

:func:`compress_parallel_batch` runs K7 (``csrc/parallel_compress.cu``) on
a CUDA tensor and :func:`compress_parallel_plain` on a CPU tensor; there
is no fallback from one to the other. The plain version goes phase by
phase as the JAX module does, on the whole batch at once.

The output of a block depends only on its bytes ``[0, n)``: bytes past a
block's length are read as zeros (the JAX layout's padding), so a block
comes out the same whatever the width of its batch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.constants import (
    LAST_LITERALS, MAX_DISTANCE, MF_LIMIT, MIN_MATCH, ML_BITS, ML_MASK,
    RUN_MASK, max_compressed_length)
from ..core.device import resolve_device
from ..core.errors import Lz4Error
from .build import Kernel, Scratch, c_function, resident_ctas
from .layout import (
    check_batch, cuda_stream, from_device_layout, row_stride, to_device_layout)

SEG = 512          # resolution segment (greedy walk length; matches clamp here)
EXT_STEPS = 15     # 4-byte extension steps -> hashed-match cap 4 + 60 + 3
RLE_DISTS = (1, 2, 3, 4)
PAD = 80           # the JAX layout's slack past a row; reads past n are 0
BEXT = 7           # back-extension cap
_GHOST = 0x7FFFFFFF

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PARALLEL = Kernel("parallel_compress", "parallel_compress",
                  "lz4tt_compress_parallel",
                  [_P, _I64, _P, _P, _I64, _I32, _P, _I64, _I32, _P, _I32,
                   _P])

SCRATCH = Scratch(torch.int32)


def resident_teams(index: int) -> int:
    """K7's teams (one CTA a block) that card ``index`` holds at once."""
    return resident_ctas("parallel_compress", "lz4tt_parallel_occupancy",
                         index)


def team_words(width: int) -> int:
    """int32 words of scratch one team needs for rows of ``width`` bytes
    (``lz4tt_pc_team_words``)."""
    fn = c_function("parallel_compress", "lz4tt_parallel_team_words",
                    [_I64], None)
    fn.restype = ctypes.c_longlong
    return fn(width)


def compress_parallel_batch(src: torch.Tensor, lens: torch.Tensor, cap: int):
    """Batched parallel compress, byte for byte
    ``parallel_compress.compress_parallel_batch``.

    Args:
      src: uint8[N, W] blocks; lens: int32[N] exact lengths.
      cap: per-block output capacity.

    Returns:
      (out uint8[N, row_stride(cap)], out_lens int32[N]) on the device of
      ``src``. ``out_lens[i]`` is -1 when the block does not fit ``cap``;
      its row then holds the first ``cap`` bytes of its encoding, as the
      JAX function's does. Bytes past a row's output are 0.
    """
    check_batch(src, lens)
    if cap < 0:
        raise ValueError("cap must be >= 0")
    if src.device.type == "cpu":
        return compress_parallel_plain(src, lens, cap)
    n = src.shape[0]
    out = torch.zeros((n, row_stride(cap)), dtype=torch.uint8,
                      device=src.device)
    out_lens = torch.empty((n,), dtype=torch.int32, device=src.device)
    if n:
        words = team_words(src.shape[1])
        teams, scratch = SCRATCH.teams(src, n, resident_teams(
            src.device.index), words)
        PARALLEL(src.data_ptr(), src.stride(0), lens.data_ptr(),
                 out.data_ptr(), out.stride(0), cap, scratch.data_ptr(),
                 words, teams, out_lens.data_ptr(), n, cuda_stream(src),
                 device=src.device.index)
    return out, out_lens


# ---------------------------------------------------------------------------
# the plain version: the JAX module's phases on the whole batch at once
# ---------------------------------------------------------------------------

def _words4(x):
    """int64[N, L+PAD] bytes -> int64[N, L+PAD-3] little-endian words."""
    return (x[:, :-3] | (x[:, 1:-2] << 8) | (x[:, 2:-1] << 16)
            | (x[:, 3:] << 24))


def _nearest_prev_equal(x4, n):
    """For each i: the nearest j < i with x4[j] == x4[i], else -1. A
    stable sort groups equal words in ascending positions; positions at or
    past n sort after every live one."""
    L = x4.shape[1]
    i = torch.arange(L, device=x4.device)
    live = i < n[:, None]
    key = torch.where(live, x4, _GHOST)
    k_sorted, order = torch.sort(key, dim=1, stable=True)
    prev_pos = torch.cat([torch.full_like(order[:, :1], -1), order[:, :-1]], 1)
    same = torch.cat([torch.zeros_like(live[:, :1]),
                      k_sorted[:, 1:] == k_sorted[:, :-1]], 1)
    cand = torch.empty_like(order).scatter_(
        1, order, torch.where(same, prev_pos, -1))
    return torch.where(live, cand, -1)


def _extend_match(x, x4, cand, n):
    """Match length at i against candidate j (>= 4 bytes equal by
    construction): up to EXT_STEPS word steps, then, only after all of
    them, an exact 1-3 byte tail."""
    L = cand.shape[1]
    L4 = x4.shape[1]
    i = torch.arange(L, device=x.device)
    nn = n[:, None]
    length = torch.full_like(cand, MIN_MATCH)
    alive = cand >= 0
    j = cand.clamp(min=0)
    for k in range(1, EXT_STEPS + 1):
        off = 4 * k
        cand_w = x4.gather(1, (j + off).clamp(max=L4 - 1))
        ok = alive & (cand_w == x4[:, off:off + L]) & (i + off + 4 <= nn)
        length = torch.where(ok, length + 4, length)
        alive = ok
    for _ in range(3):
        cb = x.gather(1, (j + length).clamp(max=x.shape[1] - 1))
        hb = x.gather(1, (i + length).clamp(max=x.shape[1] - 1))
        ok = alive & (cb == hb) & (i + length < nn)
        length = torch.where(ok, length + 1, length)
        alive = ok
    return torch.where(cand >= 0, length, 0)


def _rle_lengths(x, n, dist):
    """Exact forward run length of x[i] == x[i - dist] (0 where unequal or
    i < dist), from a reverse cummin of the positions where it stops."""
    L = x.shape[1] - PAD
    i = torch.arange(L, device=x.device)
    eq = torch.zeros((x.shape[0], L), dtype=torch.bool, device=x.device)
    eq[:, dist:] = x[:, dist:L] == x[:, :L - dist]
    eq &= i < n[:, None]
    stop = torch.where(eq, L + PAD, i)
    next_stop = torch.cummin(stop.flip(1), dim=1).values.flip(1)
    return torch.minimum(next_stop, n[:, None]) - i


def _extend_back(x, dist):
    """bext[i]: the consecutive t >= 1 with x[i-t] == x[i-dist[i]-t],
    capped at BEXT."""
    L = dist.shape[1]
    i = torch.arange(L, device=x.device)
    j = i - dist
    bext = torch.zeros_like(dist)
    alive = dist > 0
    for _ in range(BEXT):
        t = bext + 1
        ok = (alive & (i - t >= 0) & (j - t >= 0)
              & (x.gather(1, (i - t).clamp(min=0))
                 == x.gather(1, (j - t).clamp(min=0))))
        bext = torch.where(ok, t, bext)
        alive = ok
    return bext


def _ext_bytes(v):
    """Extension bytes (0xFF runs and the remainder) of run value v >= 0."""
    return torch.where(v >= RUN_MASK, 1 + torch.div(v - RUN_MASK, 255,
                                                    rounding_mode="floor"), 0)


def _resolve_segments(mlen, n):
    """The greedy walk of every segment of every row at once, SEG steps:
    from p, select the match at p when mlen[p] >= 4 and advance by it,
    else advance one byte. Returns the selected-match mask."""
    N, L = mlen.shape
    n_segs = (L + SEG - 1) // SEG
    p = (torch.arange(n_segs, device=mlen.device) * SEG).expand(N, -1)
    seg_end = torch.minimum(p + SEG, n[:, None])
    sel = torch.zeros((N, L + 1), dtype=torch.bool, device=mlen.device)
    for _ in range(SEG):
        length = mlen.gather(1, p.clamp(max=L - 1))
        is_m = (length >= MIN_MATCH) & (p < seg_end)
        sel.scatter_(1, torch.where(is_m, p, L), True)
        p = torch.where(is_m, p + length, p + 1)
    return sel[:, :L]


def _compact(values, slot, width):
    """Scatter ``values`` to ``slot`` (``width`` drops) of a row of
    ``width`` zeros."""
    out = torch.zeros((values.shape[0], width + 1), dtype=values.dtype,
                      device=values.device)
    return out.scatter_(1, slot, values)[:, :width]


def _compress_rows(x, n, cap):
    """Rows of int64[N, L+PAD] bytes (zeros past n) -> (out int64[N, cap],
    out_len int64[N])."""
    N, L = x.shape[0], x.shape[1] - PAD
    dev = x.device
    nn = n[:, None]
    x4 = _words4(x)
    i = torch.arange(L, device=dev)

    # phases 1 and 2: candidates and lengths
    cand = _nearest_prev_equal(x4[:, :L], n)
    cand = torch.where(i - cand < MAX_DISTANCE, cand, -1)
    best_len = _extend_match(x, x4, cand, n)
    best_dist = torch.where(cand >= 0, i - cand, 0)
    for d in RLE_DISTS:
        rl = _rle_lengths(x, n, d)
        take = rl > best_len
        best_len = torch.where(take, rl, best_len)
        best_dist = torch.where(take, d, best_dist)
    seg_end = (torch.div(i, SEG, rounding_mode="floor") + 1) * SEG
    limit = torch.minimum(torch.minimum(seg_end, nn - LAST_LITERALS) - i,
                          best_len)
    mlen = torch.where((i + MF_LIMIT <= nn) & (limit >= MIN_MATCH), limit, 0)

    # phase 3: the greedy walk
    sel = _resolve_segments(mlen, n)

    # phase 4: sequences and emission
    MS = L // 4 + 1
    s_idx = torch.arange(MS, device=dev)
    sel_i = sel.long()
    n_match = sel_i.sum(1, keepdim=True)
    tgt = torch.where(sel, torch.cumsum(sel_i, 1) - 1, MS)
    m_pos = _compact(i.expand(N, -1), tgt, MS)
    m_len = _compact(mlen, tgt, MS)
    m_dist = _compact(best_dist, tgt, MS)
    is_m0 = s_idx < n_match

    # continuation merging: a match that starts where the previous one
    # ends, at the same distance, folds into it
    prev0 = (s_idx - 1).clamp(min=0).expand(N, -1)
    cont = ((s_idx > 0) & is_m0
            & (m_pos == m_pos.gather(1, prev0) + m_len.gather(1, prev0))
            & (m_dist == m_dist.gather(1, prev0)))
    head = is_m0 & ~cont
    gid = torch.where(is_m0, torch.cumsum(head.long(), 1) - 1, MS)
    head_slot = torch.where(head, gid, MS)
    g_pos = _compact(m_pos, head_slot, MS)
    g_dist = _compact(m_dist, head_slot, MS)
    g_len = torch.zeros((N, MS + 1), dtype=m_len.dtype, device=dev)
    g_len = g_len.scatter_add_(1, gid, torch.where(is_m0, m_len, 0))[:, :MS]
    n_match = head.long().sum(1, keepdim=True)
    m_pos, m_len, m_dist = g_pos, g_len, g_dist

    n_seq = n_match + 1
    is_seq = s_idx < n_seq
    is_match_seq = s_idx < n_match
    prev = (s_idx - 1).clamp(min=0).expand(N, -1)
    lit_start = torch.where(s_idx == 0, 0,
                            m_pos.gather(1, prev) + m_len.gather(1, prev))
    lit_len = torch.where(is_match_seq, m_pos - lit_start,
                          torch.where(is_seq, nn - lit_start, 0))

    # back-extension into the literal gap; the match end stays
    bext_all = _extend_back(x, best_dist)
    bk = torch.where(is_match_seq,
                     torch.minimum(bext_all.gather(1, m_pos.clamp(0, L - 1)),
                                   lit_len), 0)
    m_pos = m_pos - bk
    m_len = m_len + bk
    lit_len = lit_len - bk

    lit_ext = _ext_bytes(lit_len)
    ml_run = (m_len - MIN_MATCH).clamp(min=0)
    ml_ext = torch.where(is_match_seq, _ext_bytes(ml_run), 0)
    seq_size = torch.where(
        is_seq, 1 + lit_ext + lit_len + torch.where(is_match_seq, 2 + ml_ext,
                                                    0), 0)
    out_start = torch.cumsum(seq_size, 1) - seq_size
    total = out_start[:, -1] + seq_size[:, -1]

    lit_tok = lit_len.clamp(max=RUN_MASK)
    ml_tok = torch.where(is_match_seq, ml_run.clamp(max=ML_MASK), 0)
    token = (lit_tok << ML_BITS) | ml_tok

    # every output byte by its sequence and its offset in it
    q = torch.arange(cap, device=dev).expand(N, -1).contiguous()
    seq_of = (torch.searchsorted(out_start.contiguous(), q, right=True)
              - 1).clamp(0, MS - 1)
    r = q - out_start.gather(1, seq_of)
    litext_n = lit_ext.gather(1, seq_of)
    litlen_n = lit_len.gather(1, seq_of)
    mlext_n = ml_ext.gather(1, seq_of)
    lit_begin = 1 + litext_n
    off_begin = lit_begin + litlen_n
    mlext_begin = off_begin + 2
    lit_rem = litlen_n - RUN_MASK
    lit_ext_val = torch.where(r - 1 < litext_n - 1, 255,
                              lit_rem - 255 * (litext_n - 1).clamp(min=0))
    ml_rem = (m_len.gather(1, seq_of) - MIN_MATCH).clamp(min=0) - ML_MASK
    ml_ext_val = torch.where(r - mlext_begin < mlext_n - 1, 255,
                             ml_rem - 255 * (mlext_n - 1).clamp(min=0))
    lit_src = lit_start.gather(1, seq_of) + (r - lit_begin)
    lit_val = x.gather(1, lit_src.clamp(0, L + PAD - 1))
    dist_q = m_dist.gather(1, seq_of)
    off_val = torch.where(r == off_begin, dist_q & 0xFF, dist_q >> 8)
    val = torch.where(
        r == 0, token.gather(1, seq_of),
        torch.where(r < lit_begin, lit_ext_val,
                    torch.where(r < off_begin, lit_val,
                                torch.where(r < mlext_begin, off_val,
                                            ml_ext_val))))
    out = torch.where(q < total[:, None], val, 0)
    return out, torch.where(total > cap, -1, total)


def compress_parallel_plain(src: torch.Tensor, lens: torch.Tensor, cap: int):
    """Plain version of :func:`compress_parallel_batch`, on any device:
    the JAX module's phases in torch ops over the batch, rows padded with
    zeros past their lengths."""
    check_batch(src, lens)
    if cap < 0:
        raise ValueError("cap must be >= 0")
    n = src.shape[0]
    out = torch.zeros((n, row_stride(cap)), dtype=torch.uint8,
                      device=src.device)
    if not n:
        return out, torch.zeros((0,), dtype=torch.int32, device=src.device)
    nl = lens.long()
    L = max(4, (int(nl.max()) + 3) & ~3)
    x = torch.zeros((n, L + PAD), dtype=torch.int64, device=src.device)
    w = min(L, src.shape[1])
    x[:, :w] = src[:, :w].long()
    x[:, :L] *= torch.arange(L, device=src.device) < nl[:, None]
    rows, out_lens = _compress_rows(x, nl, cap)
    out[:, :cap] = rows.to(torch.uint8)
    return out, out_lens.to(torch.int32)


# ---------------------------------------------------------------------------
# the JAX module's host helpers
# ---------------------------------------------------------------------------

def to_layout(blocks, block_len: int):
    """list[bytes] -> (int32[N, block_len+PAD], int32[N]) numpy arrays: the
    JAX module's layout, one byte an int32."""
    n = len(blocks)
    arr = np.zeros((n, block_len + PAD), np.int32)
    lens = np.zeros((n,), np.int32)
    for k, b in enumerate(blocks):
        if b:
            arr[k, :len(b)] = np.frombuffer(b, np.uint8)
        lens[k] = len(b)
    return arr, lens


def compress_blocks(blocks, block_len: int | None = None,
                    device: str | torch.device = "cuda") -> list[bytes]:
    """list[bytes] -> list[bytes] of valid LZ4 blocks, compressed on
    ``device`` (K7 on a card, the plain version on the CPU). Raises
    ``Lz4Error`` when a block does not fit ``max_compressed_length`` of
    the rounded ``block_len``, as the JAX function does."""
    dev = resolve_device(device)
    if not blocks:
        return []
    block_len = block_len or max(len(b) for b in blocks)
    block_len = max(4, (block_len + 3) & ~3)
    cap = max_compressed_length(block_len)
    src, lens = to_device_layout(blocks, block_len, device=dev)
    out, out_lens = compress_parallel_batch(src, lens, cap)
    got = out_lens.tolist()
    if min(got) < 0:
        raise Lz4Error("parallel compress: dest capacity too small")
    return from_device_layout(out, got)
