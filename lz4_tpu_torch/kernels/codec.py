"""Batched LZ4 block codec: the K1 (decode) and K2 (compress) kernels and
their plain versions.

``decompress_safe_batch``, ``decompress_fast_batch`` and
``compress_fast_batch`` keep the contract of ``lz4_tpu/kernels/jax_codec.py``
(``:239``, ``:256`` and ``:563``): a batch in, the output batch, its lengths
(bytes read, for the fast decode) and one error code per block out (``OK``,
``ERR_MALFORMED``, ``ERR_DEST_TOO_SMALL``; kernels cannot throw). Batches are
in the port's layout (``kernels/layout.py``). A CUDA tensor goes to the
kernel; a CPU tensor goes to the plain version in this module. There is no
fallback from one to the other.

The decode wrappers check a batch's structure on the host and read nothing
back (``layout.check_layout``): a row whose length lies outside ``[0, S]``
(S the row stride of ``comp``) is that row's ``ERR_MALFORMED``, with out
length (bytes read) 0 and nothing written to its output row, on the card
and in the plain versions alike. That is the reference's rule for faults in
the data, a code a block and never thrown (``jax_codec.py:14-16``).

``decompress_safe_hist_batch`` and ``compress_dict_batch`` are the same
kernels with a window of up to 64 KiB before each row: a history the
decode's matches may reach into (a linked block's earlier output, or a
dictionary), and a dictionary the compressor's matches may reach into.
They are the device counterparts of the native ``tpulz4_decompress_safe_ext``
and ``compress_ext`` (``lz4_tpu/native/src/tpulz4.cpp:1060-1202,416-542``,
behind ``native_instances.decompress_block_with_history`` and
``compress_block_with_dict``), byte for byte; the JAX package has no device
counterpart of either.

The plain versions are Python loops over a row's bytes, one row at a time,
run on a copy of the batch on the host. They are the yardstick the kernels
are held against, on the card and in the CPU tests.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ..core.constants import (
    COPY_LENGTH, HASH_LOG, HASH_LOG_64K, LAST_LITERALS, LZ4_64K_LIMIT,
    MAX_DISTANCE, MF_LIMIT, MIN_LENGTH, MIN_MATCH, ML_BITS, ML_MASK, RUN_MASK,
    SKIP_STRENGTH,
)
from ..utils.profiling import entry, readback
from .build import Kernel, Scratch
from .layout import check_batch, check_layout, cuda_stream, row_stride

OK = 0
ERR_MALFORMED = 1
ERR_DEST_TOO_SMALL = 2

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
DECODE = Kernel("lz4_decode", "lz4_decode", "lz4tt_decompress_safe",
                [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32, _P])
DECODE_FAST = Kernel("lz4_decode_fast", "lz4_decode", "lz4tt_decompress_fast",
                     [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32, _P])
COMPRESS = Kernel("lz4_compress", "lz4_compress", "lz4tt_compress_fast",
                  [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32, _P])
DECODE_HIST = Kernel("lz4_decode_hist", "lz4_decode",
                     "lz4tt_decompress_safe_hist",
                     [_P, _I64, _P, _P, _I64, _I32, _P, _I64, _P, _P, _P, _I32,
                      _P])
COMPRESS_DICT = Kernel("lz4_compress_dict", "lz4_compress",
                       "lz4tt_compress_dict",
                       [_P, _I64, _P, _P, _I64, _P, _P, _I64, _I32, _P, _P,
                        _I32, _P, _I32, _P])
# the most bytes of history or dictionary a row may have: the format's
# 64 KiB window
WINDOW = 1 << 16
# the seeded hash table that every row of a shared dictionary starts from
# (the 12-bit table's int32 entries), a card and stream
SEED_WORDS = 1 << HASH_LOG
SEED = Scratch(torch.int32)


# ---------------------------------------------------------------------------
# safe decode
# ---------------------------------------------------------------------------

@entry
def decompress_safe_batch(comp: torch.Tensor, comp_lens: torch.Tensor,
                          out_max: int, out: torch.Tensor | None = None):
    """Batched safe decompression (exact compressed sizes known).

    Args:
      comp: uint8[N, S] compressed blocks; comp_lens: int32[N] exact sizes.
        A size outside ``[0, S]`` is that row's ``ERR_MALFORMED`` (out
        length 0, its output row not written), not an exception: the
        lengths are not read back.
      out_max: the most bytes a block may decode to.
      out: optional uint8[N, >= out_max] buffer to decode into; bytes at
        and past ``out_max`` in each row are never written.

    Returns:
      (out uint8[N, row_stride(out_max)] (or ``out``), out_lens int32[N],
      err int32[N]).
    """
    check_layout(comp, comp_lens)
    out = _decode_out(comp, out_max, out)
    if comp.device.type == "cpu":
        return decompress_safe_plain(comp, comp_lens, out_max, out)
    n = comp.shape[0]
    out_lens = torch.empty((n,), dtype=torch.int32, device=comp.device)
    err = torch.empty((n,), dtype=torch.int32, device=comp.device)
    DECODE(comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(),
           out.data_ptr(), out.stride(0), out_max, out_lens.data_ptr(),
           err.data_ptr(), n, cuda_stream(comp),
           device=comp.device.index)
    return out, out_lens, err


def _decode_out(comp, out_max, out):
    if out_max < 0:
        raise ValueError("out_max must be >= 0")
    if out is None:
        return torch.zeros((comp.shape[0], row_stride(out_max)),
                           dtype=torch.uint8, device=comp.device)
    if (out.dtype != torch.uint8 or out.dim() != 2 or not out.is_contiguous()
            or out.shape[0] != comp.shape[0] or out.shape[1] < out_max
            or out.device != comp.device):
        raise ValueError("out must be a contiguous uint8[N, >= out_max] "
                         "tensor on the device of comp")
    return out


def _len_ext(src: bytes, s: int, src_end: int, length: int):
    """0xFF-run length extension; a run cut off by the end adds 0xFF."""
    b = 0xFF
    while s < src_end:
        b = src[s]
        s += 1
        if b != 0xFF:
            break
        length += 0xFF
    return s, length + b


def _decode_row(comp: bytes, src_end: int, out: bytearray, dest_cap: int,
                fast: bool = False, hist: bytes = b""):
    """Decode one block into ``out[:dest_cap]``; returns (out_len, src_read,
    err).

    The classification of ``jax_codec._decompress_one``, safe or fast
    variant (see ``csrc/lz4_decode.cuh``); a null match offset writes zeros.
    In the fast variant ``src_end`` is the bytes available and ``dest_cap``
    the exact decoded length. ``src_read`` counts only on OK rows.
    ``hist`` (the safe variant) is the output before the block, which
    matches may reach into, as in ``tpulz4_decompress_safe_ext``.
    """
    if dest_cap == 0:
        if fast:
            return 0, 1, OK if comp[0] == 0 else ERR_MALFORMED
        ok = src_end == 1 and comp[0] == 0
        return 0, 1, OK if ok else ERR_DEST_TOO_SMALL
    if hist:
        buf = bytearray(hist) + out
        n, s, e = _decode_window(comp, src_end, buf, len(hist),
                                 len(hist) + dest_cap, fast)
        out[:] = buf[len(hist):]
        return n, s, e
    return _decode_window(comp, src_end, out, 0, dest_cap, fast)


def _decode_window(comp: bytes, src_end: int, out: bytearray, base: int,
                   dest_cap: int, fast: bool):
    """:func:`_decode_row` on ``out``, whose first ``base`` bytes are the
    history: the block decodes into ``out[base:dest_cap]``."""
    s, d = 0, base
    while True:
        if s >= src_end:
            return d - base, s, ERR_MALFORMED
        token = comp[s]
        s += 1
        lit_len = token >> ML_BITS
        if lit_len == RUN_MASK:
            s, lit_len = _len_ext(comp, s, src_end, lit_len)
        lit_end = d + lit_len
        if fast:
            if s + lit_len > src_end:
                return d - base, s, ERR_MALFORMED
            if lit_end > dest_cap - COPY_LENGTH:
                if lit_end != dest_cap:
                    return d - base, s, ERR_MALFORMED
                out[d:lit_end] = comp[s:s + lit_len]
                return lit_end - base, s + lit_len, OK
        elif (lit_end > dest_cap - COPY_LENGTH
                or s + lit_len > src_end - COPY_LENGTH):
            if lit_end > dest_cap:
                return d - base, s, ERR_DEST_TOO_SMALL
            if s + lit_len != src_end:
                return d - base, s, ERR_MALFORMED
            out[d:lit_end] = comp[s:src_end]
            return lit_end - base, src_end, OK
        out[d:lit_end] = comp[s:s + lit_len]
        s += lit_len
        d = lit_end

        if s + 2 > src_end:
            return d - base, s, ERR_MALFORMED
        dist = comp[s] | (comp[s + 1] << 8)
        s += 2
        m_len = token & ML_MASK
        if m_len == ML_MASK:
            s, m_len = _len_ext(comp, s, src_end, m_len)
        m_len += MIN_MATCH
        m_end = d + m_len
        if d - dist < 0 or m_end > dest_cap:
            return d - base, s, ERR_MALFORMED
        if dist == 0:
            out[d:m_end] = bytes(m_len)
        elif dist >= m_len:
            out[d:m_end] = out[d - dist:d - dist + m_len]
        else:
            period = bytes(out[d - dist:d])
            out[d:m_end] = (period * (m_len // dist + 1))[:m_len]
        d = m_end


def decompress_safe_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                          out_max: int, out: torch.Tensor | None = None):
    """Plain version of :func:`decompress_safe_batch`, on any device."""
    check_layout(comp, comp_lens)
    out = _decode_out(comp, out_max, out)
    return _decode_plain(comp, comp_lens, out, out_max)


def _decode_plain(comp: torch.Tensor, lens: torch.Tensor, out: torch.Tensor,
                  cap: int, fast: bool = False, hists: list | None = None):
    """The plain versions' loop: row i decoded by :func:`_decode_row` into
    ``out[i, :cap]``, with the history ``hists[i]`` where given. A length
    outside ``[0, S]`` is the row's ``ERR_MALFORMED``, out length or bytes
    read 0 and the row not written, as K1 does. Returns (out, out lengths
    (bytes read where ``fast``), err) on the device of ``comp``."""
    comp_np = comp.cpu().numpy()
    stride = comp.shape[1]
    lens = lens.cpu().tolist()
    rows = out[:, :cap].cpu().numpy()
    got = np.zeros((len(lens),), np.int32)
    err = np.zeros((len(lens),), np.int32)
    for i, n in enumerate(lens):
        if not 0 <= n <= stride:
            err[i] = ERR_MALFORMED
            continue
        buf = bytearray(rows[i].tobytes())
        # the fast contract reads a row's first byte whatever it holds
        src = comp_np[i, :max(n, 1) if fast else n].tobytes()
        out_len, read, err[i] = _decode_row(src, n, buf, cap, fast,
                                            hists[i] if hists else b"")
        got[i] = read if fast else out_len
        rows[i] = np.frombuffer(buf, np.uint8)
    out[:, :cap] = torch.from_numpy(rows).to(out.device)
    dev = comp.device
    return out, torch.from_numpy(got).to(dev), torch.from_numpy(err).to(dev)


# ---------------------------------------------------------------------------
# a window before each row: the decode's history, the compressor's dictionary
# ---------------------------------------------------------------------------

def _check_window(win: torch.Tensor, win_lens: torch.Tensor, n: int,
                  device: torch.device, what: str):
    """Validate a window batch: ``win`` a uint8[1 or n, W] tensor whose rows
    may lie anywhere (any row stride, bytes contiguous in a row) and
    ``win_lens`` int32[n] within ``[0, min(W, WINDOW)]``; row b's window is
    the last ``win_lens[b]`` bytes of ``win``'s row b (or its only row).
    Returns the row stride a kernel takes (0 for one shared row) and the
    least and largest length. This reads the lengths, so it waits for the
    card."""
    if (win.dtype != torch.uint8 or win.dim() != 2 or win.shape[0] not in (1, n)
            or (win.shape[1] > 1 and win.stride(1) != 1)):
        raise ValueError(f"{what} must be a uint8[1 or N, W] tensor with "
                         "contiguous rows")
    if (win_lens.dtype != torch.int32 or win_lens.dim() != 1
            or win_lens.shape[0] != n or not win_lens.is_contiguous()):
        raise ValueError(f"expected contiguous int32[N] {what} lengths")
    if win.device != device or win_lens.device != device:
        raise ValueError(f"{what} must lie on the device of the batch")
    lo = hi = 0
    if n:
        with readback("check_window", win_lens):
            lo, hi = (int(v) for v in torch.aminmax(win_lens))
        if lo < 0 or hi > min(win.shape[1], WINDOW):
            raise ValueError(f"{what} lengths must lie in "
                             f"[0, {min(win.shape[1], WINDOW)}]")
    return win.stride(0) if win.shape[0] > 1 else 0, lo, hi


def _window_rows(win: torch.Tensor, win_lens: torch.Tensor, n: int):
    """Each row's window as bytes, on the host."""
    lens = win_lens.cpu().tolist()
    width = win.shape[1]
    rows = win.cpu().numpy()
    return [rows[i if win.shape[0] > 1 else 0, width - k:].tobytes()
            for i, k in enumerate(lens)]


def decompress_safe_hist_batch(comp: torch.Tensor, comp_lens: torch.Tensor,
                               out_max: int, hist: torch.Tensor,
                               hist_lens: torch.Tensor,
                               out: torch.Tensor | None = None):
    """:func:`decompress_safe_batch` with a history before each row: matches
    may reach ``hist_lens[b]`` bytes before row b's output, into the last
    ``hist_lens[b]`` bytes of ``hist``'s row b (or its only row), and a
    match that reaches farther is ``ERR_MALFORMED``. One shared row holds a
    dictionary once for the whole batch; a linked block passes the bytes
    just before its own ``out`` row (a view of one buffer), so that the
    frame's earlier output is read where it was decoded. With every
    history length 0 it equals :func:`decompress_safe_batch`. A compressed
    size outside ``[0, S]`` is that row's ``ERR_MALFORMED``, as there; the
    history lengths are read back and checked on the host
    (:func:`_check_window`).

    Returns (out, out_lens int32[N], err int32[N]) as
    :func:`decompress_safe_batch` does.
    """
    check_layout(comp, comp_lens)
    n = comp.shape[0]
    stride, _, _ = _check_window(hist, hist_lens, n, comp.device, "hist")
    out = _decode_out(comp, out_max, out)
    if comp.device.type == "cpu":
        return decompress_safe_hist_plain(comp, comp_lens, out_max, hist,
                                          hist_lens, out)
    out_lens = torch.empty((n,), dtype=torch.int32, device=comp.device)
    err = torch.empty((n,), dtype=torch.int32, device=comp.device)
    DECODE_HIST(comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(),
                out.data_ptr(), out.stride(0), out_max,
                hist.data_ptr() + hist.shape[1], stride, hist_lens.data_ptr(),
                out_lens.data_ptr(), err.data_ptr(), n, cuda_stream(comp),
                device=comp.device.index)
    return out, out_lens, err


def decompress_safe_hist_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                               out_max: int, hist: torch.Tensor,
                               hist_lens: torch.Tensor,
                               out: torch.Tensor | None = None):
    """Plain version of :func:`decompress_safe_hist_batch`, on any device."""
    check_layout(comp, comp_lens)
    n = comp.shape[0]
    _check_window(hist, hist_lens, n, comp.device, "hist")
    hists = _window_rows(hist, hist_lens, n)   # before out is written
    out = _decode_out(comp, out_max, out)
    return _decode_plain(comp, comp_lens, out, out_max, hists=hists)


# ---------------------------------------------------------------------------
# fast decode (exact decompressed size known)
# ---------------------------------------------------------------------------

def decompress_fast_batch(comp: torch.Tensor, comp_avail: torch.Tensor,
                          dest_len: int, out: torch.Tensor | None = None):
    """Batched fast decompression: every block decodes to exactly
    ``dest_len`` bytes, and the bytes it consumed are reported.

    Args:
      comp: uint8[N, S] compressed blocks, S >= 1 (``dest_len == 0`` reads
        the first byte of a row whatever ``comp_avail`` says, as
        ``jax_codec`` does).
      comp_avail: int32[N] bytes available in each row; not necessarily the
        exact compressed length (the fast contract's point). A count
        outside ``[0, S]`` is that row's ``ERR_MALFORMED`` (bytes read 0,
        its output row not written, its first byte not read), not an
        exception.
      dest_len: the exact decoded length of every block.
      out: optional uint8[N, >= dest_len] buffer to decode into; bytes at
        and past ``dest_len`` in each row are never written.

    Returns:
      (out uint8[N, row_stride(dest_len)] (or ``out``), src_read int32[N]
      (meaningful on OK rows), err int32[N]).
    """
    check_layout(comp, comp_avail)
    if comp.shape[1] == 0:
        raise ValueError("rows of comp must hold at least one byte")
    out = _decode_out(comp, dest_len, out)
    if comp.device.type == "cpu":
        return decompress_fast_plain(comp, comp_avail, dest_len, out)
    n = comp.shape[0]
    src_read = torch.empty((n,), dtype=torch.int32, device=comp.device)
    err = torch.empty((n,), dtype=torch.int32, device=comp.device)
    DECODE_FAST(comp.data_ptr(), comp.stride(0), comp_avail.data_ptr(),
                out.data_ptr(), out.stride(0), dest_len, src_read.data_ptr(),
                err.data_ptr(), n, cuda_stream(comp),
                device=comp.device.index)
    return out, src_read, err


def decompress_fast_plain(comp: torch.Tensor, comp_avail: torch.Tensor,
                          dest_len: int, out: torch.Tensor | None = None):
    """Plain version of :func:`decompress_fast_batch`, on any device."""
    check_layout(comp, comp_avail)
    if comp.shape[1] == 0:
        raise ValueError("rows of comp must hold at least one byte")
    out = _decode_out(comp, dest_len, out)
    return _decode_plain(comp, comp_avail, out, dest_len, fast=True)


# ---------------------------------------------------------------------------
# fast-scan compress
# ---------------------------------------------------------------------------

@entry
def compress_fast_batch(src: torch.Tensor, src_lens: torch.Tensor,
                        dest_cap: int):
    """Batched fast-scan compression, byte-identical to the reference.

    Each block takes the reference's variant for its own length: below
    ``LZ4_64K_LIMIT`` the 13-bit table, from it on the 12-bit table with
    the ``MAX_DISTANCE`` window.

    Args:
      src: uint8[N, S] input blocks; src_lens: int32[N] exact lengths.
      dest_cap: per-block output capacity (``max_compressed_length(L)``
        never fails).

    Returns:
      (dest uint8[N, row_stride(dest_cap)], lens int32[N], err int32[N]).
    """
    check_batch(src, src_lens)
    if dest_cap < 0:
        raise ValueError("dest_cap must be >= 0")
    n = src.shape[0]
    if src.device.type == "cpu":
        return compress_fast_plain(src, src_lens, dest_cap)
    dest = torch.zeros((n, row_stride(dest_cap)), dtype=torch.uint8,
                       device=src.device)
    out_lens = torch.empty((n,), dtype=torch.int32, device=src.device)
    err = torch.empty((n,), dtype=torch.int32, device=src.device)
    COMPRESS(src.data_ptr(), src.stride(0), src_lens.data_ptr(),
             dest.data_ptr(), dest.stride(0), dest_cap, out_lens.data_ptr(),
             err.data_ptr(), n, cuda_stream(src),
             device=src.device.index)
    return dest, out_lens, err


_read32 = struct.Struct("<I").unpack_from
_HASH_MULT = 2654435761
_U32 = 0xFFFFFFFF


def _common_bytes(src: bytes, o1: int, o2: int, limit: int) -> int:
    count = 0
    while o2 + count + 64 <= limit and \
            src[o1 + count:o1 + count + 64] == src[o2 + count:o2 + count + 64]:
        count += 64
    while o2 + count < limit and src[o1 + count] == src[o2 + count]:
        count += 1
    return count


def _compress_row(src: bytes, src_len: int, dest_cap: int, width: int):
    """Compress one block; returns (dest bytearray[width], length, err).

    compress.template:16-261 with the reference's per-length variant;
    writes at or past ``width`` are dropped, as the kernel drops them.
    """
    dest = bytearray(width)

    def put(pos, v):
        if pos < width:
            dest[pos] = v

    def put_run(pos, data):
        if pos < width:
            dest[pos:pos + len(data)] = data[:width - pos]

    def write_len(d, length):
        while length >= 0xFF:
            put(d, 0xFF)
            d += 1
            length -= 0xFF
        put(d, length)
        return d + 1

    small = src_len < LZ4_64K_LIMIT
    shift = 32 - (HASH_LOG_64K if small else HASH_LOG)
    src_end = src_len
    src_limit = src_end - LAST_LITERALS
    mflimit = src_end - MF_LIMIT
    anchor = d = 0

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
                h = ((cur * _HASH_MULT) & _U32) >> shift
                ref = table[h]
                table[h] = s
                if ((small or s - ref < MAX_DISTANCE)
                        and _read32(src, ref)[0] == cur):
                    found = True
                    break
            if not found:
                break

            excess = 0
            while (ref - excess > 0 and s - excess > anchor
                   and src[ref - excess - 1] == src[s - excess - 1]):
                excess += 1
            s -= excess
            ref -= excess

            run_len = s - anchor
            token_off = d
            d += 1
            if d + run_len + (2 + 1 + LAST_LITERALS) + (run_len >> 8) > dest_cap:
                return dest, d, ERR_DEST_TOO_SMALL
            if run_len >= RUN_MASK:
                token = RUN_MASK << ML_BITS
                d = write_len(d, run_len - RUN_MASK)
            else:
                token = run_len << ML_BITS
            put_run(d, src[anchor:s])
            d += run_len

            while True:
                back = s - ref
                put(d, back & 0xFF)
                put(d + 1, (back >> 8) & 0xFF)
                d += 2
                s += MIN_MATCH
                ref += MIN_MATCH
                match_len = _common_bytes(src, ref, s, src_limit)
                if d + (1 + LAST_LITERALS) + (match_len >> 8) > dest_cap:
                    return dest, d, ERR_DEST_TOO_SMALL
                s += match_len
                if match_len >= ML_MASK:
                    token |= ML_MASK
                    d = write_len(d, match_len - ML_MASK)
                else:
                    token |= match_len
                put(token_off, token)

                if s > mflimit:
                    break
                prev = _read32(src, s - 2)[0]
                table[((prev * _HASH_MULT) & _U32) >> shift] = s - 2
                cur = _read32(src, s)[0]
                h = ((cur * _HASH_MULT) & _U32) >> shift
                ref = table[h]
                table[h] = s
                if not ((small or s - ref < MAX_DISTANCE)
                        and _read32(src, ref)[0] == cur):
                    break
                token_off = d
                d += 1
                token = 0
            anchor = s
            if s > mflimit:
                break
            s += 1

    run_len = src_end - anchor
    if d + run_len + 1 + (run_len + 255 - RUN_MASK) // 255 > dest_cap:
        return dest, d, ERR_DEST_TOO_SMALL
    if run_len >= RUN_MASK:
        put(d, RUN_MASK << ML_BITS)
        d = write_len(d + 1, run_len - RUN_MASK)
    else:
        put(d, run_len << ML_BITS)
        d += 1
    put_run(d, src[anchor:src_end])
    return dest, d + run_len, OK


def compress_fast_plain(src: torch.Tensor, src_lens: torch.Tensor,
                        dest_cap: int):
    """Plain version of :func:`compress_fast_batch`, on any device."""
    check_batch(src, src_lens)
    width = row_stride(dest_cap)
    src_np = src.cpu().numpy()
    lens = src_lens.cpu().tolist()
    dest = np.zeros((len(lens), width), np.uint8)
    out_lens = np.zeros((len(lens),), np.int32)
    err = np.zeros((len(lens),), np.int32)
    for i, n in enumerate(lens):
        row, out_lens[i], err[i] = _compress_row(src_np[i, :n].tobytes(), n,
                                                 dest_cap, width)
        dest[i] = np.frombuffer(row, np.uint8)
    dev = src.device
    return (torch.from_numpy(dest).to(dev), torch.from_numpy(out_lens).to(dev),
            torch.from_numpy(err).to(dev))


# ---------------------------------------------------------------------------
# fast-scan compress with a dictionary
# ---------------------------------------------------------------------------

def compress_dict_batch(src: torch.Tensor, src_lens: torch.Tensor,
                        dest_cap: int, dictionary: torch.Tensor,
                        dict_lens: torch.Tensor):
    """Batched fast-scan compression against a dictionary a row, byte for
    byte the native ``compress_ext`` (``tpulz4_compress_fast_ext``): row b's
    matches may reach into the last ``dict_lens[b]`` bytes of
    ``dictionary``'s row b (or its only row), up to 65,535 bytes back. One
    shared row holds a dictionary once for the whole batch (and, at one
    length for every row, its hash table is seeded once for the launch);
    rows whose dictionary is the content before them (a linked frame's
    blocks) pass a strided view of that content. A row with no dictionary
    is compressed by :func:`compress_fast_batch`'s algorithm, as the native
    function falls through to its plain compress.

    Returns (dest uint8[N, row_stride(dest_cap)], lens int32[N], err
    int32[N]) as :func:`compress_fast_batch` does.
    """
    check_batch(src, src_lens)
    if dest_cap < 0:
        raise ValueError("dest_cap must be >= 0")
    n = src.shape[0]
    stride, lo, hi = _check_window(dictionary, dict_lens, n, src.device,
                                   "dictionary")
    if src.device.type == "cpu":
        return compress_dict_plain(src, src_lens, dest_cap, dictionary,
                                   dict_lens)
    dest = torch.zeros((n, row_stride(dest_cap)), dtype=torch.uint8,
                       device=src.device)
    out_lens = torch.empty((n,), dtype=torch.int32, device=src.device)
    err = torch.empty((n,), dtype=torch.int32, device=src.device)
    seed_len = hi if stride == 0 and lo == hi > 0 else -1
    seed = SEED.take(src, SEED_WORDS) if seed_len > 0 else None
    COMPRESS_DICT(src.data_ptr(), src.stride(0), src_lens.data_ptr(),
                  dictionary.data_ptr() + dictionary.shape[1], stride,
                  dict_lens.data_ptr(), dest.data_ptr(), dest.stride(0),
                  dest_cap, out_lens.data_ptr(), err.data_ptr(), n,
                  seed.data_ptr() if seed is not None else None, seed_len,
                  cuda_stream(src), device=src.device.index)
    return dest, out_lens, err


def _len_ext_bytes(length: int) -> int:
    """``len_ext_bytes`` of ``tpulz4.cpp:186``: the bytes a length takes
    past its token's nibble."""
    return (length - 15) // 255 + 1 if length >= 15 else 0


def _compress_row_dict(win: bytes, h: int, src_len: int, dest_cap: int,
                       width: int):
    """Compress the block ``win[h:]`` with the dictionary ``win[:h]``;
    returns (dest bytearray[width], length, err).

    ``compress_ext`` (``tpulz4.cpp:416-542``) in positions from the
    window's start; writes at or past ``width`` are dropped, as the kernel
    drops them. ``h`` 0 is :func:`_compress_row`.
    """
    if h == 0:
        return _compress_row(win, src_len, dest_cap, width)
    dest = bytearray(width)

    def put(pos, v):
        if pos < width:
            dest[pos] = v

    def put_run(pos, data):
        if pos < width:
            dest[pos:pos + len(data)] = data[:width - pos]

    def write_len(d, length):
        while length >= 0xFF:
            put(d, 0xFF)
            d += 1
            length -= 0xFF
        put(d, length)
        return d + 1

    def hash12(v):
        return ((v * _HASH_MULT) & _U32) >> (32 - HASH_LOG)

    def bad(ip, ref):
        back = ip - ref
        return (back >= MAX_DISTANCE or back == 0
                or _read32(win, ref)[0] != _read32(win, ip)[0])

    send = h + src_len
    slimit = send - LAST_LITERALS
    mflimit = send - MF_LIMIT
    anchor = ip = h
    d = 0
    table = [0] * (1 << HASH_LOG)
    for p in range(0, h - 3, 3):
        table[hash12(_read32(win, p)[0])] = p

    if src_len >= MIN_LENGTH:
        while True:
            fwd, step, nb = ip, 1, 1 << SKIP_STRENGTH
            while True:
                ip = fwd
                fwd += step
                step = nb >> SKIP_STRENGTH
                nb += 1
                if fwd > mflimit:
                    break
                hh = hash12(_read32(win, ip)[0])
                ref = table[hh]
                table[hh] = ip
                if not bad(ip, ref):
                    break
            if fwd > mflimit:
                break
            while ip > anchor and ref > 0 and win[ip - 1] == win[ref - 1]:
                ip -= 1
                ref -= 1
            run_len = ip - anchor
            token_off = d
            d += 1
            if (d + run_len + (2 + 1 + LAST_LITERALS)
                    + _len_ext_bytes(run_len) > dest_cap):
                return dest, d, ERR_DEST_TOO_SMALL
            if run_len >= RUN_MASK:
                token = RUN_MASK << ML_BITS
                d = write_len(d, run_len - RUN_MASK)
            else:
                token = run_len << ML_BITS
            put_run(d, win[anchor:ip])
            d += run_len
            while True:
                back = ip - ref
                put(d, back & 0xFF)
                put(d + 1, (back >> 8) & 0xFF)
                d += 2
                ip += MIN_MATCH
                match_len = _common_bytes(win, ref + MIN_MATCH, ip, slimit)
                if d + (1 + LAST_LITERALS) + _len_ext_bytes(match_len) > \
                        dest_cap:
                    return dest, d, ERR_DEST_TOO_SMALL
                ip += match_len
                if match_len >= ML_MASK:
                    token |= ML_MASK
                    d = write_len(d, match_len - ML_MASK)
                else:
                    token |= match_len
                put(token_off, token)
                if ip > mflimit:
                    break
                table[hash12(_read32(win, ip - 2)[0])] = ip - 2
                hh = hash12(_read32(win, ip)[0])
                ref = table[hh]
                table[hh] = ip
                if bad(ip, ref):
                    break
                token_off = d
                d += 1
                token = 0
            anchor = ip
            if ip > mflimit:
                break
            ip += 1

    run_len = send - anchor
    if d + run_len + 1 + (run_len + 255 - RUN_MASK) // 255 > dest_cap:
        return dest, d, ERR_DEST_TOO_SMALL
    if run_len >= RUN_MASK:
        put(d, RUN_MASK << ML_BITS)
        d = write_len(d + 1, run_len - RUN_MASK)
    else:
        put(d, run_len << ML_BITS)
        d += 1
    put_run(d, win[anchor:send])
    return dest, d + run_len, OK


def compress_dict_plain(src: torch.Tensor, src_lens: torch.Tensor,
                        dest_cap: int, dictionary: torch.Tensor,
                        dict_lens: torch.Tensor):
    """Plain version of :func:`compress_dict_batch`, on any device."""
    check_batch(src, src_lens)
    n = src.shape[0]
    _check_window(dictionary, dict_lens, n, src.device, "dictionary")
    dicts = _window_rows(dictionary, dict_lens, n)
    width = row_stride(dest_cap)
    src_np = src.cpu().numpy()
    lens = src_lens.cpu().tolist()
    dest = np.zeros((n, width), np.uint8)
    out_lens = np.zeros((n,), np.int32)
    err = np.zeros((n,), np.int32)
    for i, k in enumerate(lens):
        row, out_lens[i], err[i] = _compress_row_dict(
            dicts[i] + src_np[i, :k].tobytes(), len(dicts[i]), k, dest_cap,
            width)
        dest[i] = np.frombuffer(row, np.uint8)
    dev = src.device
    return (torch.from_numpy(dest).to(dev), torch.from_numpy(out_lens).to(dev),
            torch.from_numpy(err).to(dev))
