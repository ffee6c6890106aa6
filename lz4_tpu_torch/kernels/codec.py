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
from .build import Kernel
from .layout import check_batch, cuda_stream, row_stride

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


# ---------------------------------------------------------------------------
# safe decode
# ---------------------------------------------------------------------------

def decompress_safe_batch(comp: torch.Tensor, comp_lens: torch.Tensor,
                          out_max: int, out: torch.Tensor | None = None):
    """Batched safe decompression (exact compressed sizes known).

    Args:
      comp: uint8[N, S] compressed blocks; comp_lens: int32[N] exact sizes.
      out_max: the most bytes a block may decode to.
      out: optional uint8[N, >= out_max] buffer to decode into; bytes at
        and past ``out_max`` in each row are never written.

    Returns:
      (out uint8[N, row_stride(out_max)] (or ``out``), out_lens int32[N],
      err int32[N]).
    """
    check_batch(comp, comp_lens)
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
                fast: bool = False):
    """Decode one block into ``out[:dest_cap]``; returns (out_len, src_read,
    err).

    The classification of ``jax_codec._decompress_one``, safe or fast
    variant (see ``csrc/lz4_decode.cuh``); a null match offset writes zeros.
    In the fast variant ``src_end`` is the bytes available and ``dest_cap``
    the exact decoded length. ``src_read`` counts only on OK rows.
    """
    if dest_cap == 0:
        if fast:
            return 0, 1, OK if comp[0] == 0 else ERR_MALFORMED
        ok = src_end == 1 and comp[0] == 0
        return 0, 1, OK if ok else ERR_DEST_TOO_SMALL
    s = d = 0
    while True:
        if s >= src_end:
            return d, s, ERR_MALFORMED
        token = comp[s]
        s += 1
        lit_len = token >> ML_BITS
        if lit_len == RUN_MASK:
            s, lit_len = _len_ext(comp, s, src_end, lit_len)
        lit_end = d + lit_len
        if fast:
            if s + lit_len > src_end:
                return d, s, ERR_MALFORMED
            if lit_end > dest_cap - COPY_LENGTH:
                if lit_end != dest_cap:
                    return d, s, ERR_MALFORMED
                out[d:lit_end] = comp[s:s + lit_len]
                return lit_end, s + lit_len, OK
        elif (lit_end > dest_cap - COPY_LENGTH
                or s + lit_len > src_end - COPY_LENGTH):
            if lit_end > dest_cap:
                return d, s, ERR_DEST_TOO_SMALL
            if s + lit_len != src_end:
                return d, s, ERR_MALFORMED
            out[d:lit_end] = comp[s:src_end]
            return lit_end, src_end, OK
        out[d:lit_end] = comp[s:s + lit_len]
        s += lit_len
        d = lit_end

        if s + 2 > src_end:
            return d, s, ERR_MALFORMED
        dist = comp[s] | (comp[s + 1] << 8)
        s += 2
        m_len = token & ML_MASK
        if m_len == ML_MASK:
            s, m_len = _len_ext(comp, s, src_end, m_len)
        m_len += MIN_MATCH
        m_end = d + m_len
        if d - dist < 0 or m_end > dest_cap:
            return d, s, ERR_MALFORMED
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
    check_batch(comp, comp_lens)
    out = _decode_out(comp, out_max, out)
    comp_np = comp.cpu().numpy()
    lens = comp_lens.cpu().tolist()
    rows = out[:, :out_max].cpu().numpy()
    out_lens = np.zeros((len(lens),), np.int32)
    err = np.zeros((len(lens),), np.int32)
    for i, n in enumerate(lens):
        buf = bytearray(rows[i].tobytes())
        out_lens[i], _, err[i] = _decode_row(comp_np[i, :n].tobytes(), n, buf,
                                             out_max)
        rows[i] = np.frombuffer(buf, np.uint8)
    out[:, :out_max] = torch.from_numpy(rows).to(out.device)
    dev = comp.device
    return (out, torch.from_numpy(out_lens).to(dev),
            torch.from_numpy(err).to(dev))


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
        exact compressed length (the fast contract's point).
      dest_len: the exact decoded length of every block.
      out: optional uint8[N, >= dest_len] buffer to decode into; bytes at
        and past ``dest_len`` in each row are never written.

    Returns:
      (out uint8[N, row_stride(dest_len)] (or ``out``), src_read int32[N]
      (meaningful on OK rows), err int32[N]).
    """
    check_batch(comp, comp_avail)
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
    check_batch(comp, comp_avail)
    if comp.shape[1] == 0:
        raise ValueError("rows of comp must hold at least one byte")
    out = _decode_out(comp, dest_len, out)
    comp_np = comp.cpu().numpy()
    avail = comp_avail.cpu().tolist()
    rows = out[:, :dest_len].cpu().numpy()
    src_read = np.zeros((len(avail),), np.int32)
    err = np.zeros((len(avail),), np.int32)
    for i, n in enumerate(avail):
        buf = bytearray(rows[i].tobytes())
        _, src_read[i], err[i] = _decode_row(
            comp_np[i, :max(n, 1)].tobytes(), n, buf, dest_len, fast=True)
        rows[i] = np.frombuffer(buf, np.uint8)
    out[:, :dest_len] = torch.from_numpy(rows).to(out.device)
    dev = comp.device
    return (out, torch.from_numpy(src_read).to(dev),
            torch.from_numpy(err).to(dev))


# ---------------------------------------------------------------------------
# fast-scan compress
# ---------------------------------------------------------------------------

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
