"""Batched XXH32 and XXH64 over ragged blocks: the K3 and K4 kernels and
their plain versions.

Counterparts of ``lz4_tpu/kernels/xxhash_jax.py::xxh32_batch``
(``:85-147``) and ``xxh64_batch`` (``:151-241``), and of the Pallas tile
kernels ``xxhash_pallas.py::xxh32_words_pallas`` and
``xxhash64_pallas.py::xxh64_words_pallas``. A CUDA tensor goes to the
kernel, a CPU tensor to the plain version.

XXH64 hashes are u64 values held as int64 bit patterns, since torch's
``uint64`` supports few operations. :func:`split_u64` and :func:`join_u64`
carry them to and from the JAX package's ``(hi, lo)`` uint32 pairs.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.constants import (
    PRIME1, PRIME2, PRIME3, PRIME4, PRIME5,
    PRIME64_1, PRIME64_2, PRIME64_3, PRIME64_4, PRIME64_5, U64,
)
from .build import Kernel
from .layout import check_batch, cuda_stream

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
XXH32 = Kernel("xxh32", "xxh32", "lz4tt_xxh32_batch",
               [_P, _I64, _P, ctypes.c_uint, _P, _I32, _P])
XXH64 = Kernel("xxh64", "xxh64", "lz4tt_xxh64_batch",
               [_P, _I64, _P, ctypes.c_ulonglong, _P, _I32, _P])

_M = 0xFFFFFFFF


def xxh32_batch(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """XXH32 of each row's first ``lengths[i]`` bytes.

    Args:
      data: uint8[N, S]; on the card, S a multiple of 16 and 16-byte
        aligned (the port's layout is).
      lengths: int32[N] within [0, S].
      seed: masked to 32 bits.

    Returns: uint32[N].
    """
    check_batch(data, lengths)
    if data.device.type == "cpu":
        return xxh32_plain(data, lengths, seed)
    _check_aligned(data)
    n = data.shape[0]
    out = torch.empty((n,), dtype=torch.uint32, device=data.device)
    XXH32(data.data_ptr(), data.stride(0), lengths.data_ptr(), seed & _M,
          out.data_ptr(), n, cuda_stream(data),
          device=data.device.index)
    return out


def _check_aligned(data: torch.Tensor) -> None:
    if data.shape[1] % 16 or data.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned with a stride that "
                         "is a multiple of 16")


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32), without int64 overflow."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M


def _rotl32(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & _M


def xxh32_plain(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """Plain version of :func:`xxh32_batch`, vectorised over blocks on the
    tensors' device: int64 arithmetic masked to 32 bits, one step per
    16-byte stripe of the longest block, shorter blocks masked out."""
    check_batch(data, lengths)
    dev = data.device
    n = data.shape[0]
    data, words = _words(data)
    lens = lengths.to(torch.int64)
    seed &= _M

    n_stripes = lens // 16
    v = (torch.tensor([seed + PRIME1 + PRIME2, seed + PRIME2, seed,
                       seed - PRIME1], dtype=torch.int64, device=dev) & _M)
    v = v.expand(n, 4).clone()
    for i in range(int(n_stripes.max()) if n else 0):
        x = words[:, 4 * i:4 * i + 4].to(torch.int64) & _M
        nv = _mul32(_rotl32((v + _mul32(x, PRIME2)) & _M, 13), PRIME1)
        v = torch.where((i < n_stripes).unsqueeze(1), nv, v)

    conv = (_rotl32(v[:, 0], 1) + _rotl32(v[:, 1], 7) + _rotl32(v[:, 2], 12)
            + _rotl32(v[:, 3], 18)) & _M
    h = torch.where(lens >= 16, conv, torch.full_like(conv, (seed + PRIME5) & _M))
    h = (h + lens) & _M

    tail = lens - n_stripes * 16
    n_words = tail // 4
    for j in range(3):
        idx = torch.clamp(n_stripes * 4 + j, max=words.shape[1] - 1)
        x = words.gather(1, idx.unsqueeze(1)).squeeze(1).to(torch.int64) & _M
        nh = _mul32(_rotl32((h + _mul32(x, PRIME3)) & _M, 17), PRIME4)
        h = torch.where(j < n_words, nh, h)
    start = n_stripes * 16 + n_words * 4
    for k in range(3):
        idx = torch.clamp(start + k, max=data.shape[1] - 1)
        x = data.gather(1, idx.unsqueeze(1)).squeeze(1).to(torch.int64)
        nh = _mul32(_rotl32((h + _mul32(x, PRIME5)) & _M, 11), PRIME1)
        h = torch.where(k < tail - n_words * 4, nh, h)

    h = h ^ (h >> 15)
    h = _mul32(h, PRIME2)
    h = h ^ (h >> 13)
    h = _mul32(h, PRIME3)
    h = h ^ (h >> 16)
    return h.to(torch.uint32)


def _words(data: torch.Tensor):
    """``data`` padded to a whole number of 4-byte words, and its words."""
    width = data.shape[1]
    if width % 4 or width == 0:
        data = torch.nn.functional.pad(data, (0, 4 - width % 4))
    return data, data.view(torch.int32)


# ---------------------------------------------------------------------------
# XXH64
# ---------------------------------------------------------------------------

def xxh64_batch(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """XXH64 of each row's first ``lengths[i]`` bytes.

    Args:
      data: uint8[N, S]; on the card, S a multiple of 16 and 16-byte
        aligned (the port's layout is).
      lengths: int32[N] within [0, S].
      seed: any integer, masked to 64 bits.

    Returns: int64[N], each the u64 hash as a bit pattern
    (:func:`split_u64` gives the ``(hi, lo)`` pair).
    """
    check_batch(data, lengths)
    if data.device.type == "cpu":
        return xxh64_plain(data, lengths, seed)
    _check_aligned(data)
    n = data.shape[0]
    out = torch.empty((n,), dtype=torch.int64, device=data.device)
    XXH64(data.data_ptr(), data.stride(0), lengths.data_ptr(), seed & U64,
          out.data_ptr(), n, cuda_stream(data),
          device=data.device.index)
    return out


def split_u64(h: torch.Tensor):
    """int64 bit patterns -> ``(hi, lo)`` uint32 tensors, the JAX package's
    form of a u64 (``xxhash_jax.xxh64_batch``)."""
    return ((h >> 32) & _M).to(torch.uint32), (h & _M).to(torch.uint32)


def join_u64(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """``(hi, lo)`` 32-bit halves (any integer dtype) -> int64 bit
    patterns."""
    hi = hi.to(torch.int64) & _M
    lo = lo.to(torch.int64) & _M
    return (hi - ((hi >> 31) << 32)) * (1 << 32) + lo   # no int64 overflow


# The plain XXH64 holds each u64 as a (hi, lo) pair of int64 tensors in
# [0, 2^32), the way lz4_tpu/kernels/u64_emul.py does, so that no int64
# operation overflows and no shift brings in sign bits.

def _add64(a, b):
    lo = a[1] + b[1]
    return (a[0] + b[0] + (lo >> 32)) & _M, lo & _M


def _xor64(a, b):
    return a[0] ^ b[0], a[1] ^ b[1]


def _mul64c(a, c: int):
    """(a * c) mod 2^64 for a constant c."""
    hi, lo = a
    ch, cl = c >> 32, c & _M
    l0, l1 = lo & 0xFFFF, lo >> 16
    c0, c1 = cl & 0xFFFF, cl >> 16
    p00 = l0 * c0
    mid = l0 * c1 + l1 * c0 + (p00 >> 16)
    new_lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    new_hi = (l1 * c1 + (mid >> 16) + _mul32(hi, cl) + _mul32(lo, ch)) & _M
    return new_hi, new_lo


def _rotl64(a, r: int):
    hi, lo = a                                  # 0 < r < 32
    return (((hi << r) | (lo >> (32 - r))) & _M,
            ((lo << r) | (hi >> (32 - r))) & _M)


def _shr64(a, r: int):
    hi, lo = a                                  # 32 <= r < 64 or 0 < r < 32
    if r >= 32:
        return torch.zeros_like(hi), hi >> (r - 32)
    return hi >> r, ((lo >> r) | (hi << (32 - r))) & _M


def _const64(c: int, like: torch.Tensor):
    c &= U64
    return torch.full_like(like, c >> 32), torch.full_like(like, c & _M)


def _round64(v, x):
    return _mul64c(_rotl64(_add64(v, _mul64c(x, PRIME64_2)), 31), PRIME64_1)


def _where64(cond, a, b):
    return torch.where(cond, a[0], b[0]), torch.where(cond, a[1], b[1])


def xxh64_plain(data: torch.Tensor, lengths: torch.Tensor,
                seed: int = 0) -> torch.Tensor:
    """Plain version of :func:`xxh64_batch`, vectorised over blocks on the
    tensors' device: u64 values as (hi, lo) pairs of 32-bit limbs, one step
    per 32-byte stripe of the longest block, shorter blocks masked out."""
    check_batch(data, lengths)
    n = data.shape[0]
    data, words = _words(data)
    lens = lengths.to(torch.int64)
    seed &= U64
    zero = torch.zeros_like(lens)

    n_stripes = lens // 32
    init = [seed + PRIME64_1 + PRIME64_2, seed + PRIME64_2, seed,
            seed - PRIME64_1]
    v = [_const64(c, zero) for c in init]
    for i in range(int(n_stripes.max()) if n else 0):
        x = words[:, 8 * i:8 * i + 8].to(torch.int64) & _M
        active = i < n_stripes
        v = [_where64(active, _round64(v[k], (x[:, 2 * k + 1], x[:, 2 * k])),
                      v[k]) for k in range(4)]

    conv = _add64(_add64(_rotl64(v[0], 1), _rotl64(v[1], 7)),
                  _add64(_rotl64(v[2], 12), _rotl64(v[3], 18)))
    for vk in v:
        conv = _add64(_mul64c(_xor64(conv, _round64(_const64(0, zero), vk)),
                              PRIME64_1), _const64(PRIME64_4, zero))
    h = _where64(lens >= 32, conv, _const64(seed + PRIME64_5, zero))
    h = _add64(h, (zero, lens))

    def word(idx):
        idx = torch.clamp(idx, max=words.shape[1] - 1)
        return words.gather(1, idx.unsqueeze(1)).squeeze(1).to(torch.int64) & _M

    tail = lens - n_stripes * 32
    n_tail64 = tail // 8
    for j in range(3):
        start = n_stripes * 8 + 2 * j
        k1 = _round64(_const64(0, zero), (word(start + 1), word(start)))
        nh = _add64(_mul64c(_rotl64(_xor64(h, k1), 27), PRIME64_1),
                    _const64(PRIME64_4, zero))
        h = _where64(j < n_tail64, nh, h)
    rem = tail - n_tail64 * 8
    has4 = rem >= 4
    x = word(n_stripes * 8 + n_tail64 * 2)
    nh = _add64(_mul64c(_rotl64(_xor64(h, _mul64c((zero, x), PRIME64_1)), 23),
                        PRIME64_2), _const64(PRIME64_3, zero))
    h = _where64(has4, nh, h)
    start = n_stripes * 32 + n_tail64 * 8 + torch.where(has4, 4, 0)
    n_bytes = rem - torch.where(has4, 4, 0)
    for k in range(3):
        idx = torch.clamp(start + k, max=data.shape[1] - 1)
        b = data.gather(1, idx.unsqueeze(1)).squeeze(1).to(torch.int64)
        nh = _mul64c(_rotl64(_xor64(h, _mul64c((zero, b), PRIME64_5)), 11),
                     PRIME64_1)
        h = _where64(k < n_bytes, nh, h)

    h = _xor64(h, _shr64(h, 33))
    h = _mul64c(h, PRIME64_2)
    h = _xor64(h, _shr64(h, 29))
    h = _mul64c(h, PRIME64_3)
    h = _xor64(h, _shr64(h, 32))
    return join_u64(*h)
