"""Batched XXH32 over ragged blocks: the K3 kernel and its plain version.

Counterpart of ``lz4_tpu/kernels/xxhash_jax.py::xxh32_batch`` (``:85-147``)
and of the Pallas tile kernel ``xxhash_pallas.py::xxh32_words_pallas``. A
CUDA tensor goes to the kernel, a CPU tensor to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.constants import PRIME1, PRIME2, PRIME3, PRIME4, PRIME5
from .build import Kernel
from .layout import check_batch, cuda_stream

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
XXH32 = Kernel("xxh32", "xxh32", "lz4tt_xxh32_batch",
               [_P, _I64, _P, ctypes.c_uint, _P, _I32, _P])

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
    if data.shape[1] % 16 or data.data_ptr() % 16:
        raise ValueError("rows must be 16-byte aligned with a stride that "
                         "is a multiple of 16")
    n = data.shape[0]
    out = torch.empty((n,), dtype=torch.uint32, device=data.device)
    XXH32(data.data_ptr(), data.stride(0), lengths.data_ptr(), seed & _M,
          out.data_ptr(), n, cuda_stream(data))
    return out


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
    n, width = data.shape
    if width % 4 or width == 0:
        data = torch.nn.functional.pad(data, (0, 4 - width % 4))
    words = data.view(torch.int32)
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
