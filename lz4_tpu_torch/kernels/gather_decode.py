"""The gather decode: LZ4 blocks decoded from the parser's sequence tables
by pointer doubling; the K8 kernel and its plain version.

Counterpart of ``lz4_tpu/kernels/gather_decode.py``. Each output byte gets
its source: a literal byte a position in the compressed row, a match byte
the periodic parent ``base + ((j - base) mod d)`` in the output before it;
synchronous pointer-doubling rounds, at most ``max_depth``, carry every
match byte back to a literal origin; bytes left without one (null offsets,
past a block's end, chains longer than the rounds reach) decode as zeros.

- :func:`parse_packed` and :func:`parse_blocks` run the port's parser on
  the card (``kernels/sequences.py``) with the sentinel tails of the JAX
  module's native parser (``SENTINEL`` past each block's sequences);
- :func:`gather_decompress_batch` runs K8 (``csrc/gather_decode.cu``) on a
  CUDA tensor and :func:`gather_decompress_plain`, the JAX function's
  searchsorted form in torch ops, on a CPU tensor; there is no fallback
  from one to the other. K8 has each sequence write its own bytes, which is
  the same on the parser's tables (in output order, ranges apart, tails
  of length 0), keeps a 4-byte node a byte and runs its rounds over the
  open nodes only: in place when ``2 ** max_depth >= out_len`` (every
  chain that ends is then followed to its end), synchronous below that,
  so that a small ``max_depth`` cuts the chains where the JAX function
  does;
- :func:`decompress_blocks` parses and decodes on one device; as the JAX
  function does, it returns a block that decodes past ``out_len`` cut to
  ``out_len`` bytes.

Pointers that tables make outside the row (not the parser's) are clamped
into it, a negative one counted from the end first, by both versions.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.device import resolve_device
from .build import Kernel, Scratch, c_function, resident_ctas
from .layout import cuda_stream, from_device_layout, to_device_layout
from .sequences import (
    TABLES, max_seq_for, parse_sequences, raise_on_parse_error)

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
GATHER = Kernel("gather_decode", "gather_decode", "lz4tt_gather_decode",
                [_P, _I64, _I32] + [_P] * 6
                + [_I32, _P, _I64, _I32, _I32, _P, _I32, _I32, _P])

SCRATCH = Scratch(torch.int32)


def parse_packed(comp, comp_offsets, comp_lens, max_seq: int,
                 sentinel_tails: bool = True,
                 device: str | torch.device = "cuda"):
    """Parse packed compressed blocks (block i at ``comp[comp_offsets[i]:
    + comp_lens[i]]``, a bytes-like) into sequence tables on ``device``.

    Returns (dict name -> int32[N, max_seq], n_seq int32[N], out_total
    int32[N]); raises ``Lz4Error`` naming the first malformed block. The
    JAX function's host threads and table reuse (``n_threads``, ``out``)
    have no counterpart: the parser runs on the card.
    """
    view = memoryview(comp).cast("B")
    blocks = [view[int(o):int(o) + int(n)]
              for o, n in zip(comp_offsets, comp_lens)]
    c, cl = to_device_layout(blocks, device=device)
    tables, n_seq, out_total = parse_sequences(c, cl, max_seq, sentinel_tails)
    raise_on_parse_error(n_seq)
    return dict(zip(TABLES, tables)), n_seq, out_total


def parse_blocks(blocks: list[bytes], max_seq: int | None = None,
                 device: str | torch.device = "cuda"):
    """:func:`parse_packed` of ``list[bytes]``; ``max_seq`` by default the
    JAX function's (``sequences.max_seq_for`` the longest block)."""
    if max_seq is None:
        max_seq = max_seq_for(max(len(b) for b in blocks))
    offsets = np.cumsum([0] + [len(b) for b in blocks[:-1]])
    return parse_packed(b"".join(blocks), offsets, [len(b) for b in blocks],
                        max_seq, device=device)


def resident_teams(index: int) -> int:
    """K8's teams (one CTA a block) that card ``index`` holds at once."""
    return resident_ctas("gather_decode", "lz4tt_gather_occupancy", index)


def team_words(out_len: int, max_seq: int) -> int:
    """int32 words of scratch a team needs (``lz4tt_gather_team_words``)."""
    fn = c_function("gather_decode", "lz4tt_gather_team_words", [_I32, _I32],
                    None)
    fn.restype = ctypes.c_longlong
    return fn(out_len, max_seq)


def _check(comp, tabs, out_len, max_depth):
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.stride(1) != 1:
        raise ValueError("comp must be a uint8[N, CMAX] tensor with "
                         "contiguous rows")
    n = comp.shape[0]
    shape = tabs[0].shape
    for t in tabs:
        if (t.dtype != torch.int32 or t.dim() != 2 or t.shape != shape
                or shape[0] != n or t.device != comp.device):
            raise ValueError("tables must be int32[N, S] tensors on the "
                             "device of comp")
    if out_len < 0 or max_depth < 0:
        raise ValueError("out_len and max_depth must be >= 0")


def gather_decompress_batch(comp: torch.Tensor, lit_out, lit_src, lit_len,
                            m_out, m_dist, m_len, out_len: int,
                            max_depth: int = 32) -> torch.Tensor:
    """Batched gather decode, byte for byte
    ``gather_decode.gather_decompress_batch``.

    Args:
      comp: uint8[N, CMAX] compressed bytes.
      lit_*/m_*: int32[N, S] sequence tables (:func:`parse_blocks`).
      out_len: decoded bytes a block; max_depth: the most doubling rounds.

    Returns: uint8[N, out_len] on the device of ``comp``.
    """
    tabs = [lit_out, lit_src, lit_len, m_out, m_dist, m_len]
    _check(comp, tabs, out_len, max_depth)
    if comp.device.type == "cpu":
        return gather_decompress_plain(comp, *tabs, out_len, max_depth)
    n, cmax = comp.shape
    max_seq = lit_out.shape[1]
    out = torch.empty((n, out_len), dtype=torch.uint8, device=comp.device)
    if n and out_len:
        if cmax < 1 or max_seq < 1:
            raise ValueError("comp and the tables need at least one column")
        tabs = [t.contiguous() for t in tabs]
        words = team_words(out_len, max_seq)
        teams, scratch = SCRATCH.teams(comp, n, resident_teams(
            comp.device.index), words)
        GATHER(comp.data_ptr(), comp.stride(0), cmax,
               *(t.data_ptr() for t in tabs), max_seq, out.data_ptr(),
               out.stride(0), out_len, max_depth, scratch.data_ptr(), teams,
               n, cuda_stream(comp), device=comp.device.index)
    return out


def gather_decompress_plain(comp: torch.Tensor, lit_out, lit_src, lit_len,
                            m_out, m_dist, m_len, out_len: int,
                            max_depth: int = 32) -> torch.Tensor:
    """Plain version of :func:`gather_decompress_batch`, on any device: the
    JAX function's ``_decode_one`` on the whole batch, searchsorted over
    the tables and synchronous rounds while a row has an unresolved
    byte."""
    tabs = [lit_out, lit_src, lit_len, m_out, m_dist, m_len]
    _check(comp, tabs, out_len, max_depth)
    n, cmax = comp.shape
    dev = comp.device
    if not n or not out_len:
        return torch.zeros((n, out_len), dtype=torch.uint8, device=dev)
    lit_out, lit_src, lit_len, m_out, m_dist, m_len = (t.long() for t in tabs)
    S = lit_out.shape[1]
    j = torch.arange(out_len, device=dev).expand(n, -1).contiguous()

    k = (torch.searchsorted(lit_out.contiguous(), j, right=True)
         - 1).clamp(0, S - 1)
    lbo = lit_out.gather(1, k)
    in_lit = (j - lbo) < lit_len.gather(1, k)
    idx = torch.where(in_lit, lit_src.gather(1, k) + (j - lbo), -1)

    q = (torch.searchsorted(m_out.contiguous(), j, right=True)
         - 1).clamp(0, S - 1)
    mo, md = m_out.gather(1, q), m_dist.gather(1, q)
    in_match = ~in_lit & ((j - mo) < m_len.gather(1, q)) & (md > 0)
    base = mo - md
    parent = torch.where(in_match,
                         base + torch.remainder(j - base, md.clamp(min=1)), j)
    parent = torch.where(parent < 0, parent + out_len, parent)
    parent = parent.clamp(0, out_len - 1)

    for _ in range(max_depth):
        active = ((idx < 0) & (parent != j)).any(1, keepdim=True)
        if not bool(active.any()):
            break
        new_idx = torch.where(idx >= 0, idx, idx.gather(1, parent))
        new_par = parent.gather(1, parent)
        idx = torch.where(active, new_idx, idx)
        parent = torch.where(active, new_par, parent)
    src = comp.gather(1, idx.clamp(0, cmax - 1)) if cmax else \
        torch.zeros_like(idx, dtype=torch.uint8)
    return torch.where(idx >= 0, src, 0).to(torch.uint8)


def decompress_blocks(blocks: list[bytes], out_len: int,
                      device: str | torch.device = "cuda") -> list[bytes]:
    """Parse on ``device`` and decode there with K8 (the plain version on
    the CPU); returns the blocks, each cut to ``out_len`` bytes. Raises
    ``Lz4Error`` on a malformed block."""
    dev = resolve_device(device)
    if not blocks:
        return []
    comp, comp_lens = to_device_layout(blocks, device=dev)
    tables, n_seq, out_total = parse_sequences(
        comp, comp_lens, max_seq_for(max(len(b) for b in blocks)),
        sentinel_tails=True)
    raise_on_parse_error(n_seq)
    out = gather_decompress_batch(comp, *tables, out_len)
    return from_device_layout(out, out_total.clamp(max=out_len))
