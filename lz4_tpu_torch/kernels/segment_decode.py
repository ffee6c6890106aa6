"""Batched LZ4 decode from sequence tables: the K5 kernel and its plain
version.

Counterpart of ``lz4_tpu/kernels/segment_decode.py``:
``decompress_segments`` computes what ``decompress_segments_pallas``
(``:156-221``) computes, and ``decompress_blocks`` mirrors its host
convenience (``:224-248``), with the tables built on the card by the port's
parser (``kernels/sequences.py``).

Two differences from the JAX package, both on inputs it does not define:

- The JAX kernel trusts its tables. K5 holds every sequence to its row and
  to the order of the output: each record's positions ``lit_out``,
  ``lit_out + lit_len``, ``m_out``, ``m_out + m_len`` may not go back, nor
  start before the previous record's ``m_out + m_len``; its literals stay
  inside the compressed block, its match after its source and inside the
  row. A block with a sequence that fails is ``ERR_MALFORMED`` and decodes
  to zeros. Tables from the parser always pass.
- ``decompress_blocks`` raises ``Lz4Error`` when a block decodes past
  ``out_len``. The JAX one never compares the parser's total with
  ``out_len`` and returns the row cut at ``out_len + PAD`` bytes.

The output is bytes, ``uint8[N, row_stride(out_max)]`` (the JAX kernel's
is one byte per int32). Bytes no sequence writes, below ``out_max``, are
zeros.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import Lz4Error
from .build import Kernel
from .codec import ERR_MALFORMED, OK, _decode_out
from .layout import check_batch, cuda_stream, from_device_layout, to_device_layout
from .sequences import parse_sequences
from ..utils.profiling import part, readback

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
SEGMENT = Kernel("segment_decode", "segment_decode", "lz4tt_decompress_segments",
                 [_P, _I64, _P, _P, _P, _I32, _P, _I64, _I32, _P, _I32, _P])


def _check_tables(comp, n_seq, tables) -> None:
    n = comp.shape[0]
    if (tables.dtype != torch.int32 or tables.dim() != 3
            or tables.shape[:2] != (6, n) or not tables.is_contiguous()):
        raise ValueError("tables must be a contiguous int32[6, N, S] tensor")
    if (n_seq.dtype != torch.int32 or n_seq.shape != (n,)
            or not n_seq.is_contiguous()):
        raise ValueError("n_seq must be a contiguous int32[N] tensor")
    if tables.device != comp.device or n_seq.device != comp.device:
        raise ValueError("comp, n_seq and tables must be on one device")


def decompress_segments(comp: torch.Tensor, comp_lens: torch.Tensor,
                        n_seq: torch.Tensor, tables: torch.Tensor,
                        out_max: int, out: torch.Tensor | None = None):
    """Decode a batch from its sequence tables.

    Args:
      comp: uint8[N, W] compressed blocks; comp_lens: int32[N] exact sizes.
      n_seq: int32[N] sequence counts; tables: int32[6, N, S]
        (``sequences.parse_sequences``).
      out_max: the most bytes a block may decode to.
      out: optional uint8[N, >= out_max] buffer; bytes at and past
        ``out_max`` in each row are never written.

    Returns:
      (out uint8[N, row_stride(out_max)] (or ``out``), err int32[N]):
      ``OK``, or ``ERR_MALFORMED`` for a block whose ``n_seq`` is negative
      or above S, or with a sequence that leaves its row or goes back in
      it.
    """
    check_batch(comp, comp_lens)
    _check_tables(comp, n_seq, tables)
    out = _decode_out(comp, out_max, out)
    if comp.device.type == "cpu":
        return decompress_segments_plain(comp, comp_lens, n_seq, tables,
                                         out_max, out)
    n = comp.shape[0]
    err = torch.empty((n,), dtype=torch.int32, device=comp.device)
    if n:
        SEGMENT(comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(),
                n_seq.data_ptr(), tables.data_ptr(), tables.shape[2],
                out.data_ptr(), out.stride(0), out_max, err.data_ptr(), n,
                cuda_stream(comp), device=comp.device.index)
    return out, err


def _segment_row(comp: bytes, seq: np.ndarray, n_seq: int, out: bytearray,
                 out_max: int) -> int:
    """Decode one row into ``out[:out_max]`` from ``seq`` (int32[6, S]);
    returns the error code. Every sequence is checked first; then all
    literal runs, then the matches in order, which with ordered sequences
    gives the bytes of a front-to-back decode."""
    out[:out_max] = bytes(out_max)
    if not 0 <= n_seq <= seq.shape[1]:
        return ERR_MALFORMED
    lit_out, lit_src, lit_len, m_out, m_dist, m_len = \
        (seq[f, :n_seq].tolist() for f in range(6))
    prev = 0
    for k in range(n_seq):
        lo, ll, mo, ml = lit_out[k], lit_len[k], m_out[k], m_len[k]
        if (ll < 0 or ml < 0 or lo < prev or lo + ll > mo or mo + ml > out_max
                or ll and (lit_src[k] < 0 or lit_src[k] + ll > len(comp))
                or ml and (m_dist[k] < 1 or mo - m_dist[k] < 0)):
            return ERR_MALFORMED
        prev = mo + ml
    for k in range(n_seq):
        ll = lit_len[k]
        out[lit_out[k]:lit_out[k] + ll] = comp[lit_src[k]:lit_src[k] + ll]
    for k in range(n_seq):
        d, dist, ml = m_out[k], m_dist[k], m_len[k]
        if ml > 0:
            period = bytes(out[d - dist:d])
            out[d:d + ml] = (period * (ml // dist + 1))[:ml]
    return OK


def decompress_segments_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                              n_seq: torch.Tensor, tables: torch.Tensor,
                              out_max: int, out: torch.Tensor | None = None):
    """Plain version of :func:`decompress_segments`, on any device: a loop
    over each row's sequences, on the host."""
    check_batch(comp, comp_lens)
    _check_tables(comp, n_seq, tables)
    out = _decode_out(comp, out_max, out)
    comp_np = comp.cpu().numpy()
    lens = comp_lens.cpu().tolist()
    counts = n_seq.cpu().tolist()
    seq = tables.cpu().numpy()
    rows = out[:, :out_max].cpu().numpy()
    err = np.zeros((len(lens),), np.int32)
    for i, n in enumerate(lens):
        buf = bytearray(rows[i].tobytes())
        err[i] = _segment_row(comp_np[i, :n].tobytes(), seq[:, i], counts[i],
                              buf, out_max)
        rows[i] = np.frombuffer(buf, np.uint8)
    out[:, :out_max] = torch.from_numpy(rows).to(out.device)
    return out, torch.from_numpy(err).to(comp.device)


def decompress_rows(comp: torch.Tensor, comp_lens: torch.Tensor,
                    out_len: int):
    """Parse a batch in the port's layout on its device and decode it there
    with K5: one parser launch and one K5 launch, the packed decode of the
    ``segment`` engine. It does not read the codes back: the caller may
    queue more work before it calls ``finish``.

    Returns ``(out uint8[N, row_stride(out_len)] on the device, finish)``.
    ``finish()`` reads the counts, totals and codes back in one copy and
    returns the totals (``int32[N]`` numpy); it raises ``Lz4Error`` on the
    first block the parser refuses, then on the first that decodes past
    ``out_len`` (the JAX package truncates it), then on the first K5
    refuses. K5 checks every sequence, so such blocks are launched as they
    are.
    """
    with part("kernels"):
        tables, n_seq, out_total = parse_sequences(comp, comp_lens)
        out, err = decompress_segments(comp, comp_lens, n_seq, tables,
                                       out_len)

    def finish() -> np.ndarray:
        with part("check"), readback("decompress_rows", err):
            counts, totals, codes = torch.stack(
                (n_seq, out_total, err)).cpu().numpy()
        bad = np.flatnonzero(counts < 0)
        if bad.size:
            i = int(bad[0])
            raise Lz4Error(f"Malformed input in block {i} "
                           f"(parse code {int(counts[i])})")
        over = np.flatnonzero(totals > out_len)
        if over.size:
            i = int(over[0])
            raise Lz4Error(f"Malformed input in block {i}: it decodes to "
                           f"{int(totals[i])} bytes, past {out_len}")
        bad = np.flatnonzero(codes)
        if bad.size:
            raise Lz4Error(f"Malformed input in block {int(bad[0])}")
        return totals

    return out, finish


def decompress_blocks(blocks: list[bytes], out_len: int,
                      device: str | torch.device = "cuda") -> list[bytes]:
    """Parse on ``device``, decode there with K5, and return the blocks
    (:func:`decompress_rows`, with its errors)."""
    dev = resolve_device(device)
    if not blocks:
        return []
    with part("upload"):
        comp, comp_lens = to_device_layout(blocks, device=dev)
    out, finish = decompress_rows(comp, comp_lens, out_len)
    out_total = finish()
    with part("download"):
        return from_device_layout(out, out_total)
