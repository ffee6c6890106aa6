"""The LZ4 sequence parser: per-sequence tables with absolute offsets, the
input of K5 (``kernels/segment_decode.py``), and its plain version.

Counterpart of ``lz4_tpu/kernels/gather_decode.py::parse_packed``
(``:50-103``) and ``parse_blocks`` (``:106-124``), which run the JAX
package's native C++ parser (``tpulz4_parse_sequences_batch``,
``lz4_tpu/native/src/tpulz4.cpp:1683-1805``) with zeroed tails. The port
parses on the card (``csrc/lz4_parse.cu``, one warp a block, 32 three-byte
sequences a step): the tables are about 8x the compressed bytes, and the
compressed bytes are on the card already.

Tables: ``int32[6, N, S]`` in the order of :data:`TABLES`, so that
``tables[i]`` is the JAX package's ``arrs[TABLES[i]]``. ``n_seq[i]`` is the
number of sequences of block ``i``, or a negative code: ``-2`` malformed,
``-3`` more than ``S`` sequences (``tpulz4.cpp:99-100``). ``out_total[i]`` is
the decoded length of an OK block, 0 otherwise. Entries past those a block
wrote are 0; on an error row the entries before the error stay. With
``sentinel_tails`` (the gather decode's tables, ``tpulz4.cpp``'s tail mode
2), ``lit_out`` and ``m_out`` past an OK block's sequences are
:data:`SENTINEL` instead, past any output offset.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..core.constants import MIN_MATCH, ML_BITS, ML_MASK, RUN_MASK
from ..core.errors import Lz4Error
from .build import Kernel
from .layout import check_batch, cuda_stream, to_device_layout

TABLES = ("lit_out", "lit_src", "lit_len", "m_out", "m_dist", "m_len")
PARSE_MALFORMED = -2
PARSE_TOO_MANY = -3
SENTINEL = 1 << 30
_LEN_CAP = 0x7E000000

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
PARSE = Kernel("lz4_parse", "lz4_parse", "lz4tt_parse_sequences",
               [_P, _I64, _P, _I32, _P, _P, _P, _I32, _I32, _P])


def max_seq_for(comp_max: int) -> int:
    """Table width for blocks of up to ``comp_max`` compressed bytes: every
    sequence but the last takes at least 3 bytes (``gather_decode.py:116``)."""
    return max(2, comp_max // 3 + 2)


def parse_sequences(comp: torch.Tensor, comp_lens: torch.Tensor,
                    max_seq: int | None = None, sentinel_tails: bool = False):
    """Parse a batch of compressed blocks into sequence tables.

    Args:
      comp: uint8[N, W] compressed blocks; comp_lens: int32[N] exact sizes.
      max_seq: table width S; by default :func:`max_seq_for` the longest
        block.
      sentinel_tails: :data:`SENTINEL` in the ``lit_out`` and ``m_out``
        tails of OK rows, else 0.

    Returns:
      (tables int32[6, N, S], n_seq int32[N], out_total int32[N]), on the
      device of ``comp``.
    """
    check_batch(comp, comp_lens)
    n = comp.shape[0]
    if max_seq is None:
        max_seq = max_seq_for(int(comp_lens.max()) if n else 0)
    if max_seq < 1:
        raise ValueError("max_seq must be >= 1")
    if comp.device.type == "cpu":
        return parse_plain(comp, comp_lens, max_seq, sentinel_tails)
    dev = comp.device
    # the kernel writes every entry, the zero tails included
    tables = torch.empty((6, n, max_seq), dtype=torch.int32, device=dev)
    n_seq = torch.empty((n,), dtype=torch.int32, device=dev)
    out_total = torch.empty((n,), dtype=torch.int32, device=dev)
    if n:
        PARSE(comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(), max_seq,
              tables.data_ptr(), n_seq.data_ptr(), out_total.data_ptr(), n,
              SENTINEL if sentinel_tails else 0, cuda_stream(comp),
              device=comp.device.index)
    return tables, n_seq, out_total


def _len_ext(src: bytes, s: int, end: int, length: int):
    """0xFF-run extension with the parser's cap; length None if malformed."""
    b = 0xFF
    while s < end:
        b = src[s]
        s += 1
        if b != 0xFF:
            break
        length += 0xFF
        if length >= _LEN_CAP:
            return s, None
    return s, length + b


def _parse_row(src: bytes, rows: np.ndarray, max_seq: int):
    """Parse one block into ``rows`` (int32[6, max_seq]); returns
    (n_seq or code, out_total)."""
    end = len(src)
    s = d = n = 0
    while True:
        if s >= end:
            return PARSE_MALFORMED, 0
        if n >= max_seq:
            return PARSE_TOO_MANY, 0
        token = src[s]
        s += 1
        lit_len = token >> ML_BITS
        if lit_len == RUN_MASK:
            s, lit_len = _len_ext(src, s, end, lit_len)
            if lit_len is None:
                return PARSE_MALFORMED, 0
        if s + lit_len > end:
            return PARSE_MALFORMED, 0
        rows[0:3, n] = (d, s, lit_len)
        s += lit_len
        d += lit_len
        if s == end:
            rows[3:6, n] = (d, 0, 0)
            return n + 1, d
        if s + 2 > end:
            return PARSE_MALFORMED, 0
        dist = src[s] | (src[s + 1] << 8)
        s += 2
        if d - dist < 0:
            return PARSE_MALFORMED, 0
        m_len = token & ML_MASK
        if m_len == ML_MASK:
            s, m_len = _len_ext(src, s, end, m_len)
            if m_len is None:
                return PARSE_MALFORMED, 0
        m_len += MIN_MATCH
        rows[3:6, n] = (d, dist, m_len if dist else 0)
        d += m_len
        n += 1


def parse_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                max_seq: int | None = None, sentinel_tails: bool = False):
    """Plain version of :func:`parse_sequences`, on any device: a Python
    loop over each block's tokens, on the host."""
    check_batch(comp, comp_lens)
    comp_np = comp.cpu().numpy()
    lens = comp_lens.cpu().tolist()
    if max_seq is None:
        max_seq = max_seq_for(max(lens, default=0))
    rows = np.zeros((len(lens), 6, max_seq), np.int32)
    n_seq = np.zeros((len(lens),), np.int32)
    out_total = np.zeros((len(lens),), np.int32)
    for i, n in enumerate(lens):
        n_seq[i], out_total[i] = _parse_row(comp_np[i, :n].tobytes(), rows[i],
                                            max_seq)
        if sentinel_tails and n_seq[i] >= 0:
            rows[i, [0, 3], n_seq[i]:] = SENTINEL
    dev = comp.device
    return (torch.from_numpy(rows.transpose(1, 0, 2).copy()).to(dev),
            torch.from_numpy(n_seq).to(dev), torch.from_numpy(out_total).to(dev))


def raise_on_parse_error(n_seq: torch.Tensor) -> None:
    """Raise ``Lz4Error`` naming the first block the parser refused, as
    ``gather_decode.parse_packed`` does."""
    bad = torch.nonzero(n_seq < 0).flatten()
    if bad.numel():
        i = int(bad[0])
        raise Lz4Error(f"Malformed input in block {i} "
                       f"(parse code {int(n_seq[i])})")


def parse_blocks(blocks: list[bytes], device: str | torch.device = "cuda",
                 max_seq: int | None = None):
    """Parse ``list[bytes]`` compressed blocks on ``device``; returns
    (tables dict name -> int32[N, S], n_seq, out_total). Raises
    ``Lz4Error`` on the first malformed block."""
    comp, comp_lens = to_device_layout(blocks, device=device)
    tables, n_seq, out_total = parse_sequences(comp, comp_lens, max_seq)
    raise_on_parse_error(n_seq)
    return dict(zip(TABLES, tables)), n_seq, out_total
