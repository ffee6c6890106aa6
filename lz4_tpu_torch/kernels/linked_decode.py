"""The batched decode of linked-block frames (``lz4 -BD``, LZ4F's
``blockLinked``): a walk of every block's tokens and a frame-wide resolve
by pointer doubling, the two kernels and their plain versions.

A linked block's matches may reach into the output of the blocks before
it, so the port's serial reader decodes one block a launch against a
window (``formats/frame.py::_Window``, K1 with a history). Only the copies
depend on the blocks before; the token walk does not. So a batch of
blocks is decoded in a fixed number of launches, whatever its number of
blocks (``csrc/linked_decode.cuh``):

- :func:`walk_linked` walks every block at once under K1's safe contract
  and writes one record a sequence (the six tables of
  ``kernels/sequences.py``, block-relative, a null offset a match of
  zeros), each block's code, output length and the farthest its matches
  reach before its own start. A block longer than :data:`CHUNK`
  compressed bytes is walked in chunks at once (:func:`chunk_layout`):
  exit tables for every offset of a chunk, the chunks' true entries by
  one table read each, then each chunk's walk from its entry; exact,
  because the rules of the walk that depend on the output position can
  only stop it;
- :func:`frame_plan` (torch, on the batch's device) places the blocks one
  after another behind the window of ``w`` bytes carried in, gives block
  ``i`` its history ``min(65536, w + o_i)``, makes a block whose reach
  goes past it MALFORMED, and finds the first block that fails;
- :func:`resolve_linked` gives every byte of the window and of the blocks
  before that one its value: a segment of :data:`SEGMENT` output bytes at
  a time in shared memory, in output order, then pointer-doubling rounds
  over the few nodes through which chains leave their segments (the open
  exits, a list), then the bytes whose chains left; each byte is written
  once;
- :func:`decode_linked_batch` chains them with one read-back.

A CUDA tensor goes to the kernels (``csrc/linked_decode.cu``), a CPU tensor
to the plain versions here; there is no fallback from one to the other.
The plain walk is a Python loop over each block's tokens; the plain
resolve runs synchronous rounds in torch gathers over a node for every
byte, on any device.
"""

from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..core.constants import MIN_MATCH, ML_BITS, ML_MASK, RUN_MASK
from ..utils.profiling import readback
from .build import Kernel, Scratch, resident_ctas
from .codec import (
    ERR_DEST_TOO_SMALL, ERR_MALFORMED, OK, WINDOW, _len_ext)
from .layout import Staging, check_batch, cuda_stream
from .sequences import max_seq_for

# a walk code besides the codec's: more sequences than the table has room
# for, which max_seq_for rules out
TOO_MANY = 3
_COPY_LENGTH = 8
_KNOWN = 1 << 31          # a node's sign bit: its byte is known

# the compressed bytes of a chunk of the chunked walk, and the longest
# block that walks as one chunk (PERF.md: measured at 16 x 4 MiB
# and 1,024 x 64 KiB; a batch of one chunk a block takes the warp walk)
CHUNK = 4096
WHOLE_BELOW = 65536
# the output bytes of a segment of the resolve (csrc/linked_decode.cu:
# kSeg), and its room for open exits: an entry for each LIST_SHARE bytes
# of node_cap, a batch with more taking them in chunks (PERF.md: segments
# of 8 and 32 KiB, rooms of node_cap / 4 and / 64 measured slower)
SEGMENT = 16384
LIST_SHARE = 16
_CHUNK_WORDS = 2048       # csrc/linked_decode.cu: kChunkWords
_TALLY = 4                # csrc/linked_decode.cu: the rounds' tally

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
WALK = Kernel("linked_walk", "linked_decode", "lz4tt_linked_walk",
              [_P, _I64, _P, _P, _I32, _I32, _P, _I32, _P, _P, _P, _P, _P,
               _I32, _I32, _I32, _P, _P])
RESOLVE = Kernel("linked_resolve", "linked_decode", "lz4tt_linked_resolve",
                 [_P, _I64, _P, _I32, _I32, _P, _P, _P, _P, _I32, _P, _I64,
                  _P, _P, _P, _I64, _P, _I32, _P])


class LinkedBatch(NamedTuple):
    """A decoded batch: ``out`` (``uint8``, on the batch's device) holds
    the window and then the output of blocks ``[0, n_ok)``, ``n_nodes``
    bytes in all; block ``i`` starts at ``w + block_at[i]``. ``codes`` is
    each block's code (reach past its history included); ``held`` each
    block's checksum verdict, as given (None: no block checksums). Block
    ``n_ok``, if below N, is the first that fails: by its checksum where
    that did not hold, else by its code."""
    out: torch.Tensor
    codes: np.ndarray
    block_at: np.ndarray
    n_ok: int
    n_nodes: int
    held: np.ndarray | None


def table_width(comp_lens, raw) -> int:
    """Records a block for a batch of ``comp_lens`` (host integers) with
    the raw flags ``raw``: ``max_seq_for`` its longest compressed block
    (a raw block needs one)."""
    return max_seq_for(max((int(n) for n, r in zip(comp_lens, raw) if not r),
                           default=0))


def rounds_for(node_cap: int) -> int:
    """Synchronous rounds that resolve any batch of up to ``node_cap``
    nodes, and one more that finds none open: a node at depth D is
    resolved after ceil(log2(D + 1)) rounds, and D < node_cap (the plain
    resolve's)."""
    return math.ceil(math.log2(max(node_cap, 2))) + 1


def resolve_scratch(node_cap: int, list_cap: int) -> int:
    """Int32 words of the resolve's scratch: three bitmaps' worth of words
    (the open nodes, the open exits, the list's entries before each word)
    of ``ceil(node_cap / 32)`` rounded up to 4, a count a chunk of them,
    the rounds' tally, and the list and its positions."""
    words = (-(-node_cap // 32) + 3) // 4 * 4
    return 3 * words + -(-words // _CHUNK_WORDS) + _TALLY + 2 * list_cap


def chunk_layout(comp_lens, raw, dest_cap: int, chunk: int = CHUNK,
                 whole_below: int = WHOLE_BELOW):
    """The chunks of a batch (host integers ``comp_lens``, flags ``raw``):
    a block walks in ``ceil(len / chunk)`` chunks unless it is raw, no
    longer than ``max(chunk, whole_below)`` or ``dest_cap`` is 0 (one
    chunk: the whole walk). Returns (int32[2, N + 1], the exclusive scans
    of the chunks a block and of its chunks but the last; the chunks; the
    chunks with exit tables)."""
    lens = np.asarray(comp_lens).astype(np.int64).reshape(-1)
    flags = np.asarray(raw, bool).reshape(-1)
    whole = flags | (lens <= max(chunk, whole_below)) | (dest_cap == 0)
    nc = np.where(whole, 1, -(-lens // chunk))
    lay = np.zeros((2, lens.size + 1), np.int64)
    lay[0, 1:] = np.cumsum(nc)
    lay[1, 1:] = np.cumsum(nc - 1)
    if lay[0, -1] >= 1 << 31:
        raise ValueError("too many chunks")
    return lay.astype(np.int32), int(lay[0, -1]), int(lay[1, -1])


# the chunked walk's scratch: its exit tables (12 B a compressed byte of
# the chunks that have them) and 20 B a chunk, a card and stream
SCRATCH = Scratch(torch.int32)


def _check_raw(raw: torch.Tensor, n: int, device: torch.device) -> None:
    if (raw.dtype != torch.bool or raw.dim() != 1 or raw.shape[0] != n
            or not raw.is_contiguous() or raw.device != device):
        raise ValueError("raw must be a contiguous bool[N] tensor on the "
                         "device of the batch")


def walk_linked(comp: torch.Tensor, comp_lens: torch.Tensor,
                raw: torch.Tensor, dest_cap: int, max_seq: int | None = None,
                host=None):
    """Walk a batch of linked blocks.

    Args:
      comp: uint8[N, S] payloads; comp_lens: int32[N] their sizes.
      raw: bool[N], blocks stored raw (one literal record each).
      dest_cap: the most bytes a block may decode to (the frame's block
        size).
      max_seq: table width; by default :func:`table_width`.
      host: ``(comp_lens, raw)`` as host sequences, when the caller has
        them: the kernel's chunks are planned on the host
        (:func:`chunk_layout`), read back from the card otherwise.

    Returns:
      (tables int32[6, N, max_seq], n_seq, out_total, code, reach, each
      int32[N]) on the device of ``comp``. Row ``i``'s first ``n_seq[i]``
      records are written (the kernel's entries past them are undefined).
      ``code`` is ``OK``, ``ERR_MALFORMED``, ``ERR_DEST_TOO_SMALL`` or
      :data:`TOO_MANY`; matches reaching before a block's start are no
      error here, ``reach`` is the farthest (0 for none).
    """
    check_batch(comp, comp_lens)
    n = comp.shape[0]
    _check_raw(raw, n, comp.device)
    if dest_cap < 0:
        raise ValueError("dest_cap must be >= 0")
    if host is None and (max_seq is None or comp.device.type != "cpu"):
        with readback("walk_linked", comp_lens):
            host = (comp_lens.tolist(), raw.tolist())
    if max_seq is None:
        max_seq = table_width(*host)
    if max_seq < 1:
        raise ValueError("max_seq must be >= 1")
    if comp.device.type == "cpu":
        return walk_linked_plain(comp, comp_lens, raw, dest_cap, max_seq)
    return _walk_cuda(comp, comp_lens, raw, dest_cap, max_seq, host, CHUNK,
                      WHOLE_BELOW)


def _walk_cuda(comp, comp_lens, raw, dest_cap: int, max_seq: int, host,
               chunk: int, whole_below: int):
    """:func:`walk_linked`'s launch on the card, its chunks planned by
    :func:`chunk_layout` at ``chunk`` and ``whole_below``: the wrapper's
    constants on the path; other values compare and time other layouts
    (a ``whole_below`` past every block runs the first design alone, a
    warp a block)."""
    if not 0 < chunk < 1 << 16:
        raise ValueError("chunk must lie in [1, 65535]")
    n, dev = comp.shape[0], comp.device
    tables = torch.empty((6, n, max_seq), dtype=torch.int32, device=dev)
    n_seq, out_total, code, reach = torch.empty((4, n), dtype=torch.int32,
                                                device=dev)
    if n:
        lens = np.asarray(host[0])
        lay_ptr = scratch_ptr = None
        n_chunks, n_tab = n, 0      # one chunk a block: the warp walk
        if dest_cap and lens.max() > max(chunk, whole_below):
            lay, n_chunks, n_tab = chunk_layout(lens, host[1], dest_cap,
                                                chunk, whole_below)
        if n_chunks > n:
            lay = _upload(lay, dev)
            lay_ptr = lay.data_ptr()
            scratch_ptr = SCRATCH.take(
                comp, n_tab * 3 * chunk + 5 * n_chunks).data_ptr()
        WALK(comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(),
             raw.data_ptr(), n, dest_cap, tables.data_ptr(), max_seq,
             n_seq.data_ptr(), out_total.data_ptr(), code.data_ptr(),
             reach.data_ptr(), lay_ptr, n_chunks, n_tab, chunk, scratch_ptr,
             cuda_stream(comp), device=dev.index)
    return tables, n_seq, out_total, code, reach


_up = threading.local()


def _upload(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    """The int32 array ``a`` on card ``dev`` by an asynchronous copy from a
    pinned buffer of this thread's (a pageable one would wait for the
    card)."""
    st = _up.__dict__.setdefault(dev.index, Staging())
    host = st.take(a.nbytes)
    host.numpy()[:] = a.reshape(-1).view(np.uint8)
    return st.upload(host, dev).view(torch.int32).view(a.shape)


def _walk_row(src: bytes, src_end: int, dest_cap: int, raw: bool,
              max_seq: int):
    """The walk of one block (``lz4tt_lw_walk``); returns (records, code,
    out_total, reach)."""
    if raw:
        if max_seq < 1:
            return [], TOO_MANY, 0, 0
        return [(0, 0, src_end, src_end, 0, 0)], OK, src_end, 0
    if dest_cap == 0:
        ok = src_end == 1 and src[0] == 0
        return [], OK if ok else ERR_DEST_TOO_SMALL, 0, 0
    recs = []
    s = d = reach = 0
    while True:
        if s >= src_end:
            return recs, ERR_MALFORMED, d, reach
        token = src[s]
        s += 1
        lit_len = token >> ML_BITS
        if lit_len == RUN_MASK:
            s, lit_len = _len_ext(src, s, src_end, lit_len)
        lit_end = d + lit_len
        if (lit_end > dest_cap - _COPY_LENGTH
                or s + lit_len > src_end - _COPY_LENGTH):
            if lit_end > dest_cap:
                return recs, ERR_DEST_TOO_SMALL, d, reach
            if s + lit_len != src_end:
                return recs, ERR_MALFORMED, d, reach
            if len(recs) >= max_seq:
                return recs, TOO_MANY, d, reach
            recs.append((d, s, lit_len, lit_end, 0, 0))
            return recs, OK, lit_end, reach
        lo, ls = d, s
        s += lit_len
        d = lit_end
        if s + 2 > src_end:
            return recs, ERR_MALFORMED, d, reach
        dist = src[s] | (src[s + 1] << 8)
        s += 2
        m_len = token & ML_MASK
        if m_len == ML_MASK:
            s, m_len = _len_ext(src, s, src_end, m_len)
        m_len += MIN_MATCH
        if d + m_len > dest_cap:
            return recs, ERR_MALFORMED, d, reach
        if len(recs) >= max_seq:
            return recs, TOO_MANY, d, reach
        reach = max(reach, dist - d)
        recs.append((lo, ls, lit_len, d, dist, m_len))
        d += m_len


def walk_linked_plain(comp: torch.Tensor, comp_lens: torch.Tensor,
                      raw: torch.Tensor, dest_cap: int,
                      max_seq: int | None = None):
    """Plain version of :func:`walk_linked`, on any device: a Python loop
    over each block's tokens, on the host. Table entries past a row's
    records are 0."""
    check_batch(comp, comp_lens)
    n = comp.shape[0]
    _check_raw(raw, n, comp.device)
    comp_np = comp.cpu().numpy()
    lens = comp_lens.cpu().tolist()
    flags = raw.cpu().tolist()
    if max_seq is None:
        max_seq = table_width(lens, flags)
    tables = np.zeros((6, n, max_seq), np.int32)
    res = np.zeros((4, n), np.int32)
    for i, k in enumerate(lens):
        recs, code, out_total, reach = _walk_row(
            comp_np[i, :k].tobytes(), k, dest_cap, flags[i], max_seq)
        if recs:
            tables[:, i, :len(recs)] = np.array(recs, np.int64).T
        res[:, i] = (len(recs), out_total, code, reach)
    dev = comp.device
    return (torch.from_numpy(tables).to(dev),
            *torch.from_numpy(res).to(dev))


def frame_plan(out_total: torch.Tensor, code: torch.Tensor,
               reach: torch.Tensor, w: int, held: torch.Tensor | None = None):
    """The walked blocks one after another behind a window of ``w`` bytes,
    on their device, with no read-back: (block_at int64[N + 1], the exclusive
    scan of ``out_total``; the codes with MALFORMED where a block's reach
    goes past its history ``min(65536, w + block_at[i])``; n_ok, the first
    block that fails (or N), and n_nodes, ``w + block_at[n_ok]``, as 0-dim
    int64 tensors). ``held`` (bool[N]), when given, is each block's
    checksum verdict: a block whose checksum did not hold fails too, as
    the serial reader checks it before the block's decode."""
    n = out_total.shape[0]
    dev = out_total.device
    block_at = torch.zeros((n + 1,), dtype=torch.int64, device=dev)
    block_at[1:] = torch.cumsum(out_total.long(), 0)
    hist = (block_at[:n] + w).clamp(max=WINDOW)
    code = torch.where(reach.long() > hist, ERR_MALFORMED, code)
    failing = code != OK if held is None else (code != OK) | ~held
    first = torch.where(failing, torch.arange(n, device=dev), n)
    n_ok = first.min() if n else torch.zeros((), dtype=torch.int64,
                                             device=dev)
    return block_at, code, n_ok, block_at[n_ok] + w


def _check_resolve(comp, tables, n_seq, block_at, window):
    n = comp.shape[0]
    if comp.dtype != torch.uint8 or comp.dim() != 2 or comp.stride(1) != 1:
        raise ValueError("comp must be a uint8[N, S] tensor with contiguous "
                         "rows")
    if (tables.dtype != torch.int32 or tables.dim() != 3
            or tables.shape[:2] != (6, n) or not tables.is_contiguous()):
        raise ValueError("tables must be a contiguous int32[6, N, S] tensor")
    for t, dtype, shape, what in ((n_seq, torch.int32, (n,), "int32[N]"),
                                  (block_at, torch.int64, (n + 1,),
                                   "int64[N + 1]")):
        if t.dtype != dtype or t.shape != shape or not t.is_contiguous():
            raise ValueError(f"n_seq and block_at must be contiguous {what}")
    if (window.dtype != torch.uint8 or window.dim() != 1
            or window.numel() > WINDOW or not window.is_contiguous()):
        raise ValueError(f"window must be a contiguous uint8[<= {WINDOW}]")
    for t in (tables, n_seq, block_at, window):
        if t.device != comp.device:
            raise ValueError("every input must lie on the device of comp")


def resolve_linked(comp: torch.Tensor, tables: torch.Tensor,
                   n_seq: torch.Tensor, block_at: torch.Tensor,
                   n_ok: torch.Tensor, n_nodes: torch.Tensor,
                   window: torch.Tensor, node_cap: int):
    """Resolve a walked batch (:func:`walk_linked`, :func:`frame_plan`).

    Args:
      comp: the walked payloads; tables, n_seq: the walk's.
      block_at, n_ok, n_nodes: :func:`frame_plan`'s (0-dim int64 tensors
        for ``n_ok`` and ``n_nodes``).
      window: uint8[w], the bytes before the batch (its nodes [0, w)).
      node_cap: at least ``n_nodes`` (``w`` + N x the block size).

    Returns:
      (out uint8[node_cap], bytes [0, n_nodes) written; open int32[k],
      whose last entry counts the nodes still open). The kernel's ``open``
      is int32[4]: the nodes whose chains leave their segment, the open
      exits (the list), the most rounds a thread took on a chunk of the
      list, and the list entries its bounded rounds left open (0 unless
      the kernel is at fault). The plain version's is its synchronous
      rounds' open counts.
    """
    _check_resolve(comp, tables, n_seq, block_at, window)
    if not 0 < node_cap < 1 << 31:
        raise ValueError("node_cap must lie in [1, 2**31)")
    if comp.device.type == "cpu":
        return resolve_linked_plain(comp, tables, n_seq, block_at, n_ok,
                                    n_nodes, window, node_cap)
    return _resolve_cuda(comp, tables, n_seq, block_at, n_ok, n_nodes,
                         window, node_cap, -(-node_cap // LIST_SHARE))


def _resolve_cuda(comp, tables, n_seq, block_at, n_ok, n_nodes, window,
                  node_cap: int, list_cap: int, fn=RESOLVE):
    """:func:`resolve_linked`'s launches on the card with room for
    ``list_cap`` open exits at a time (``node_cap / LIST_SHARE`` on the
    path; less takes the list in more chunks). ``fn``: another build of
    the same C entry point (``design_variants``' edits), for timing."""
    dev = comp.device
    out = torch.empty((node_cap,), dtype=torch.uint8, device=dev)
    off = torch.empty((node_cap,), dtype=torch.int16, device=dev)
    scratch = torch.empty((resolve_scratch(node_cap, list_cap),),
                          dtype=torch.int32, device=dev)
    counters = torch.empty((4,), dtype=torch.int32, device=dev)
    args = (comp.data_ptr(), comp.stride(0), tables.data_ptr(),
            tables.shape[2], comp.shape[0], n_seq.data_ptr(),
            block_at.data_ptr(), n_ok.data_ptr(), window.data_ptr(),
            window.numel(), n_nodes.data_ptr(), node_cap, out.data_ptr(),
            off.data_ptr(), scratch.data_ptr(), list_cap, counters.data_ptr(),
            resident_ctas("linked_decode", "lz4tt_linked_occupancy",
                          dev.index), cuda_stream(comp))
    if fn is RESOLVE:
        RESOLVE(*args, device=dev.index)
    elif fn(*args):
        raise RuntimeError("lz4tt_linked_resolve: CUDA error")
    return out, counters


def resolve_linked_plain(comp: torch.Tensor, tables: torch.Tensor,
                         n_seq: torch.Tensor, block_at: torch.Tensor,
                         n_ok: torch.Tensor, n_nodes: torch.Tensor,
                         window: torch.Tensor, node_cap: int,
                         rounds: int | None = None):
    """Plain version of :func:`resolve_linked`, on any device: every
    record's nodes by ``repeat_interleave``, then synchronous rounds of
    torch gathers. Bytes of ``out`` past ``n_nodes`` are 0."""
    _check_resolve(comp, tables, n_seq, block_at, window)
    rounds = rounds_for(node_cap) if rounds is None else rounds
    dev = comp.device
    n, width = comp.shape[0], tables.shape[2]
    w = window.numel()
    total = int(n_nodes)
    nodes = torch.zeros((total,), dtype=torch.int64, device=dev)
    nodes[:w] = window.long() - _KNOWN
    # the records of the blocks before the first that fails
    used = ((torch.arange(width, device=dev) < n_seq.long()[:, None])
            & (torch.arange(n, device=dev) < n_ok)[:, None])
    blk, k = torch.nonzero(used, as_tuple=True)
    lo, ls, ll, mo, md, ml = (t[blk, k].long() for t in tables)
    base = block_at[blk] + w

    def spread(lens):
        """(record, x) of every byte x < lens[record]."""
        rec = torch.repeat_interleave(torch.arange(lens.numel(), device=dev),
                                      lens)
        start = torch.cumsum(lens, 0) - lens
        return rec, torch.arange(rec.numel(), device=dev) - start[rec]

    rec, x = spread(ll)
    nodes[base[rec] + lo[rec] + x] = (
        comp[blk[rec], ls[rec] + x].long() - _KNOWN)
    rec, x = spread(ml)
    d = md[rec]
    nodes[base[rec] + mo[rec] + x] = torch.where(
        d > 0, base[rec] + mo[rec] - d + torch.remainder(x, d.clamp(min=1)),
        -_KNOWN)
    open_ = torch.zeros((rounds,), dtype=torch.int32, device=dev)
    for r in range(rounds):
        live = nodes >= 0
        left = int(live.sum())
        if not left:
            break
        nodes = torch.where(live, nodes[nodes.clamp(min=0)], nodes)
        open_[r] = int((nodes >= 0).sum())
    out = torch.zeros((node_cap,), dtype=torch.uint8, device=dev)
    out[:total] = (nodes & 0xFF).to(torch.uint8)
    return out, open_


def decode_linked_batch(comp: torch.Tensor, comp_lens: torch.Tensor,
                        raw: torch.Tensor, dest_cap: int,
                        window: torch.Tensor, max_seq: int | None = None,
                        held: torch.Tensor | None = None,
                        host=None) -> LinkedBatch:
    """Walk, place and resolve a batch of linked blocks against ``window``
    (uint8[w], the up to 64 KiB of output before it), on the batch's
    device: the walk's and the resolve's launches on the card and one
    read-back (the codes, the offsets, the first failing block, the nodes
    left open and ``held``, each block's checksum verdict when given: the
    blocks from the first whose checksum did not hold are neither resolved
    nor returned). Raises ``RuntimeError`` if a node is still open, or if
    the first failing block had more sequences than its table: both are
    faults of this code, not of the input. ``host`` is
    :func:`walk_linked`'s."""
    tables, n_seq, out_total, code, reach = walk_linked(
        comp, comp_lens, raw, dest_cap, max_seq, host)
    block_at, code, n_ok, n_nodes = frame_plan(out_total, code, reach,
                                               window.numel(), held)
    node_cap = window.numel() + comp.shape[0] * dest_cap
    out, open_ = resolve_linked(comp, tables, n_seq, block_at, n_ok, n_nodes,
                                window, node_cap)
    n = comp.shape[0]
    parts = [code.long(), block_at, n_ok.view(1), n_nodes.view(1),
             open_[-1:].long()]
    if held is not None:
        parts.append(held.long())
    with readback("decode_linked_batch", code):
        host = torch.cat(parts).cpu().numpy()
    codes, at = host[:n], host[n:2 * n + 1]
    n_ok, n_nodes, left = (int(v) for v in host[2 * n + 1:2 * n + 4])
    verdicts = host[2 * n + 4:].astype(bool) if held is not None else None
    if left:
        raise RuntimeError(f"linked resolve: {left} nodes still open")
    if n_ok < n and codes[n_ok] == TOO_MANY and (
            verdicts is None or verdicts[n_ok]):
        raise RuntimeError(f"linked walk: block {n_ok} has more sequences "
                           f"than its table's {tables.shape[2]}")
    return LinkedBatch(out, codes, at, n_ok, n_nodes, verdicts)
