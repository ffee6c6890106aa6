"""The LZ4Block stream (lz4-java's ``LZ4BlockOutputStream``) on the card:
its body packed, its headers walked and its blocks decoded, a batch at a
time, reading nothing back but the body's size; with plain versions.

- :func:`block_stream_body_packed`: a batch of raw rows and their
  compressed rows as the stream's blocks, each a 21-byte header (its
  check K3's XXH32 of the raw block, seed ``DEFAULT_SEED``, through the
  28-bit ``Checksum`` adapter) and its payload (raw where compressing did
  not make it smaller), then the end block: one K3 launch and one launch of
  ``csrc/frame_pack.cu``'s LZ4Block packer, after the one read-back of the
  body's size.
- :func:`block_stream_index`: the records a reader meets in a stream on
  the card, from position 0, with the reader's checks
  (``csrc/block_stream.cu``): a :class:`BlockStreamIndex` on the card, the
  record count there too.
- :func:`decompress_block_stream_batch`: every record of an index decoded
  into its row (``LZ4BlockInputStream`` with ``fastDecompressor()``): raw
  payloads copied, LZ4 payloads decoded by K1's body in the fast contract,
  each row's K3 hash compared with its check; a code a record.

A record's code: ``OK``; ``MALFORMED`` (the payload is not LZ4 of its
original length: ``Lz4Error("Malformed input")``); ``TOO_LARGE`` (longer
than the decode's rows); ``CORRUPTED`` (a header rule broken, bytes read
other than the compressed length, or a check that differs: "Stream is
corrupted"); ``PREMATURE`` (a header or payload cut off by the end, or no
end block where an empty block stops the walk: "Stream ended
prematurely"); ``NONE`` past the last record. The first fault is the last
record of a walk.

A CUDA tensor goes to the kernels, a CPU tensor to the plain versions,
which follow ``csrc/block_stream.cuh``'s walk a header at a time.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import torch

from ..core.constants import max_compressed_length
from ..utils.profiling import entry, readback
from . import codec
from .build import Kernel
from .layout import check_rows, cuda_stream, row_stride
from .xxhash import xxh32_plain_rows, xxh32_rows

MAGIC = b"LZ4Block"
HEADER_LENGTH = len(MAGIC) + 1 + 4 + 4 + 4  # 21
COMPRESSION_LEVEL_BASE = 10
MIN_BLOCK_SIZE = 64
MAX_BLOCK_SIZE = 1 << (COMPRESSION_LEVEL_BASE + 0x0F)  # 32 MB
COMPRESSION_METHOD_RAW = 0x10
COMPRESSION_METHOD_LZ4 = 0x20
DEFAULT_SEED = 0x9747B28C
CHECK_MASK = 0xFFFFFFF      # the 28-bit Checksum adapter

NONE = -1
OK = codec.OK
MALFORMED = codec.ERR_MALFORMED
TOO_LARGE = codec.ERR_DEST_TOO_SMALL
CORRUPTED = 3
PREMATURE = 4

# the index's fields, rows of its table (csrc/block_stream.cuh)
AT, CLEN, OLEN, METHOD, CHECK, CODE = range(6)
FIELDS = 6
# the bytes of the stream a CTA of the mark scans (csrc/block_stream.cu)
_SPAN = 32768
_MAX_STREAM = 2 ** 31 - 1

_HEADER = struct.Struct("<8sBIII")

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
LZ4BLOCK_PACK = Kernel("lz4block_pack", "frame_pack", "lz4tt_lz4block_pack",
                       [_P, _I64, _P, _P, _I64, _P, _P, _P, _I32, _P, _I32,
                        _I32, _P])
LZ4BLOCK_INDEX = Kernel("lz4block_index", "block_stream",
                        "lz4tt_lz4block_index",
                        [_P, _I64, _I32, _P, _I32, _I32, _I32, _I32, _P, _I64,
                         _P, _P, _P])
LZ4BLOCK_DECODE = Kernel("lz4block_decode", "block_stream",
                         "lz4tt_lz4block_decode",
                         [_P, _P, _I64, _P, _I32, _P, _I64, _I32, _P, _P, _P])
LZ4BLOCK_VERDICT = Kernel("lz4block_verdict", "block_stream",
                          "lz4tt_lz4block_verdict",
                          [_P, _P, _I64, _P, _P, _I32, _P])


def compression_level(block_size: int) -> int:
    """The token's level of ``block_size``: ceil(log2) - 10, at least 0;
    ``ValueError`` outside [64, 32 MB] (LZ4BlockOutputStream.java:75-86)."""
    if block_size < MIN_BLOCK_SIZE:
        raise ValueError(f"blockSize must be >= {MIN_BLOCK_SIZE}, got {block_size}")
    if block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"blockSize must be <= {MAX_BLOCK_SIZE}, got {block_size}")
    return max(0, (block_size - 1).bit_length() - COMPRESSION_LEVEL_BASE)


def block_header(method: int, level: int, comp_len: int, orig_len: int,
                 check: int) -> bytes:
    return _HEADER.pack(MAGIC, method | level, comp_len, orig_len, check)


def parse_header(data, p: int, length: int) -> tuple[int, int, int, int, int]:
    """``(code, comp_len, orig_len, method, check)`` of the header at
    ``data[p:p + 21]`` of a stream of ``length`` bytes, with the reader's
    rules (LZ4BlockInputStream.java:150-200): ``PREMATURE`` where fewer
    than 21 bytes are left, ``CORRUPTED`` (fields 0) where a rule is
    broken. The compressed length is held to the bound of the level's
    block size before anything of the payload is read."""
    if p + HEADER_LENGTH > length:
        return PREMATURE, 0, 0, 0, 0
    bad = (CORRUPTED, 0, 0, 0, 0)
    magic, token, cl, ol, check = _HEADER.unpack_from(data, p)
    if magic != MAGIC:
        return bad
    method = token & 0xF0
    size = 1 << (COMPRESSION_LEVEL_BASE + (token & 0x0F))
    if method not in (COMPRESSION_METHOD_RAW, COMPRESSION_METHOD_LZ4):
        return bad
    if (ol > size or (ol == 0) != (cl == 0)
            or (method == COMPRESSION_METHOD_RAW and ol != cl)):
        return bad
    if cl > max_compressed_length(size):
        return bad
    if ol == 0 and check != 0:
        return bad
    return OK, cl, ol, method, check


def walk(data, length: int, pos: int, stop: bool,
         max_blocks: int) -> tuple[list[tuple], int]:
    """The reader's walk of ``data[:length]`` from the header at ``pos``,
    as ``lz4tt_lz4block_walk``: at most ``max_blocks`` records ``(at,
    comp_len, orig_len, method, check, code)``, and the position after the
    last (a fault's own). With ``stop`` an empty block ends the walk, and
    the stream's end before one is a ``PREMATURE`` record; without, empty
    blocks are records of no bytes and the stream's end ends the walk."""
    records, end = [], pos
    while len(records) < max_blocks:
        if pos == length and not stop:
            break
        code, cl, ol, method, check = parse_header(data, pos, length)
        if code == OK and ol > 0 and pos + HEADER_LENGTH + cl > length:
            code, cl, ol, method, check = PREMATURE, 0, 0, 0, 0
        records.append((pos, cl, ol, method, _i32(check), code))
        if code != OK:
            break
        pos += HEADER_LENGTH + cl
        end = pos
        if ol == 0 and stop:
            break
    return records, end


def _i32(v: int) -> int:
    """A u32 as the int32 of its bits."""
    return v - (1 << 32) if v >= 1 << 31 else v


@dataclasses.dataclass
class BlockStreamIndex:
    """The records of a stream, on its device: ``table`` int32[6, n], a
    row a field (:data:`AT` the header's position, :data:`CLEN`,
    :data:`OLEN`, :data:`METHOD`, :data:`CHECK` as the header's int32 bits,
    :data:`CODE`), a column a record, ``NONE`` past the last; ``meta``
    int32[2]: the records, and the position after the last, where a walk
    cut at ``n`` records goes on; ``order`` int32[n], the order in which
    the decode takes the records (those it decodes as LZ4 first, each part
    in stream order). ``index[rows]`` (a slice) is those records (with the
    same ``meta``), in the order they have in ``order``, on the device."""
    table: torch.Tensor
    meta: torch.Tensor
    order: torch.Tensor

    def __getitem__(self, rows: slice) -> "BlockStreamIndex":
        place = torch.argsort(self.order)       # each record's turn
        return BlockStreamIndex(self.table[:, rows].contiguous(), self.meta,
                                torch.argsort(place[rows]).to(torch.int32))


def _check_stream(stream: torch.Tensor, stream_len: int) -> None:
    if stream.dtype != torch.uint8 or stream.dim() != 1 or not stream.is_contiguous():
        raise ValueError("expected a contiguous uint8[L] stream")
    if not 0 <= stream_len <= stream.numel() or stream_len > _MAX_STREAM:
        raise ValueError(f"stream_len must lie in [0, min({stream.numel()}, "
                         f"2 GiB - 1)], got {stream_len}")


def _check_index(stream: torch.Tensor, index: BlockStreamIndex) -> None:
    t = index.table
    if (t.dtype != torch.int32 or t.dim() != 2 or t.shape[0] != FIELDS
            or t.stride(1) != 1 or t.device != stream.device):
        raise ValueError("expected an index of the stream's device")


# ---------------------------------------------------------------------------
# the writer
# ---------------------------------------------------------------------------

@entry
def block_stream_body_packed(src: torch.Tensor, lens: torch.Tensor,
                             comp: torch.Tensor, comp_lens: torch.Tensor,
                             block_size: int = 1 << 16):
    """The LZ4Block stream of a batch, as ``LZ4BlockOutputStream`` with
    ``block_size`` writes it: for each block with ``lens > 0`` its header
    and payload (the compressed row, or the raw row where ``comp_lens >=
    lens``), then the end block. On the card the offsets are scanned
    there, the body's size (and the lengths' range) is the one value read
    back, then one K3 launch hashes the raw rows and one launch of the
    LZ4Block packer writes every header, payload and the end block; on the
    CPU this is :func:`block_stream_body_packed_plain`. Lengths must lie
    within the rows and ``lens`` within ``block_size`` (``ValueError``
    otherwise); ``src`` is in the port's layout.

    Returns (body uint8[total], total).
    """
    level = compression_level(block_size)
    if src.device.type == "cpu":
        return block_stream_body_packed_plain(src, lens, comp, comp_lens,
                                              block_size)
    check_rows(src, lens)
    check_rows(comp, comp_lens)
    n = lens.shape[0]
    if comp.shape[0] != n or comp.device != src.device:
        raise ValueError("src and comp must hold the same blocks on one device")
    dev = src.device
    total = 0
    offs = torch.empty((0,), dtype=torch.int32, device=dev)
    if n:
        emit = torch.where(lens > 0,
                           torch.minimum(lens, comp_lens) + HEADER_LENGTH, 0)
        ends = torch.cumsum(emit, 0)            # int64
        offs = (ends - emit).to(torch.int32)    # wraps only where refused
        with readback("block_stream_body", ends):
            total, lens_min, lens_max, comp_min, comp_max = torch.stack(
                (ends[-1], lens.min(), lens.max(), comp_lens.min(),
                 comp_lens.max())).tolist()
        _check_lengths(lens_min, lens_max, comp_min, comp_max, src, comp,
                       block_size)
    if total + HEADER_LENGTH > _MAX_STREAM:
        raise ValueError("stream of 2 GiB or more")
    body = torch.empty((total + HEADER_LENGTH,), dtype=torch.uint8, device=dev)
    checks = (xxh32_rows(src, lens, DEFAULT_SEED) if n else
              torch.empty((0,), dtype=torch.uint32, device=dev))
    LZ4BLOCK_PACK(src.data_ptr(), src.stride(0), lens.data_ptr(),
                  comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(),
                  offs.data_ptr(), checks.data_ptr(), level, body.data_ptr(),
                  total, n, cuda_stream(src), device=dev.index)
    return body, total + HEADER_LENGTH


def _check_lengths(lens_min, lens_max, comp_min, comp_max, src, comp,
                   block_size) -> None:
    if (lens_min < 0 or lens_max > min(src.shape[1], block_size)
            or comp_min < 0 or comp_max > comp.shape[1]):
        raise ValueError("lengths must lie within the rows and the block size")


def block_stream_body_packed_plain(src: torch.Tensor, lens: torch.Tensor,
                                   comp: torch.Tensor, comp_lens: torch.Tensor,
                                   block_size: int = 1 << 16):
    """Plain version of :func:`block_stream_body_packed`, on any device:
    the blocks a header at a time on the host, the checks by
    ``xxh32_plain_rows``.

    Returns (body uint8[total], total).
    """
    level = compression_level(block_size)
    check_rows(src, lens)
    check_rows(comp, comp_lens)
    dev = src.device
    src, comp = src.cpu(), comp.cpu()
    ls, cls = lens.tolist(), comp_lens.tolist()
    if ls:
        _check_lengths(min(ls), max(ls), min(cls), max(cls), src, comp,
                       block_size)
    checks = xxh32_plain_rows(src.contiguous(), lens.cpu(),
                              DEFAULT_SEED).tolist()
    parts = []
    for i, (o, c) in enumerate(zip(ls, cls)):
        if o <= 0:
            continue
        raw = c >= o
        parts.append(block_header(
            COMPRESSION_METHOD_RAW if raw else COMPRESSION_METHOD_LZ4, level,
            o if raw else c, o, checks[i] & CHECK_MASK))
        parts.append((src[i, :o] if raw else comp[i, :c]).numpy().tobytes())
    parts.append(block_header(COMPRESSION_METHOD_RAW, level, 0, 0, 0))
    body = b"".join(parts)
    if len(body) > _MAX_STREAM:
        raise ValueError("stream of 2 GiB or more")
    out = torch.frombuffer(bytearray(body), dtype=torch.uint8).to(dev)
    return out, len(body)


# ---------------------------------------------------------------------------
# the reader
# ---------------------------------------------------------------------------

@entry
def block_stream_index(stream: torch.Tensor, stream_len: int, max_blocks: int,
                       stop_on_empty_block: bool = True) -> BlockStreamIndex:
    """The first ``max_blocks`` (> 0) records a reader meets in
    ``stream[:stream_len]`` from position 0 (``LZ4BlockInputStream``'s
    walk; ``stop_on_empty_block=False`` reads across concatenated streams),
    each header checked with the reader's rules, the first fault the last
    record. On the card two launches (``csrc/block_stream.cu``: the magic
    marked, then the chain ranked) and nothing read back; on the CPU
    :func:`block_stream_index_plain`."""
    _check_stream(stream, stream_len)
    if max_blocks < 1:
        raise ValueError(f"max_blocks must be >= 1, got {max_blocks}")
    if stream.device.type == "cpu":
        return block_stream_index_plain(stream, stream_len, max_blocks,
                                        stop_on_empty_block)
    dev = stream.device
    if stream.data_ptr() % 16:      # the mark reads 16-byte chunks
        stream = stream[:stream_len].clone()
    n_spans = -(-stream_len // _SPAN)
    # the candidates kept: room for false ones, and never more than one a
    # magic's length
    cap = min(4 * max_blocks + 4096, stream_len // 8 + 1)
    log = cap.bit_length()
    scratch = torch.empty((20 * n_spans + (9 + log) * cap,),
                          dtype=torch.int32, device=dev)
    table = torch.empty((FIELDS, max_blocks), dtype=torch.int32, device=dev)
    meta = torch.empty((2,), dtype=torch.int32, device=dev)
    order = torch.empty((max_blocks,), dtype=torch.int32, device=dev)
    LZ4BLOCK_INDEX(stream.data_ptr(), stream_len, n_spans, scratch.data_ptr(),
                   cap, log, max_blocks, int(stop_on_empty_block),
                   table.data_ptr(), table.stride(0), meta.data_ptr(),
                   order.data_ptr(), cuda_stream(stream), device=dev.index)
    return BlockStreamIndex(table, meta, order)


def block_stream_index_plain(stream: torch.Tensor, stream_len: int,
                             max_blocks: int,
                             stop_on_empty_block: bool = True
                             ) -> BlockStreamIndex:
    """Plain version of :func:`block_stream_index`, on any device: the
    reader's walk a header at a time (:func:`walk`)."""
    _check_stream(stream, stream_len)
    data = stream[:stream_len].cpu().numpy().tobytes()
    records, end = walk(data, stream_len, 0, stop_on_empty_block, max_blocks)
    table = torch.zeros((FIELDS, max_blocks), dtype=torch.int32)
    table[CODE] = NONE
    if records:
        table[:, :len(records)] = torch.tensor(records, dtype=torch.int32).T
    meta = torch.tensor([len(records), end], dtype=torch.int32)
    lz4 = ((table[CODE] == OK) & (table[METHOD] == COMPRESSION_METHOD_LZ4)
           & (table[OLEN] > 0))
    order = torch.cat((torch.nonzero(lz4), torch.nonzero(~lz4))).flatten()
    return BlockStreamIndex(table.to(stream.device), meta.to(stream.device),
                            order.to(torch.int32).to(stream.device))


@entry
def decompress_block_stream_batch(stream: torch.Tensor,
                                  index: BlockStreamIndex, block_size: int):
    """Every record of ``index`` (of ``stream``) decoded into a row of
    ``block_size`` bytes: a raw payload copied, an LZ4 payload decoded by
    K1's body in the fast contract to its original length (the bytes read
    must be its compressed length), each decoded row's XXH32 (seed
    ``DEFAULT_SEED``, masked to 28 bits) compared with its check. On the
    card three launches (the decode, K3, the verdict) and nothing read
    back, the decode's warps taking the records in the index's ``order``;
    on the CPU :func:`decompress_block_stream_batch_plain`.

    Returns (out uint8[n, row_stride(block_size)], out_lens int32[n]: the
    record's original length where its payload decoded or was copied, else
    0; err int32[n]: the record's code).
    """
    _check_stream(stream, stream.numel())
    _check_index(stream, index)
    if block_size < 0:
        raise ValueError("block_size must be >= 0")
    if stream.device.type == "cpu":
        return decompress_block_stream_batch_plain(stream, index, block_size)
    dev = stream.device
    t = index.table
    n = t.shape[1]
    out = torch.zeros((n, row_stride(block_size)), dtype=torch.uint8,
                      device=dev)
    out_lens = torch.empty((n,), dtype=torch.int32, device=dev)
    err = torch.empty((n,), dtype=torch.int32, device=dev)
    order = index.order
    if order.dtype != torch.int32 or order.shape != (n,) or order.device != dev:
        raise ValueError("expected the index's order of its records")
    LZ4BLOCK_DECODE(stream.data_ptr(), t.data_ptr(), t.stride(0),
                    order.data_ptr(), n,
                    out.data_ptr(), out.stride(0), block_size,
                    out_lens.data_ptr(), err.data_ptr(), cuda_stream(stream),
                    device=dev.index)
    hashes = xxh32_rows(out, out_lens, DEFAULT_SEED)
    LZ4BLOCK_VERDICT(hashes.data_ptr(), t.data_ptr(), t.stride(0),
                     out_lens.data_ptr(), err.data_ptr(), n,
                     cuda_stream(stream), device=dev.index)
    return out, out_lens, err


def decompress_block_stream_batch_plain(stream: torch.Tensor,
                                        index: BlockStreamIndex,
                                        block_size: int):
    """Plain version of :func:`decompress_block_stream_batch`, on any
    device: a record at a time, LZ4 payloads by ``decompress_fast_plain``,
    the checks by ``xxh32_plain_rows``."""
    _check_stream(stream, stream.numel())
    _check_index(stream, index)
    dev = stream.device
    data = stream.cpu()
    rows = index.table.cpu().T.tolist()
    n = len(rows)
    out = torch.zeros((n, row_stride(block_size)), dtype=torch.uint8)
    out_lens = torch.zeros((n,), dtype=torch.int32)
    err = torch.empty((n,), dtype=torch.int32)
    for b, (at, cl, ol, method, _, code) in enumerate(rows):
        if code == OK and ol > block_size:
            code = TOO_LARGE
        elif code == OK and ol > 0:
            payload = data[at + HEADER_LENGTH:at + HEADER_LENGTH + cl]
            if method == COMPRESSION_METHOD_RAW:
                out[b, :ol] = payload
                out_lens[b] = ol
            else:
                comp = torch.zeros((1, row_stride(cl)), dtype=torch.uint8)
                comp[0, :cl] = payload
                dec, read, e = codec.decompress_fast_plain(
                    comp, torch.tensor([cl], dtype=torch.int32), ol)
                if int(e[0]) != codec.OK:
                    code = MALFORMED
                else:
                    out[b, :ol] = dec[0, :ol]
                    out_lens[b] = ol
                    if int(read[0]) != cl:
                        code = CORRUPTED
        err[b] = code
    hashes = xxh32_plain_rows(out, out_lens, DEFAULT_SEED).to(torch.int64)
    checks = index.table[CHECK].cpu().to(torch.int64) & 0xFFFFFFFF
    wrong = (err == OK) & (out_lens > 0) & ((hashes & CHECK_MASK) != checks)
    err[wrong] = CORRUPTED
    return out.to(dev), out_lens.to(dev), err.to(dev)

