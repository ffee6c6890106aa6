"""The device codec step of ``lz4_tpu/dist/sharded.py``, on one device.

Same names as the JAX module so a reader finds each counterpart:
``pack_offsets``, ``frame_body_packed`` (``_frame_body_packed``,
``sharded.py:271-306``; the kernel ``csrc/frame_pack.cu``),
``compress_frame_packed``
(``compress_frame_sharded_packed``, ``:324-369``) and ``roundtrip_step``
(``sharded_roundtrip_step``, ``:372-422``): compress, block checksums, the
exclusive scan of compressed lengths, decode and verify, and packing of the
frame body, all on the device. Spreading blocks over several GPUs is not
part of this module yet.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np
import torch

from ..api.cuda_instances import check_compressed, compress_rows
from ..core.constants import max_compressed_length
from ..core.device import resolve_device
from ..formats.frame import INCOMPRESSIBLE_MASK, frame_header
from ..kernels.codec import compress_fast_batch, decompress_safe_batch
from ..kernels.build import Kernel
from ..kernels.layout import DOWN, UP, cuda_stream, row_stride, staging
from ..kernels.xxhash import xxh32_batch

# Output bytes packed per step of frame_body_packed_plain: its int32/int64
# index temporaries stay near 40 bytes per packed byte of a chunk (about 1/3
# GiB) whatever the batch size.
_PACK_CHUNK = 1 << 23

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
FRAME_PACK = Kernel("frame_pack", "frame_pack", "lz4tt_frame_pack",
                    [_P, _I64, _P, _P, _I64, _P, _P, _P, _I32, _P])


def pack_offsets(comp_lens: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of per-block compressed lengths (int32)."""
    return torch.cumsum(comp_lens, 0, dtype=torch.int32) - comp_lens


def _check_pack_batch(data: torch.Tensor, lens: torch.Tensor) -> None:
    """Shapes, types and devices of one ``(uint8[N, W], int32[N])`` input
    of :func:`frame_body_packed`, without reading the lengths."""
    if data.dtype != torch.uint8 or data.dim() != 2 or data.stride(1) != 1:
        raise ValueError("expected a uint8[N, W] tensor with contiguous rows")
    if (lens.dtype != torch.int32 or lens.dim() != 1
            or lens.shape[0] != data.shape[0] or not lens.is_contiguous()):
        raise ValueError("expected contiguous int32[N] lengths")
    if lens.device != data.device:
        raise ValueError("data and lengths must be on one device")


def frame_body_packed(src: torch.Tensor, lens: torch.Tensor,
                      comp: torch.Tensor, comp_lens: torch.Tensor):
    """Pack per-block payloads into one contiguous LZ4 frame body.

    For each block with ``lens > 0``: a little-endian size word, then the
    compressed payload, or the raw block with ``INCOMPRESSIBLE_MASK`` set
    when compressing did not make it smaller
    (``LZ4FrameOutputStream.java:215-222``). On the card the offsets are
    scanned there, the body's size is the one value read back, and one
    launch of ``csrc/frame_pack.cu`` copies every block; on the CPU this
    is :func:`frame_body_packed_plain`. Lengths must lie within the rows
    (``ValueError`` otherwise).

    Returns (body uint8[total], total).
    """
    if src.device.type == "cpu":
        return frame_body_packed_plain(src, lens, comp, comp_lens)
    _check_pack_batch(src, lens)
    _check_pack_batch(comp, comp_lens)
    n = lens.shape[0]
    if comp.shape[0] != n or comp.device != src.device:
        raise ValueError("src and comp must hold the same blocks on one device")
    dev = src.device
    if not n:
        return torch.empty((0,), dtype=torch.uint8, device=dev), 0
    # each block's payload is the smaller of its two lengths (the raw one
    # when comp_lens >= lens); few torch calls, as each costs host time
    emit = torch.where(lens > 0, torch.minimum(lens, comp_lens) + 4, 0)
    ends = torch.cumsum(emit, 0)            # int64
    offs = (ends - emit).to(torch.int32)    # wraps only where total is refused
    total, lens_max, comp_min, comp_max = torch.stack(
        (ends[-1], lens.max(), comp_lens.min(), comp_lens.max())).tolist()
    if lens_max > src.shape[1] or comp_min < 0 or comp_max > comp.shape[1]:
        raise ValueError("lengths must lie within the rows")
    if total >= 2 ** 31:
        raise ValueError("frame body of 2 GiB or more")
    body = torch.empty((total,), dtype=torch.uint8, device=dev)
    FRAME_PACK(src.data_ptr(), src.stride(0), lens.data_ptr(), comp.data_ptr(),
               comp.stride(0), comp_lens.data_ptr(), offs.data_ptr(),
               body.data_ptr(), n, cuda_stream(src))
    return body, total


def frame_body_packed_plain(src: torch.Tensor, lens: torch.Tensor,
                            comp: torch.Tensor, comp_lens: torch.Tensor):
    """Plain version of :func:`frame_body_packed`, on any device: output
    bytes gathered in chunks of whole blocks, with int32 positions.

    Returns (body uint8[total], total).
    """
    n = lens.shape[0]
    dev = src.device
    use_raw = comp_lens >= lens
    payload = torch.where(use_raw, lens, comp_lens)
    emit = torch.where(lens > 0, payload + 4, torch.zeros_like(payload))
    ends = torch.cumsum(emit, 0, dtype=torch.int64)
    total = int(ends[-1]) if n else 0
    if total >= 2 ** 31:
        raise ValueError("frame body of 2 GiB or more")
    ends = ends.to(torch.int32)
    offs = ends - emit
    # INCOMPRESSIBLE_MASK as an int32 bit pattern
    size_word = torch.where(use_raw, lens | (INCOMPRESSIBLE_MASK - 2 ** 32),
                            comp_lens)
    src_flat = src.reshape(-1)
    comp_flat = comp.reshape(-1)
    body = torch.empty((total,), dtype=torch.uint8, device=dev)

    ends_host = ends.cpu().tolist()
    b0 = 0
    while b0 < n:
        base = ends_host[b0 - 1] if b0 else 0
        b1 = b0 + 1
        while b1 < n and ends_host[b1] - base <= _PACK_CHUNK:
            b1 += 1
        size = ends_host[b1 - 1] - base
        if size:
            j = torch.arange(base, base + size, dtype=torch.int32, device=dev)
            blk = torch.searchsorted(ends[b0:b1], j, right=True,
                                     out_int32=True) + b0
            rel = j - offs.index_select(0, blk)
            k = torch.clamp(rel - 4, min=0).to(torch.int64)
            blk64 = blk.to(torch.int64)
            raw_b = src_flat.index_select(
                0, blk64 * src.shape[1] + torch.clamp(k, max=src.shape[1] - 1))
            comp_b = comp_flat.index_select(
                0, blk64 * comp.shape[1] + torch.clamp(k, max=comp.shape[1] - 1))
            shift = torch.clamp(rel, max=3) * 8
            size_b = (size_word.index_select(0, blk) >> shift) & 0xFF
            byte = torch.where(rel < 4, size_b.to(torch.uint8),
                               torch.where(use_raw.index_select(0, blk),
                                           raw_b, comp_b))
            body[base:base + size] = byte
        b0 = b1
    return body, total


def compress_frame_packed(data, block_size: int = 1 << 16,
                          content_checksum: bool = True,
                          device: str | torch.device = "cuda") -> bytes:
    """Compress ``data`` into a standard LZ4 frame of independent blocks.

    The batch step of ``compress_stream``: one upload through the pinned
    staging buffer, the blocks compressed (``cuda_instances.compress_rows``)
    and the frame body packed on the device, one download; the host adds
    the 7-byte header, the end mark and the content checksum, which is
    XXH32 over the whole input as one block on the device. The output is
    byte-identical to ``lz4_tpu.formats.frame.compress_frame`` with the
    same block size and ``(BLOCK_INDEPENDENCE[, CONTENT_CHECKSUM])``.
    """
    dev = resolve_device(device)
    header = frame_header(block_size, content_checksum)
    raw = memoryview(data).cast("B")
    n = -(-len(raw) // block_size)
    st = staging(dev, UP)
    # one row of a multiple of 16 bytes for the content checksum's K3
    host = st.take(max(16, -(-n * block_size // 16) * 16))
    host.numpy()[:len(raw)] = np.frombuffer(raw, np.uint8)
    flat = st.upload(host, dev)
    out = bytearray(header)
    if n:
        src, lens, comp, comp_lens, err = compress_rows(flat[:len(raw)],
                                                        block_size)
        check_compressed(err)
        body, _ = frame_body_packed(src, lens, comp, comp_lens)
        out += memoryview(staging(dev, DOWN).download(body))
    out += struct.pack("<I", 0)
    if content_checksum:
        length = torch.tensor([len(raw)], dtype=torch.int32, device=dev)
        h = xxh32_batch(flat.view(1, -1), length, 0)
        out += struct.pack("<I", int(h.cpu().numpy()[0]))
    return bytes(out)


# ---------------------------------------------------------------------------
# the roundtrip step
# ---------------------------------------------------------------------------

def _kinds(rng: np.random.Generator, n_blocks: int) -> np.ndarray:
    n_a4, n_text = n_blocks // 2, n_blocks // 4
    return rng.permutation(np.repeat(
        [0, 1, 2], [n_a4, n_text, n_blocks - n_a4 - n_text]))


def block_kinds(n_blocks: int, seed: int = 0) -> np.ndarray:
    """The kind of each block of ``make_blocks(n_blocks, ..., seed)``: 0
    alphabet-4, 1 text, 2 incompressible."""
    return _kinds(np.random.default_rng(seed), n_blocks)


def make_blocks(n_blocks: int, block_len: int, seed: int = 0) -> np.ndarray:
    """Seeded test data, uint8[n_blocks, block_len], in three kinds:

    - half alphabet-4 bytes (the generator of ``sharded.py:381-383``);
    - a quarter repeated phrases from a small vocabulary with about one
      byte in 64 mutated, standing in for log and text data;
    - the rest incompressible bytes, which the frame stores raw.

    Kinds are spread over the batch by a seeded permutation
    (:func:`block_kinds`).
    """
    rng = np.random.default_rng(seed)
    kinds = _kinds(rng, n_blocks)
    n_a4 = int((kinds == 0).sum())
    n_text = int((kinds == 1).sum())
    out = np.empty((n_blocks, block_len), np.uint8)
    out[kinds == 0] = rng.integers(0, 4, (n_a4, block_len), dtype=np.uint8)
    out[kinds == 2] = rng.integers(0, 256, (n_blocks - n_a4 - n_text, block_len),
                                   dtype=np.uint8)
    vocab = [rng.integers(32, 127, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(4, 48, 512)]
    n_words = block_len // 4 + 1
    for i in np.flatnonzero(kinds == 1):
        words = rng.integers(0, len(vocab), n_words)
        row = np.frombuffer(b"".join(vocab[w] for w in words)[:block_len],
                            np.uint8).copy()
        hits = rng.integers(0, block_len, block_len // 64)
        row[hits] = rng.integers(0, 256, hits.size, dtype=np.uint8)
        out[i] = row
    return out


@dataclasses.dataclass
class Roundtrip:
    """What one roundtrip step leaves on the device, and its phase times."""
    ok: torch.Tensor            # bool[N]: compressed, decoded and equal
    compressed_total: int
    offsets: torch.Tensor       # int32[N], pack_offsets(comp_lens)
    hashes: torch.Tensor        # uint32[N], XXH32 of each block, seed 0
    comp: torch.Tensor
    comp_lens: torch.Tensor
    body: torch.Tensor          # uint8[body_total], the packed frame body
    body_total: int
    phase_ms: dict              # CUDA-event times per phase; empty on the CPU


def upload_blocks(data: np.ndarray, device: torch.device):
    """uint8[N, L] host blocks -> the port's layout on ``device``."""
    n, block_len = data.shape
    src = torch.zeros((n, row_stride(block_len)), dtype=torch.uint8,
                      device=device)
    src[:, :block_len] = torch.from_numpy(data).to(device)
    lens = torch.full((n,), block_len, dtype=torch.int32, device=device)
    return src, lens


def roundtrip_step(n_blocks: int, block_len: int, seed: int = 0,
                   device: str | torch.device = "cuda") -> Roundtrip:
    """Make ``n_blocks`` seeded blocks of ``block_len`` bytes
    (:func:`make_blocks`), move them to the device, then compress,
    checksum, decode and verify, and pack them there. On the card each
    phase is timed with CUDA events."""
    dev = resolve_device(device)
    src, lens = upload_blocks(make_blocks(n_blocks, block_len, seed), dev)
    timed = dev.type == "cuda"
    marks = []

    def mark():
        if timed:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)

    mark()
    comp, comp_lens, cerr = compress_fast_batch(
        src, lens, max_compressed_length(block_len))
    offsets = pack_offsets(comp_lens)
    mark()
    hashes = xxh32_batch(src, lens, 0)
    mark()
    out, out_lens, derr = decompress_safe_batch(comp, comp_lens, block_len)
    ok = ((cerr == 0) & (derr == 0) & (out_lens == lens)
          & (out[:, :block_len] == src[:, :block_len]).all(1))
    mark()
    body, body_total = frame_body_packed(src, lens, comp, comp_lens)
    mark()
    phase_ms = {}
    if timed:
        torch.cuda.synchronize(dev)
        for name, a, b in zip(("compress", "checksum", "decode", "pack"),
                              marks, marks[1:]):
            phase_ms[name] = a.elapsed_time(b)
    return Roundtrip(ok, int(comp_lens.sum()), offsets, hashes, comp,
                     comp_lens, body, body_total, phase_ms)
