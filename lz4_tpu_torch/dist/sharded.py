"""Data-parallel sharded codec: the blocks of a batch split over ranks.

Counterpart of ``lz4_tpu/dist/sharded.py``, with its names so a reader
finds each counterpart. On one device: ``pack_offsets``,
``frame_body_packed`` (``_frame_body_packed``, ``sharded.py:271-306``; the
kernel ``csrc/frame_pack.cu``), ``compress_frame_packed`` and
``roundtrip_step``: compress, block checksums, the exclusive scan of
compressed lengths, decode and verify, and packing of the frame body, all
on the device. Beside the frame's body, the LZ4Block stream's calls of
``kernels/block_stream.py``: ``block_stream_body_packed`` (the same pack
body with the stream's 21-byte headers), ``block_stream_index`` and
``decompress_block_stream_batch``.

Over the ranks of a :class:`~.mesh.BlockMesh`: ``shard_compress_blocks``
(fast, or HC at ``level``), ``shard_decompress_blocks``, ``shard_xxh32``,
``shard_xxh64``, ``compress_frame_sharded``,
``compress_frame_sharded_packed`` and ``sharded_roundtrip_step``. JAX
split one process's batch over a mesh with ``shard_map``;
``torch.distributed`` runs a process a rank, so every function here
follows ``multihost.py``'s model: every rank is given the whole batch,
runs the kernels of its own block range (``BlockMesh.block_range``) on its
own device, and the results are exchanged and put together in rank order,
which is block order, so that every rank returns the same whole result.
Without a process group the world is one rank and nothing is exchanged.

The exchange (``multihost.py:85-111``'s protocol): an ``all_gather`` of
each rank's block count and lengths, or of its payload's size, then of
its payload padded to the largest. Which tensors the collectives take:

- NCCL: tensors on the card (``all_gather_into_tensor``). A packed frame
  body, the step's lengths, flags and hashes are gathered on the card,
  then downloaded once; compressed blocks given back as ``bytes`` are
  joined on the host and uploaded for the exchange.
- gloo: host tensors. Each rank downloads its shard's result once and the
  exchange runs on the host; a rank on a card shares it this way.

A rank whose blocks fail tells the others in the first exchange, and every
rank raises ``Lz4Error``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import struct

import numpy as np
import torch
import torch.distributed as dist

from ..api.cuda_instances import compress_rows
from ..core.constants import max_compressed_length
from ..core.device import resolve_device
from ..core.errors import Lz4Error
from ..formats.frame import BlockSize, INCOMPRESSIBLE_MASK, frame_header
from ..kernels.block_stream import (  # noqa: F401  (the LZ4Block calls)
    block_stream_body_packed, block_stream_index,
    decompress_block_stream_batch)
from ..kernels.build import Kernel
from ..kernels.codec import compress_fast_batch, decompress_safe_batch
from ..kernels.hc import check_level, compress_hc_batch
from ..kernels.layout import (
    DOWN, UP, check_rows, cuda_stream, from_device_layout, row_stride,
    staging, to_device_layout)
from ..kernels.xxhash import split_u64, xxh32_batch, xxh64_batch
from ..utils.profiling import entry, readback
from .mesh import BlockMesh, block_mesh

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


@entry
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
    check_rows(src, lens)
    check_rows(comp, comp_lens)
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
    with readback("frame_body", ends):
        total, lens_max, comp_min, comp_max = torch.stack(
            (ends[-1], lens.max(), comp_lens.min(), comp_lens.max())).tolist()
    if lens_max > src.shape[1] or comp_min < 0 or comp_max > comp.shape[1]:
        raise ValueError("lengths must lie within the rows")
    if total >= 2 ** 31:
        raise ValueError("frame body of 2 GiB or more")
    body = torch.empty((total,), dtype=torch.uint8, device=dev)
    FRAME_PACK(src.data_ptr(), src.stride(0), lens.data_ptr(), comp.data_ptr(),
               comp.stride(0), comp_lens.data_ptr(), offs.data_ptr(),
               body.data_ptr(), n, cuda_stream(src),
               device=src.device.index)
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
    :func:`compress_frame_sharded_packed` on one rank.
    """
    return compress_frame_sharded_packed(
        data, block_size, BlockMesh(0, 1, None, resolve_device(device)),
        content_checksum)


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


# ---------------------------------------------------------------------------
# the exchange between ranks
# ---------------------------------------------------------------------------

def _wire(mesh: BlockMesh) -> torch.device:
    """Where the collectives take their tensors: the card on NCCL, the
    host on gloo."""
    return mesh.device if mesh.backend == "nccl" else torch.device("cpu")


def _all_gather(mesh: BlockMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` (on the wire device) of every rank, in rank order:
    ``[world_size, *t.shape]``."""
    t = t.contiguous()
    if mesh.backend == "nccl":
        out = torch.empty((mesh.world_size * t.numel(),), dtype=t.dtype,
                          device=t.device)
        dist.all_gather_into_tensor(out, t.view(-1), group=mesh.group)
        return out.view(mesh.world_size, *t.shape)
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.stack(parts)


def _gather_ranges(mesh: BlockMesh, t: torch.Tensor,
                   n_blocks: int) -> torch.Tensor:
    """The rows of ``t``, one a block of this rank's range, of every rank in
    block order: ``[n_blocks, ...]``, on the wire device (``t`` itself
    without a group). Each rank's rows go padded to the longest range."""
    if mesh.group is None or not n_blocks:
        return t
    dtype = t.dtype
    if dtype in (torch.bool, torch.uint32):   # as the collectives take them
        t = t.to(torch.uint8) if dtype == torch.bool else t.view(torch.int32)
    per = -(-n_blocks // mesh.world_size)
    padded = torch.zeros((per, *t.shape[1:]), dtype=t.dtype,
                         device=_wire(mesh))
    padded[:t.shape[0]] = t
    out = _all_gather(mesh, padded).view(-1, *t.shape[1:])[:n_blocks]
    if dtype == torch.bool:
        return out.bool()
    return out.view(dtype)


def _gather_bytes(mesh: BlockMesh, payload: torch.Tensor, what: str,
                  failed: bool = False) -> torch.Tensor:
    """``payload`` (uint8[k] on the wire device) of every rank, joined in
    rank order. The first exchange carries each rank's ``failed``: if any
    rank failed, every rank raises ``Lz4Error`` (``what failed``)."""
    if mesh.group is None:
        if failed:
            raise Lz4Error(f"{what} failed")
        return payload
    head = torch.tensor([payload.numel(), int(failed)], dtype=torch.int64,
                        device=_wire(mesh))
    with readback("gather_bytes", head):
        heads = _all_gather(mesh, head).tolist()
    bad = [r for r, (_, f) in enumerate(heads) if f]
    if bad:
        raise Lz4Error(f"{what} failed on rank(s) {bad}")
    sizes = [size for size, _ in heads]
    largest = max(sizes)
    if not largest:
        return payload
    padded = torch.zeros((largest,), dtype=torch.uint8, device=payload.device)
    padded[:payload.numel()] = payload
    rows = _all_gather(mesh, padded)
    if mesh.world_size == 1:
        return rows[0]
    return torch.cat([rows[r, :size] for r, size in enumerate(sizes)])


def _to_wire(mesh: BlockMesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` where the collectives take it: one download on gloo."""
    return t if mesh.group is None else t.to(_wire(mesh))


def _host_bytes(t: torch.Tensor) -> bytes:
    """uint8 ``t`` as bytes; one download through the staging buffer."""
    if t.device.type == "cuda":
        return staging(t.device, DOWN).download(t).tobytes()
    return t.numpy().tobytes()


def _gather_blocks(mesh: BlockMesh, local: list[bytes], n_blocks: int,
                   what: str, failed: bool = False) -> list[bytes]:
    """The blocks of every rank's range, in block order."""
    if mesh.group is None:
        if failed:
            raise Lz4Error(f"{what} failed")
        return local
    wire = _wire(mesh)
    blob = np.frombuffer(b"".join(local), np.uint8).copy()
    payload = _gather_bytes(mesh, torch.from_numpy(blob).to(wire), what,
                            failed)
    lens = _gather_ranges(mesh, torch.tensor([len(b) for b in local],
                                             dtype=torch.int64, device=wire),
                          n_blocks).tolist()
    data = _host_bytes(payload)
    ends = np.cumsum(lens).tolist()
    return [data[e - k:e] for e, k in zip(ends, lens)]


# ---------------------------------------------------------------------------
# blocks over ranks
# ---------------------------------------------------------------------------

def shard_compress_blocks(blocks, mesh: BlockMesh | None = None,
                          level: int | None = None) -> list[bytes]:
    """Compress independent blocks, each rank its range, in one launch on
    its device: K2 (the fast scan) for ``level=None``, K6 (HC) at
    ``level`` 1..17. Byte-identical to every tier. Returns every block's
    output in order on every rank."""
    if level is not None:
        check_level(level)
    if not blocks:
        return []
    mesh = mesh or block_mesh()
    start, end = mesh.block_range(len(blocks))
    local, failed = [], False
    if end > start:
        cap = max(len(b) for b in blocks)
        src, lens = to_device_layout(blocks[start:end], cap, mesh.device)
        dest_cap = max_compressed_length(cap)
        if level is None:
            comp, comp_lens, err = compress_fast_batch(src, lens, dest_cap)
        else:
            comp, comp_lens, err = compress_hc_batch(src, lens, dest_cap,
                                                     level)
        failed = bool(err.any())
        if not failed:
            local = from_device_layout(comp, comp_lens)
    return _gather_blocks(mesh, local, len(blocks), "sharded compression",
                          failed)


def shard_decompress_blocks(blocks, out_max: int,
                            mesh: BlockMesh | None = None) -> list[bytes]:
    """Decode independent blocks (each at most ``out_max`` bytes), each
    rank its range, in one K1 launch on its device. Raises ``Lz4Error`` on
    every rank if a block does not decode."""
    if not blocks:
        return []
    mesh = mesh or block_mesh()
    start, end = mesh.block_range(len(blocks))
    local, failed = [], False
    if end > start:
        comp, comp_lens = to_device_layout(blocks[start:end],
                                           device=mesh.device)
        out, out_lens, err = decompress_safe_batch(comp, comp_lens, out_max)
        failed = bool(err.any())
        if not failed:
            local = from_device_layout(out, out_lens)
    return _gather_blocks(mesh, local, len(blocks), "sharded decompression",
                          failed)


def _local_rows(data, lens, mesh: BlockMesh):
    """This rank's rows of ``uint8[N, L]`` (a tensor or an array) and
    their lengths, in the port's layout on its device; and N."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.array(data, np.uint8))
    lens = torch.as_tensor(lens).to(torch.int32)
    n, width = data.shape
    start, end = mesh.block_range(n)
    src = torch.zeros((end - start, row_stride(width)), dtype=torch.uint8,
                      device=mesh.device)
    src[:, :width] = data[start:end].to(mesh.device)
    return src, lens[start:end].to(mesh.device).contiguous(), n


def shard_xxh32(data, lens, seed: int = 0,
                mesh: BlockMesh | None = None) -> torch.Tensor:
    """XXH32 of each row of ``uint8[N, L]`` (its first ``lens[i]`` bytes),
    each rank its rows in one K3 launch: ``uint32[N]`` in row order on
    every rank, on the exchange's device (this rank's without a group or
    on NCCL, the host on gloo)."""
    mesh = mesh or block_mesh()
    src, src_lens, n = _local_rows(data, lens, mesh)
    h = (xxh32_batch(src, src_lens, seed) if len(src)
         else torch.empty((0,), dtype=torch.uint32, device=mesh.device))
    return _gather_ranges(mesh, h, n)


def shard_xxh64(data, lens, seed: int = 0, mesh: BlockMesh | None = None):
    """XXH64 of each row of ``uint8[N, L]``, each rank its rows in one K4
    launch: ``(hi, lo)`` uint32[N] as the JAX function gives them (combine
    with ``kernels.xxhash.join_u64``), on the exchange's device."""
    mesh = mesh or block_mesh()
    src, src_lens, n = _local_rows(data, lens, mesh)
    h = (xxh64_batch(src, src_lens, seed) if len(src)
         else torch.empty((0,), dtype=torch.int64, device=mesh.device))
    return split_u64(_gather_ranges(mesh, h, n))


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------

def split_frame_blocks(data, block_size: int) -> list[bytes]:
    """Chunk ``data`` into frame blocks, validating the frame block size."""
    if block_size not in {b.num_bytes for b in BlockSize}:
        raise ValueError("block_size must be one of 64KB/256KB/1MB/4MB")
    raw = memoryview(data).cast("B")
    return [bytes(raw[i:i + block_size])
            for i in range(0, len(raw), block_size)]


def _frame_body(blocks, compressed) -> bytes:
    """Size words and payloads of a frame body (no end mark); a block is
    stored raw when compressing did not make it smaller."""
    parts = []
    for raw, comp in zip(blocks, compressed):
        if len(comp) >= len(raw):
            parts += (struct.pack("<I", len(raw) | INCOMPRESSIBLE_MASK), raw)
        else:
            parts += (struct.pack("<I", len(comp)), comp)
    return b"".join(parts)


def _upload_input(raw: memoryview, dev: torch.device) -> torch.Tensor:
    """``raw`` on ``dev`` in one staged upload, in a row of a multiple of
    16 bytes (at least 16) for K3 over the whole input."""
    st = staging(dev, UP)
    host = st.take(max(16, -(-len(raw) // 16) * 16))
    host.numpy()[:len(raw)] = np.frombuffer(raw, np.uint8)
    return st.upload(host, dev)


def _content_checksum(flat: torch.Tensor, n: int) -> bytes:
    """The content checksum of the first ``n`` bytes of ``flat`` (from
    :func:`_upload_input`): XXH32 as one row, K3 on the card."""
    length = torch.tensor([n], dtype=torch.int32, device=flat.device)
    h = xxh32_batch(flat.view(1, -1), length, 0)
    return struct.pack("<I", int(h.cpu().numpy()[0]))


def assemble_frame(data, blocks, compressed, block_size: int,
                   content_checksum: bool = True,
                   device: str | torch.device = "cuda") -> bytes:
    """Put per-block payloads together into one LZ4 frame on the host, in
    order (incompressible blocks raw, end mark, content checksum, which is
    K3 over ``data`` on ``device``): the assembler of the listed paths."""
    raw = memoryview(data).cast("B")
    out = frame_header(block_size, content_checksum)
    out += _frame_body(blocks, compressed) + struct.pack("<I", 0)
    if content_checksum:
        out += _content_checksum(_upload_input(raw, resolve_device(device)),
                                 len(raw))
    return out


def compress_frame_sharded(data, block_size: int = 1 << 16,
                           mesh: BlockMesh | None = None,
                           content_checksum: bool = True,
                           level: int | None = None) -> bytes:
    """Compress ``data`` into a standard LZ4 frame, the blocks split over
    the ranks (:func:`shard_compress_blocks`, HC at ``level``) and put
    together on the host (:func:`assemble_frame`); every rank returns the
    same frame."""
    mesh = mesh or block_mesh()
    blocks = split_frame_blocks(data, block_size)
    compressed = shard_compress_blocks(blocks, mesh, level) if blocks else []
    return assemble_frame(data, blocks, compressed, block_size,
                          content_checksum, mesh.device)


def compress_frame_sharded_packed(data, block_size: int = 1 << 16,
                                  mesh: BlockMesh | None = None,
                                  content_checksum: bool = True,
                                  level: int | None = None) -> bytes:
    """Like :func:`compress_frame_sharded`, with each rank's part of the
    frame body packed on its device: the input uploaded once, the rank's
    blocks compressed in one launch (K2, or K6 at ``level``) and packed in
    one ``frame_pack`` launch; the bodies joined in rank order (packing is
    per block, so that is the frame's body), downloaded once. The host adds
    the header, the end mark and the content checksum (one K3 launch over
    the whole input). Byte-identical to ``lz4_tpu.formats.frame.
    compress_frame`` with ``(BLOCK_INDEPENDENCE[, CONTENT_CHECKSUM])``.
    """
    if level is not None:
        check_level(level)
    mesh = mesh or block_mesh()
    dev = mesh.device
    header = frame_header(block_size, content_checksum)
    raw = memoryview(data).cast("B")
    flat = _upload_input(raw, dev)
    start, end = mesh.block_range(-(-len(raw) // block_size))
    body = torch.empty((0,), dtype=torch.uint8, device=dev)
    failed = False
    if end > start:
        src, lens, comp, comp_lens, err = compress_rows(
            flat[start * block_size:min(end * block_size, len(raw))],
            block_size, level or 0)
        failed = bool(err.any())
        if not failed:
            body, _ = frame_body_packed(src, lens, comp, comp_lens)
    body = _gather_bytes(mesh, _to_wire(mesh, body), "device compression",
                         failed)
    out = bytearray(header)
    out += _host_bytes(body)
    out += struct.pack("<I", 0)
    if content_checksum:
        out += _content_checksum(flat, len(raw))
    return bytes(out)


# ---------------------------------------------------------------------------
# the sharded roundtrip step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ShardedRoundtrip:
    """What one sharded step gives every rank: the whole batch's results
    in block order, on the exchange's device."""
    ok: torch.Tensor            # bool[N]: compressed, decoded and equal
    compressed_total: int
    offsets: torch.Tensor       # int32[N], pack_offsets of every comp_len
    hashes: torch.Tensor        # uint32[N], XXH32 of each block, seed 0
    body: torch.Tensor          # uint8[body_total], the packed frame body
    body_total: int
    block_range: tuple[int, int]   # this rank's blocks
    phase_ms: dict              # CUDA-event times per phase; empty on the CPU


def sharded_roundtrip_step(mesh: BlockMesh, n_blocks_per_dev: int = 2,
                           block_len: int = 256,
                           seed: int = 0) -> ShardedRoundtrip:
    """One full sharded step, the counterpart of ``dryrun_multichip``'s:
    every rank makes the global ``make_blocks(world_size *
    n_blocks_per_dev, block_len, seed)`` batch and, on its own range:
    compress (K2), the global exclusive scan of compressed lengths (an
    ``all_gather`` of them, then :func:`pack_offsets`), block checksums
    (K3), decode and verify (K1), and packing of its frame body
    (``frame_pack``); then the flags, hashes and bodies are gathered.
    Every rank checks the gathered body against the body the host
    assembles from the gathered compressed blocks (``sharded.py:408-421``)
    and raises ``AssertionError`` if they differ. On the card each phase,
    the exchange included, is timed with CUDA events.
    """
    if n_blocks_per_dev < 1:
        raise ValueError("n_blocks_per_dev must be >= 1")
    dev = mesh.device
    n = mesh.world_size * n_blocks_per_dev
    data = make_blocks(n, block_len, seed)
    start, end = mesh.block_range(n)
    src, lens = upload_blocks(data[start:end], dev)
    marks = []

    def mark(name):
        if dev.type == "cuda":
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(dev))
            marks.append((name, ev))

    mark(None)
    comp, comp_lens, cerr = compress_fast_batch(
        src, lens, max_compressed_length(block_len))
    mark("compress")
    all_lens = _gather_ranges(mesh, comp_lens, n)
    offsets = pack_offsets(all_lens)
    mark("offsets")
    hashes = xxh32_batch(src, lens, 0)
    mark("checksum")
    out, out_lens, derr = decompress_safe_batch(comp, comp_lens, block_len)
    ok = ((cerr == 0) & (derr == 0) & (out_lens == lens)
          & (out[:, :block_len] == src[:, :block_len]).all(1))
    mark("decode")
    body, _ = frame_body_packed(src, lens, comp, comp_lens)
    mark("pack")
    ok = _gather_ranges(mesh, ok, n)
    hashes = _gather_ranges(mesh, hashes, n)
    body = _gather_bytes(mesh, _to_wire(mesh, body), "the sharded step")
    mark("exchange")
    phase_ms = {}
    if marks:
        torch.cuda.synchronize(dev)
        for (_, a), (name, b) in zip(marks, marks[1:]):
            phase_ms[name] = a.elapsed_time(b)

    comp_blocks = _gather_blocks(mesh, from_device_layout(comp, comp_lens), n,
                                 "the sharded step")
    expect = _frame_body([row.tobytes() for row in data], comp_blocks)
    if _host_bytes(body) != expect:
        raise AssertionError("device-packed frame body mismatch")
    return ShardedRoundtrip(ok, int(all_lens.sum()), offsets, hashes, body,
                            body.numel(), (start, end), phase_ms)
