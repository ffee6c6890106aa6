"""Stream pipeline: binary streams cut into frame blocks, compressed and
decoded in batches on the card, written as standard LZ4 frames in order.

Counterpart of ``lz4_tpu/streams/pipeline.py`` with its names
(``BatchEngine``, ``get_engine``, ``compress_stream``,
``decompress_stream``). Blocks are independent (``BLOCK_INDEPENDENCE``), so
a batch of them is one kernel launch each way, and the frame bytes equal
those of the one-block-at-a-time writer.

Engines, each on one device (the card unless told otherwise):

- ``cuda``: compresses with K2 and decodes with K1 (the ``cuda`` tier); the
  counterpart of the JAX ``pallas`` engine;
- ``segment``: compresses as ``cuda`` does (the JAX engine compresses with
  its native tier, byte-identical), and decodes with the sequence parser
  and K5 (``kernels/segment_decode.py``);
- ``fastest``: ``cuda``;
- ``parallel``: compresses with the parallel compressor (K7,
  ``kernels/parallel_compress.py``: valid LZ4, not the fast scan's bytes)
  and decodes as ``cuda`` does, the counterpart of the JAX engine, which
  decodes on its native tier; it has no HC levels;
- ``sharded``: the blocks of a batch split over the ranks of the current
  process group (``dist/sharded.py``: ``shard_compress_blocks`` and
  ``shard_decompress_blocks``, each rank on its own device), every rank
  writing the same frame; with no group, one rank, and the frame of
  ``cuda``. It has only the listed forms.

``level`` 1..17 compresses with HC at that level (K6, the tier's
``high_compressor(level)``), through the same data plane. The JAX engines
``native`` and ``safe`` (host tiers) are not ported. With
``allow_dependent`` a frame of linked blocks (``lz4 -BD``) is decoded a
batch of up to 64 MiB at a time (``_LinkedFrameBody``: one walk and one
resolve of ``kernels/linked_decode.py`` a batch, against the window of
the output before it, kept on the card), with the output and errors of
the serial frame reader (``formats/frame.py::Lz4FrameInputStream``), to
which the JAX pipeline hands such a frame
(``lz4_tpu/streams/pipeline.py:387-403``); by default it is refused.
:func:`decode_frames` is the frame loop, also used by
``formats.decompress_frame``: it decodes dictionary frames too, a batch in
one launch of K1 with the dictionary as every row's history.

The data plane of a batch (the JAX pipeline's packed fast paths,
``:231-261,407-456``), when the engine has its packed forms:

- compress: the batch is read straight into the pinned staging buffer
  (``readinto``), uploaded once, compressed with K2 (K6 at an HC level, K7
  for ``parallel``),
  packed into the frame body on the card
  (``dist/sharded.py::frame_body_packed``), downloaded once and written
  with one ``dst.write``; while the card compresses a batch,
  the host writes the one before and reads the one after;
- decompress: the frame walk reads each payload into its row of the pinned
  buffer, the batch is uploaded once, its block checksums are one K3
  launch, the compressed rows are one decode, and the output is put
  together on the card in frame order, downloaded once and written with
  one ``dst.write``.

The content checksum is a streaming XXH32 whose state is on the engine's
device; it absorbs each batch where it lies, on its own CUDA stream, while
the card works on what comes next (``kernels/xxhash_stream.py``).
``dst.write`` is handed a view of the staging buffer, valid during the
call, as ``io.RawIOBase.write`` allows.
"""

from __future__ import annotations

import contextlib
import functools
import struct

import numpy as np
import torch

from ..api import cuda_instances
from ..api.factory import Lz4Factory
from ..core.constants import MAX_COMPRESSION_LEVEL, U32
from ..core.device import resolve_device
from ..core.errors import Lz4Error, Lz4FrameError
from ..dist.mesh import block_mesh
from ..dist.sharded import (
    frame_body_packed, shard_compress_blocks, shard_decompress_blocks)
from ..formats.frame import (
    _BATCH_BYTES, BlockSize, FrameFlag, INCOMPRESSIBLE_MASK, MAGIC,
    MAGIC_SKIPPABLE_BASE, _bd_from_byte, _flg_from_byte, _flg_to_byte,
    xxh32_bytes,
)
from ..kernels import linked_decode, parallel_compress, segment_decode
from ..kernels.codec import ERR_DEST_TOO_SMALL, WINDOW
from ..kernels.layout import DOWN, UP, row_stride, staging
from ..kernels.xxhash import xxh32_batch
from ..kernels.xxhash_stream import StreamState32
from ..utils.buffers import read_into
from ..utils.profiling import part

ENGINES = ("fastest", "cuda", "segment", "sharded", "parallel")

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class BatchEngine:
    """Batched block codecs on one device.

    - ``compress_batch(list[bytes]) -> list[bytes]`` and
      ``decompress_batch(list[bytes], out_max) -> list[bytes]``;
    - optionally the packed forms, the fields of the JAX engine's names,
      one contiguous buffer each way, here kept on the engine's device:
      ``compress_packed(data, block_size) -> (src, lens, comp, comp_lens,
      err)`` (``cuda_instances.compress_rows``, ``compress_parallel_rows``)
      and ``decompress_packed(comp,
      comp_lens, out_max) -> (out, out_lens)`` (``cuda_instances.
      decode_rows``, ``segment_decode.decompress_rows``). The pipeline
      takes them when they are set.
    """

    def __init__(self, name: str, compress_batch, decompress_batch,
                 device: torch.device, compress_packed=None,
                 decompress_packed=None):
        self.name = name
        self.compress_batch = compress_batch
        self.decompress_batch = decompress_batch
        self.device = device
        self.compress_packed = compress_packed
        self.decompress_packed = decompress_packed

    def __repr__(self):
        return f"BatchEngine({self.name}, {self.device})"


def get_engine(name: str = "fastest", level: int = 0,
               device: str | torch.device = "cuda") -> BatchEngine:
    """The engine ``name`` (one of :data:`ENGINES`) on ``device``; raises
    when ``device`` names a card and there is none.

    ``level`` 1..17 compresses with HC at that level on K6, packed or
    listed; 0 (or below) with the fast scan, as the JAX engines other than
    ``native`` do. ``parallel`` refuses a level above 0 with
    ``Lz4FrameError``, as the JAX engine does.
    """
    if name not in ENGINES:
        raise ValueError(
            f"unknown engine {name!r}: the port has {', '.join(ENGINES)} "
            "(the JAX engines native and safe are not ported)")
    dev = resolve_device(device)
    name = "cuda" if name == "fastest" else name
    if name == "parallel":
        if level > 0:
            # no parallel HC exists: refusing beats handing back the
            # parallel compressor's output at a requested level
            raise Lz4FrameError(
                f"engine 'parallel' has no HC mode (level={level}); "
                "use engine 'cuda'/'segment'/'sharded' for HC")
        def decomp(blocks, out_max):
            # the tier's safe decoder, built (and self-tested) at first use
            # only: a compress through this engine runs K7 alone
            return Lz4Factory.cuda_instance(dev).safe_decompressor() \
                .decompress_batch(blocks, out_max)

        return BatchEngine(
            name, functools.partial(parallel_compress.compress_blocks,
                                    device=dev),
            decomp, dev, cuda_instances.compress_parallel_rows,
            cuda_instances.decode_rows)
    suffix = f"-hc{level}" if level > 0 else ""
    if name == "sharded":
        mesh = block_mesh(dev)
        return BatchEngine(
            name + suffix,
            functools.partial(shard_compress_blocks, mesh=mesh,
                              level=min(level, MAX_COMPRESSION_LEVEL)
                              if level > 0 else None),
            functools.partial(shard_decompress_blocks, mesh=mesh), dev)
    lz4 = Lz4Factory.cuda_instance(dev)
    if level > 0:
        comp, comp_packed = _hc_forms(lz4, level)
    else:
        comp = lz4.fast_compressor().compress_batch
        comp_packed = cuda_instances.compress_rows
    if name == "cuda":
        decomp = lz4.safe_decompressor().decompress_batch
        decomp_packed = cuda_instances.decode_rows
    else:
        def decomp(blocks, out_max):
            return segment_decode.decompress_blocks(blocks, out_max, dev)
        decomp_packed = segment_decode.decompress_rows
    return BatchEngine(name + suffix, comp, decomp, dev, comp_packed,
                       decomp_packed)


def _hc_forms(lz4: Lz4Factory, level: int):
    """The listed and the packed compress of HC at ``level`` (clamped to
    1..17 as ``high_compressor`` clamps it), both on K6."""
    hc = lz4.high_compressor(level)
    return hc.compress_batch, functools.partial(cuda_instances.compress_rows,
                                                level=hc.level)


def compress_stream(src, dst, block_size: BlockSize = BlockSize.SIZE_64KB,
                    engine: BatchEngine | str = "fastest",
                    content_checksum: bool = True, batch_blocks: int = 256,
                    level: int = 0,
                    device: str | torch.device = "cuda") -> int:
    """Compress a binary stream into one LZ4 frame on ``dst``.

    Reads ``batch_blocks`` blocks at a time and compresses them as one
    batch. ``level`` 0 is the fast scan, 1-17 HC at that level.
    ``device`` places an engine given by name. Returns the bytes written.
    """
    if isinstance(engine, str):
        engine = get_engine(engine, level, device)
    elif level > 0:
        comp, comp_packed = _hc_forms(Lz4Factory.cuda_instance(engine.device),
                                      level)
        engine = BatchEngine(f"{engine.name}-hc{level}", comp,
                             engine.decompress_batch, engine.device,
                             comp_packed, engine.decompress_packed)
    bs = block_size.num_bytes
    flags = {FrameFlag.BLOCK_INDEPENDENCE}
    if content_checksum:
        flags.add(FrameFlag.CONTENT_CHECKSUM)
    desc = bytes([_flg_to_byte(frozenset(flags)), (block_size.value & 7) << 4])
    header = _U32.pack(MAGIC) + desc + bytes([(xxh32_bytes(desc) >> 8) & 0xFF])
    content_hash = (StreamState32(0, engine.device) if content_checksum
                    else None)

    dst.write(header)
    written = len(header)
    if engine.compress_packed is not None:
        written += _compress_packed(src, dst, engine, bs, bs * batch_blocks,
                                    content_hash)
    else:
        written += _compress_listed(src, dst, engine, bs, bs * batch_blocks,
                                    content_hash)
    tail = _U32.pack(0)
    if content_hash is not None:
        tail += _U32.pack(content_hash.digest() & U32)
    dst.write(tail)
    return written + len(tail)


def _read_batch(src, up, want: int):
    """Up to ``want`` bytes of ``src`` in the staging buffer ``up``."""
    with part("read"):
        host = up.take(want)
        return host, read_into(src, host.numpy())


def _compress_packed(src, dst, engine, bs, want, content_hash) -> int:
    """The frame body through the packed compress, two batches in flight:
    while the card compresses batch i, the host checks, packs, downloads
    and writes batch i - 1 (on a stream of their own, after that batch's
    K2 or K6) and reads batch i + 1. Returns the bytes written."""
    dev = engine.device
    up = staging(dev, UP)
    emit_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    written, pending = 0, None
    host, n = _read_batch(src, up, want)
    while True:
        batch = None
        if n:
            with part("upload"):
                data = up.upload(host[:n], dev)
            if content_hash is not None:
                with part("content_hash"):
                    content_hash.update(data)
            batch = engine.compress_packed(data, bs)
            batch = (batch, _event(dev))
        if pending is not None:
            written += _emit_body(dst, dev, emit_stream, *pending)
        if batch is None:
            return written
        pending = batch
        host, n = _read_batch(src, up, want) if n == want else (None, 0)


def _event(dev: torch.device):
    """An event recorded on the current stream of a card; None on the CPU."""
    if dev.type != "cuda":
        return None
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(dev))
    return done


def _emit_body(dst, dev, stream, batch, done) -> int:
    """Check one compressed batch, pack its frame body, download and write
    it, on ``stream`` once ``done`` (its K2) has completed; returns the
    body's length."""
    src, lens, comp, comp_lens, err = batch
    ctx = contextlib.nullcontext()
    if stream is not None:
        stream.wait_event(done)
        ctx = torch.cuda.stream(stream)
    with ctx:
        cuda_instances.check_compressed(err)
        with part("kernels"):
            body, total = frame_body_packed(src, lens, comp, comp_lens)
        with part("download"):
            out = staging(dev, DOWN).download(body)
    with part("write"):
        dst.write(memoryview(out))
    return total


def _compress_listed(src, dst, engine, bs, want, content_hash) -> int:
    """The frame body through ``engine.compress_batch`` (an engine with
    no packed compress), a batch at a time; returns the bytes written."""
    written = 0
    while True:
        with part("read"):
            chunk = bytearray(want)
            n = read_into(src, chunk)
        if not n:
            return written
        view = memoryview(chunk)[:n]
        if content_hash is not None:
            with part("content_hash"):
                content_hash.update(view)
        blocks = [view[i:i + bs] for i in range(0, n, bs)]
        parts = []
        for raw, comp in zip(blocks, engine.compress_batch(blocks)):
            if len(comp) >= len(raw):
                parts += (_U32.pack(len(raw) | INCOMPRESSIBLE_MASK), raw)
            else:
                parts += (_U32.pack(len(comp)), comp)
        out = b"".join(parts)
        with part("write"):
            dst.write(out)
        written += len(out)
        if n < want:
            return written


def decompress_stream(src, dst, engine: BatchEngine | str = "fastest",
                      batch_blocks: int = 256,
                      allow_dependent: bool = False,
                      device: str | torch.device = "cuda") -> int:
    """Decode LZ4 frames (concatenated, with skippable frames between them)
    from ``src`` into ``dst``; compressed blocks are decoded in batches of
    ``batch_blocks``. ``device`` places an engine given by name. Returns
    the decompressed bytes written.

    ``allow_dependent`` also reads linked-block frames (``lz4 -BD``),
    ``batch_blocks`` blocks (at most 64 MiB of output) a batch, each
    decoded by one walk and one resolve against the output before it; the
    default refuses them like the reference."""
    return decode_frames(src, dst, engine, batch_blocks, device,
                         allow_dependent=allow_dependent)


def _dictionary_engine(engine: BatchEngine, dictionary) -> BatchEngine:
    """``engine`` decoding against ``dictionary`` (its last 64 KiB as the
    history of every block): the packed decode is one launch of K1 with
    that history a batch."""
    hist, hist_len = cuda_instances.window_tensor(dictionary, engine.device)
    return BatchEngine(
        f"{engine.name}-dict", engine.compress_batch,
        functools.partial(cuda_instances.decompress_blocks_with_history,
                          history=dictionary, device=engine.device),
        engine.device, decompress_packed=functools.partial(
            cuda_instances.decode_rows_hist, hist=hist, hist_len=hist_len))


def decode_frames(src, dst, engine: BatchEngine | str = "fastest",
                  batch_blocks: int = 256,
                  device: str | torch.device = "cuda",
                  allow_dependent: bool = False, dictionary=None,
                  single_frame: bool = False,
                  batch_bytes: int | None = None) -> int:
    """The frame loop of :func:`decompress_stream`; also reads dictionary
    frames (``dictionary``: its last 64 KiB are every independent block's
    window and the first window of a linked frame; the DictID field is
    accepted), and with ``single_frame`` stops after the first frame.
    ``batch_bytes``, when given, sets each frame's batch to that many bytes
    of its blocks instead of ``batch_blocks`` blocks; a batch of linked
    blocks holds at most 64 MiB of them. Returns the bytes written."""
    if isinstance(engine, str):
        engine = get_engine(engine, device=device)
    if dictionary is not None:
        engine = _dictionary_engine(engine, dictionary)
    written = 0

    def read_exact(n: int, eof_ok: bool = False):
        data = _read_full(src, n)
        if not data and eof_ok:
            return None
        if len(data) < n:
            raise Lz4FrameError("Stream ended prematurely")
        return data

    first = True
    while True:
        word = read_exact(4, eof_ok=not first)
        if word is None:
            break
        first = False
        magic = _U32.unpack(word)[0]
        if (magic >> 4) == (MAGIC_SKIPPABLE_BASE >> 4):
            skip = _U32.unpack(read_exact(4))[0]
            while skip:      # in chunks: the size comes from the input
                skip -= len(read_exact(min(skip, 1 << 20)))
            continue
        if magic != MAGIC:
            raise Lz4FrameError("Stream unsupported (not an LZ4 frame)")

        desc = read_exact(2)
        flags = _flg_from_byte(desc[0], allow_dependent,
                               dictionary is not None)
        bs = _bd_from_byte(desc[1]).num_bytes
        expected_size = -1
        if FrameFlag.CONTENT_SIZE in flags:
            raw8 = read_exact(8)
            desc += raw8
            expected_size = _U64.unpack(raw8)[0]
        if FrameFlag.DICT_ID in flags:
            desc += read_exact(4)
        hc = read_exact(1)
        if ((xxh32_bytes(desc) >> 8) & 0xFF) != hc[0]:
            raise Lz4FrameError("Frame header checksum mismatch")
        content_hash = (StreamState32(0, engine.device)
                        if FrameFlag.CONTENT_CHECKSUM in flags else None)
        batch = batch_blocks if batch_bytes is None else batch_bytes // bs
        if FrameFlag.BLOCK_INDEPENDENCE in flags:
            frame = _FrameBody(src, dst, engine, bs, max(1, batch),
                               FrameFlag.BLOCK_CHECKSUM in flags,
                               content_hash)
        else:
            frame = _LinkedFrameBody(
                src, dst, engine, bs, max(1, min(batch, _BATCH_BYTES // bs)),
                FrameFlag.BLOCK_CHECKSUM in flags, content_hash, dictionary)
        total = frame.run()
        written += total
        if content_hash is not None:
            expect = _U32.unpack(read_exact(4))[0]
            if expect != content_hash.digest() & U32:
                raise Lz4FrameError("Content checksum mismatch")
        if 0 <= expected_size != total:
            raise Lz4FrameError("Size check mismatch")
        if single_frame:
            break
    return written


def _read_full(src, n: int) -> bytes:
    """Up to ``n`` bytes; fewer only at the end of ``src``."""
    data = src.read(n)
    while data and len(data) < n:
        more = src.read(n - len(data))
        if not more:
            break
        data += more
    return data or b""


class _FrameBody:
    """The blocks of one frame, up to its end mark, decoded a batch at a
    time into ``dst``.

    The walk reads each payload into its row of the pinned staging buffer
    (``[lens int32[B] | rows uint8[B, row_stride(bs)]]``). It stops at
    ``B`` blocks, at the end mark, or at a fault of the walk ("Block size
    ... exceeded max", "Stream ended prematurely"). The block checksums of
    the blocks read are checked before that fault is raised and before
    anything of the batch is decoded, so a mismatch wins over both, as it
    does in the JAX walk, which checks each block as it reads it.

    With a packed decode, two batches are in flight: the card decodes
    batch i while the host walks batch i + 1, and batch i is checked and
    written before anything of batch i + 1 is checked or raised, so that
    ``dst`` and the exception are those of the JAX walk.
    """

    def __init__(self, src, dst, engine, bs, batch_blocks, block_checksum,
                 content_hash):
        self.src, self.dst, self.engine, self.bs = src, dst, engine, bs
        self.b = batch_blocks
        self.block_checksum = block_checksum
        self.content_hash = content_hash
        self.stride = row_stride(bs)
        self.rows_at = -(-4 * batch_blocks // 16) * 16
        self.up = staging(engine.device, UP)

    def run(self) -> int:
        total, pending = 0, None
        while True:
            with part("read"):
                host = self.up.take(self.rows_at + self.b * self.stride)
                n, raw, sums, end, fault = self._walk(host.numpy())
            if pending is not None:
                total += self._emit(*pending)
                pending = None
            if n and (self.block_checksum or not fault):
                rows, lens = self._upload(host, n)
                if self.block_checksum:
                    self._check_sums(rows, lens, sums)
                if fault is None:
                    sizes = host.numpy()[:4 * n].view(np.int32).astype(np.int64)
                    if self.engine.decompress_packed is None:
                        total += self._flush_listed(host, sizes, raw)
                    else:
                        pending = self._launch(rows, lens, sizes, raw)
            if fault is not None:
                raise fault
            if end:
                return total + (self._emit(*pending) if pending else 0)

    def _walk(self, arr: np.ndarray):
        """Read blocks into the rows; returns (blocks read, raw flags, the
        block checksums read, end mark reached, the walk's fault)."""
        lens = arr[:4 * self.b].view(np.int32)
        rows = arr[self.rows_at:].reshape(self.b, self.stride)
        raw, sums = [], []
        src, bs = self.src, self.bs
        premature = Lz4FrameError("Stream ended prematurely")
        n = 0
        while n < self.b:
            word = _read_full(src, 4)
            if len(word) < 4:
                return n, raw, sums, False, premature
            size_word = _U32.unpack(word)[0]
            size = size_word & ~INCOMPRESSIBLE_MASK
            if size == 0:
                return n, raw, sums, True, None
            if size > bs:
                return n, raw, sums, False, Lz4FrameError(
                    f"Block size {size} exceeded max: {bs}")
            if read_into(src, rows[n, :size]) < size:
                return n, raw, sums, False, premature
            if self.block_checksum:
                word = _read_full(src, 4)
                if len(word) < 4:
                    return n, raw, sums, False, premature
                sums.append(_U32.unpack(word)[0])
            lens[n] = size
            raw.append(bool(size_word & INCOMPRESSIBLE_MASK))
            n += 1
        return n, raw, sums, False, None

    def _upload(self, host: torch.Tensor, n: int):
        """The walked rows and their lengths on the device: one upload."""
        with part("upload"):
            buf = self.up.upload(host[:self.rows_at + n * self.stride],
                                 self.engine.device)
        return (buf[self.rows_at:].view(n, self.stride),
                buf[:4 * n].view(torch.int32))

    def _check_sums(self, rows, lens, sums) -> None:
        """One K3 launch over the payload rows against the checksums read."""
        with part("kernels"):
            got = xxh32_batch(rows, lens, 0)
        with part("check"):
            got = got.cpu().numpy()
        if np.flatnonzero(got != np.array(sums, np.uint32)).size:
            raise Lz4FrameError("Block checksum mismatch")

    def _launch(self, rows, lens, sizes, raw):
        """Queue the batch's decode; returns what :meth:`_emit` needs."""
        comp_at = [i for i, r in enumerate(raw) if not r]
        finish = idx = None
        if comp_at:
            with part("kernels"):
                if len(comp_at) == len(raw):
                    comp, comp_lens = rows, lens
                else:
                    idx = torch.tensor(comp_at, device=rows.device)
                    comp = rows.index_select(0, idx)
                    comp_lens = lens.index_select(0, idx)
            out, finish = self.engine.decompress_packed(comp, comp_lens,
                                                        self.bs)
            if idx is None:
                rows = out
            else:       # decoded rows over their compressed ones
                rows.index_copy_(0, idx, out)
        return rows, sizes, comp_at, finish

    def _emit(self, rows, sizes, comp_at, finish) -> int:
        """Check the decode, put the batch's output together on the card in
        frame order, hash it, write it; returns its length."""
        if finish is not None:
            sizes[comp_at] = finish()
        total = int(sizes.sum())
        with part("kernels"):
            flat = _join_rows(rows, sizes, self.bs, total)
        if self.content_hash is not None:
            with part("content_hash"):
                self.content_hash.update(flat)
        if total:
            with part("download"):
                data = staging(self.engine.device, DOWN).download(flat)
            with part("write"):
                self.dst.write(memoryview(data))
        return total

    def _flush_listed(self, host, sizes, raw) -> int:
        """Decode and write the batch through ``engine.decompress_batch``;
        returns its length."""
        rows = host.numpy()[self.rows_at:].reshape(self.b, self.stride)
        payloads = [rows[i, :k].tobytes() for i, k in enumerate(sizes)]
        comp = [p for p, r in zip(payloads, raw) if not r]
        decoded = iter(self.engine.decompress_batch(comp, self.bs)
                       if comp else [])
        data = b"".join(next(decoded) if not r else p
                        for r, p in zip(raw, payloads))
        if self.content_hash is not None:
            with part("content_hash"):
                self.content_hash.update(data)
        with part("write"):
            self.dst.write(data)
        return len(data)


class _LinkedFrameBody(_FrameBody):
    """The blocks of one linked-block frame, up to its end mark, decoded a
    batch at a time into ``dst`` (``kernels/linked_decode.py``).

    The walk of :class:`_FrameBody` reads up to ``batch_blocks`` payloads
    (at most 64 MiB of output) into the pinned rows, which go up in one
    upload; the block checksums are one K3 launch; the decode is one walk
    and one resolve against the window, the up to 64 KiB of output before
    the batch, kept on the card (at the frame's start the dictionary's
    tail, or nothing). Each batch reads back its codes once and downloads
    its output once, whatever its number of blocks.

    Errors come as the serial reader raises them
    (``formats/frame.py::Lz4FrameInputStream``): the blocks before the
    first one that fails, by its block checksum (checked before its
    decode) or its decode, are written, then its error is raised; a fault
    of the walk is raised after every block read before it is written.
    """

    def __init__(self, src, dst, engine, bs, batch_blocks, block_checksum,
                 content_hash, dictionary):
        super().__init__(src, dst, engine, bs, batch_blocks, block_checksum,
                         content_hash)
        win, w = cuda_instances.window_tensor(dictionary or b"",
                                              engine.device)
        self.window = win[0, :w]

    def run(self) -> int:
        total = 0
        while True:
            with part("read"):
                host = self.up.take(self.rows_at + self.b * self.stride)
                n, raw, sums, end, fault = self._walk(host.numpy())
            if n:
                total += self._decode(host, n, raw, sums)
            if fault is not None:
                raise fault
            if end:
                return total

    def _decode(self, host, n, raw, sums) -> int:
        """Decode, check and write one batch; returns its length."""
        dev = self.engine.device
        comp_lens = host.numpy()[:4 * n].view(np.int32)
        width = linked_decode.table_width(comp_lens, raw)
        rows, lens = self._upload(host, n)
        held = None
        with part("kernels"):
            if self.block_checksum:
                want = torch.from_numpy(
                    np.array(sums, np.uint32).view(np.int32)).to(dev)
                held = xxh32_batch(rows, lens, 0).view(torch.int32) == want
            batch = linked_decode.decode_linked_batch(
                rows, lens, torch.tensor(raw, dtype=torch.bool, device=dev),
                self.bs, self.window, width, held, (comp_lens, raw))
        stop, w = batch.n_ok, self.window.numel()
        k = int(batch.block_at[stop])
        if k:
            flat = batch.out[w:w + k]
            if self.content_hash is not None:
                with part("content_hash"):
                    self.content_hash.update(flat)
            with part("download"):
                data = staging(dev, DOWN).download(flat)
            with part("write"):
                self.dst.write(memoryview(data))
        if stop < n:
            if batch.held is not None and not batch.held[stop]:
                raise Lz4FrameError("Block checksum mismatch")
            if batch.codes[stop] == ERR_DEST_TOO_SMALL:
                raise Lz4Error("maxDestLen is too small")
            raise Lz4Error("Malformed input")
        keep = min(WINDOW, batch.n_nodes)
        self.window = batch.out[batch.n_nodes - keep:batch.n_nodes].clone()
        return k


def _join_rows(rows: torch.Tensor, sizes: np.ndarray, bs: int,
               total: int) -> torch.Tensor:
    """The first ``sizes[i]`` bytes of each row, one after the other, as
    one tensor on the rows' device: one copy for each run of full blocks
    and one for each shorter block, wherever it lies in the frame."""
    flat = torch.empty((total,), dtype=torch.uint8, device=rows.device)
    n, pos, i = len(sizes), 0, 0
    while i < n:
        j = i
        while j < n and sizes[j] == bs:
            j += 1
        if j > i:
            flat[pos:pos + (j - i) * bs].view(j - i, bs).copy_(rows[i:j, :bs])
            pos += (j - i) * bs
        if j < n:
            k = int(sizes[j])
            flat[pos:pos + k].copy_(rows[j, :k])
            pos += k
            j += 1
        i = j
    return flat
