"""Stream pipeline: binary streams cut into frame blocks, compressed and
decoded in batches on the card, written as standard LZ4 frames in order.

Counterpart of ``lz4_tpu/streams/pipeline.py`` with its names
(``BatchEngine``, ``get_engine``, ``compress_stream``,
``decompress_stream``). Blocks are independent (``BLOCK_INDEPENDENCE``), so
a batch of them is one kernel launch each way, and the frame bytes equal
those of the one-block-at-a-time writer.

Engines, each on one device (the card unless told otherwise):

- ``cuda``: the ``cuda`` tier's ``fast_compressor().compress_batch`` (K2)
  and ``safe_decompressor().decompress_batch`` (K1); the counterpart of
  the JAX ``pallas`` engine;
- ``segment``: compresses as ``cuda`` does (the JAX engine compresses with
  its native tier, byte-identical), and decodes with the sequence parser
  and K5 (``kernels/segment_decode.decompress_blocks``);
- ``fastest``: ``cuda``.

``level`` 1..17 compresses with the tier's ``high_compressor(level)``. The
content checksum is a streaming XXH32 with its state on the engine's
device, one update a batch. Frames with linked blocks or a dictionary need
the serial frame reader, which the port does not have yet: they are
refused. The JAX engines ``native``, ``sharded``, ``safe`` and
``parallel`` are not ported.
"""

from __future__ import annotations

import functools
import struct

import torch

from ..api.factory import Lz4Factory, XXHashFactory
from ..core.constants import U32
from ..core.device import resolve_device
from ..core.errors import Lz4FrameError
from ..formats.frame import (
    BlockSize, FrameFlag, INCOMPRESSIBLE_MASK, MAGIC, MAGIC_SKIPPABLE_BASE,
    _bd_from_byte, _flg_from_byte, _flg_to_byte, xxh32_bytes,
)
from ..kernels import segment_decode

ENGINES = ("fastest", "cuda", "segment")

_U32 = struct.Struct("<I")
_U64 = struct.Struct("<Q")


class BatchEngine:
    """Batched block codecs on one device: ``compress_batch(list[bytes])
    -> list[bytes]`` and ``decompress_batch(list[bytes], out_max) ->
    list[bytes]``."""

    def __init__(self, name: str, compress_batch, decompress_batch,
                 device: torch.device):
        self.name = name
        self.compress_batch = compress_batch
        self.decompress_batch = decompress_batch
        self.device = device

    def __repr__(self):
        return f"BatchEngine({self.name}, {self.device})"


def get_engine(name: str = "fastest", level: int = 0,
               device: str | torch.device = "cuda") -> BatchEngine:
    """The engine ``name`` (one of :data:`ENGINES`) on ``device``; raises
    when ``device`` names a card and there is none.

    ``level`` 1..17 compresses with HC at that level; 0 (or below) with
    the fast scan, as the JAX engines other than ``native`` do.
    """
    if name not in ENGINES:
        raise ValueError(
            f"unknown engine {name!r}: the port has {', '.join(ENGINES)} "
            "(the JAX engines native, sharded, safe and parallel are not "
            "ported)")
    dev = resolve_device(device)
    name = "cuda" if name == "fastest" else name
    lz4 = Lz4Factory.cuda_instance(dev)
    comp = (lz4.high_compressor(level) if level > 0
            else lz4.fast_compressor()).compress_batch
    if name == "cuda":
        decomp = lz4.safe_decompressor().decompress_batch
    else:
        decomp = functools.partial(segment_decode.decompress_blocks,
                                   device=dev)
    suffix = f"-hc{level}" if level > 0 else ""
    return BatchEngine(name + suffix, comp, decomp, dev)


def _read_full(src, n: int) -> bytes:
    """Up to ``n`` bytes; fewer only at the end of ``src``."""
    data = src.read(n)
    while data and len(data) < n:
        more = src.read(n - len(data))
        if not more:
            break
        data += more
    return data or b""


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
        hc = Lz4Factory.cuda_instance(engine.device).high_compressor(level)
        engine = BatchEngine(f"{engine.name}-hc{level}", hc.compress_batch,
                             engine.decompress_batch, engine.device)
    bs = block_size.num_bytes
    flags = {FrameFlag.BLOCK_INDEPENDENCE}
    if content_checksum:
        flags.add(FrameFlag.CONTENT_CHECKSUM)
    desc = bytes([_flg_to_byte(frozenset(flags)), (block_size.value & 7) << 4])
    header = _U32.pack(MAGIC) + desc + bytes([(xxh32_bytes(desc) >> 8) & 0xFF])
    content_hash = (XXHashFactory.cuda_instance(engine.device)
                    .new_streaming_hash32(0) if content_checksum else None)

    dst.write(header)
    written = len(header)
    while True:
        chunk = _read_full(src, bs * batch_blocks)
        if not chunk:
            break
        if content_hash is not None:
            content_hash.update(chunk)
        view = memoryview(chunk)
        blocks = [view[i:i + bs] for i in range(0, len(chunk), bs)]
        for raw, comp in zip(blocks, engine.compress_batch(blocks)):
            if len(comp) >= len(raw):
                parts = (_U32.pack(len(raw) | INCOMPRESSIBLE_MASK), raw)
            else:
                parts = (_U32.pack(len(comp)), comp)
            for p in parts:
                dst.write(p)
                written += len(p)
        if len(chunk) < bs * batch_blocks:
            break
    tail = _U32.pack(0)
    if content_hash is not None:
        tail += _U32.pack(content_hash.get_value() & U32)
    dst.write(tail)
    return written + len(tail)


def decompress_stream(src, dst, engine: BatchEngine | str = "fastest",
                      batch_blocks: int = 256,
                      device: str | torch.device = "cuda") -> int:
    """Decode LZ4 frames (concatenated, with skippable frames between them)
    from ``src`` into ``dst``; compressed blocks are decoded in batches of
    ``batch_blocks``. ``device`` places an engine given by name. Returns
    the decompressed bytes written."""
    if isinstance(engine, str):
        engine = get_engine(engine, device=device)
    xxh = XXHashFactory.cuda_instance(engine.device)
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
        flags = _flg_from_byte(desc[0])
        bs = _bd_from_byte(desc[1]).num_bytes
        expected_size = -1
        if FrameFlag.CONTENT_SIZE in flags:
            raw8 = read_exact(8)
            desc += raw8
            expected_size = _U64.unpack(raw8)[0]
        if ((xxh32_bytes(desc) >> 8) & 0xFF) != read_exact(1)[0]:
            raise Lz4FrameError("Frame header checksum mismatch")
        content_hash = (xxh.new_streaming_hash32(0)
                        if FrameFlag.CONTENT_CHECKSUM in flags else None)
        total = 0
        pending: list[tuple[bool, bytes]] = []

        def flush():
            nonlocal written, total
            decoded = iter(engine.decompress_batch(
                [p for is_comp, p in pending if is_comp], bs))
            raw = b"".join(next(decoded) if is_comp else p
                           for is_comp, p in pending)
            pending.clear()
            if content_hash is not None:
                content_hash.update(raw)
            dst.write(raw)
            written += len(raw)
            total += len(raw)

        while True:
            size_word = _U32.unpack(read_exact(4))[0]
            size = size_word & ~INCOMPRESSIBLE_MASK
            if size == 0:
                flush()
                if content_hash is not None:
                    expect = _U32.unpack(read_exact(4))[0]
                    if expect != content_hash.get_value() & U32:
                        raise Lz4FrameError("Content checksum mismatch")
                if 0 <= expected_size != total:
                    raise Lz4FrameError("Size check mismatch")
                break
            if size > bs:
                raise Lz4FrameError(f"Block size {size} exceeded max: {bs}")
            payload = read_exact(size)
            if FrameFlag.BLOCK_CHECKSUM in flags:
                expect = _U32.unpack(read_exact(4))[0]
                if expect != xxh.hash32().hash(payload, 0, size, 0) & U32:
                    raise Lz4FrameError("Block checksum mismatch")
            pending.append((not size_word & INCOMPRESSIBLE_MASK, payload))
            if len(pending) >= batch_blocks:
                flush()
    return written
