"""The ``cuda`` tier: codec instances backed by the port's CUDA kernels.

Counterpart of ``lz4_tpu/api/pallas_instances.py``, with its class set, its
contracts and its error messages. The batch APIs (``compress_batch``,
``decompress_batch``, ``hash_batch``) are the tier's point; the scalar
methods run a batch of one on the device, as the JAX tier does.

Where each role runs:

- on the card: ``FastCompressor`` (K2), ``SafeDecompressor`` (K1),
  ``FastDecompressor`` (K1's fast entry point), ``XXH32`` (K3), ``XXH64``
  (K4) and the streaming hashes ``StreamingXXH32``/``StreamingXXH64``
  (their lane state on the card, updated by the stream entry points of K3
  and K4; ``kernels/xxhash_stream.py``). Each takes a ``device``,
  ``"cuda"`` by default; with ``"cpu"`` the kernels' plain versions run
  instead, which is what the CPU tests do. Every batch goes to the kernel,
  ragged or not: the kernels have no tile restriction, so there is no
  uniform-batch branch.
- on the host: ``HighCompressor``. Its JAX counterpart
  (``kernels/jax_hc.py``) is pure JAX, not a Pallas kernel; until it is
  ported to the card this class runs the port's own host code
  (``core/lz4_hc_ref.py``). Nothing switches between host and card at run
  time.
"""

from __future__ import annotations

import torch

from ..core import xxhash_ref
from ..core.constants import (
    DEFAULT_COMPRESSION_LEVEL, U32, U64, max_compressed_length)
from ..core.device import resolve_device
from ..core.errors import Lz4Error
from ..core.lz4_hc_ref import check_range, compress_hc, compress_hc_alloc
from ..kernels import codec, xxhash_stream
from ..kernels.layout import from_device_layout, row_stride, to_device_layout
from ..kernels.xxhash import split_u64, xxh32_batch, xxh64_batch
from .abstract import (
    Lz4Compressor, Lz4FastDecompressor, Lz4SafeDecompressor,
    StreamingXXHash32, StreamingXXHash64, XXHash32, XXHash64,
)


class _OnDevice:
    """A role that runs on ``device`` (the card unless told otherwise)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)

    def _batch(self, blocks: list[bytes]):
        return to_device_layout(blocks, device=self.device)

    def _hash_args(self, data, lengths):
        """``uint8[N, L]`` (numpy or torch) and lengths -> a batch on the
        device. Rows are copied into the port's layout only when the
        kernels could not take them as they are."""
        data = torch.as_tensor(data).to(self.device)
        lens = torch.as_tensor(lengths).to(self.device, torch.int32)
        if data.dtype != torch.uint8 or data.dim() != 2:
            raise ValueError("expected uint8[N, L] data")
        n, width = data.shape
        if width % 16 or not data.is_contiguous() or data.data_ptr() % 16:
            if lens.numel() and int(lens.max()) > width:
                raise ValueError(f"lengths must lie in [0, {width}]")
            buf = torch.zeros((n, row_stride(width)), dtype=torch.uint8,
                              device=self.device)
            buf[:, :width] = data
            data = buf
        return data, lens.contiguous()


class FastCompressor(_OnDevice, Lz4Compressor):
    def compress(self, src, src_off, src_len, dest, dest_off, max_dest_len):
        check_range(src, src_off, src_len)
        check_range(dest, dest_off, max_dest_len)
        blk, lens = self._batch([bytes(src[src_off:src_off + src_len])])
        out, out_lens, err = codec.compress_fast_batch(
            blk, lens, max_compressed_length(src_len))
        if int(err[0]) == codec.ERR_DEST_TOO_SMALL:
            raise Lz4Error("maxDestLen is too small")
        data = from_device_layout(out, out_lens)[0]
        if len(data) > max_dest_len:
            raise Lz4Error("maxDestLen is too small")
        dest[dest_off:dest_off + len(data)] = data
        return len(data)

    def compress_batch(self, blocks: list[bytes]) -> list[bytes]:
        """Compress many blocks in one K2 launch; byte-identical to every
        other tier."""
        if not blocks:
            return []
        src, lens = self._batch(blocks)
        out, out_lens, err = codec.compress_fast_batch(
            src, lens, max_compressed_length(max(len(b) for b in blocks)))
        if bool(err.any()):
            raise Lz4Error("device compression failed")
        return from_device_layout(out, out_lens)


class HighCompressor(Lz4Compressor):
    """HC on the host (``core/lz4_hc_ref.py``), byte-identical to every
    other tier. The JAX tier runs ``kernels/jax_hc.py`` on its device; the
    port has no HC kernel yet."""

    def __init__(self, level: int = DEFAULT_COMPRESSION_LEVEL):
        self.level = level

    def compress(self, src, src_off, src_len, dest, dest_off, max_dest_len):
        return compress_hc(src, src_off, src_len, dest, dest_off,
                           max_dest_len, self.level)

    def compress_batch(self, blocks: list[bytes]) -> list[bytes]:
        return [compress_hc_alloc(b, self.level) for b in blocks]

    def __repr__(self):
        return f"{type(self).__name__}(level={self.level})"


class SafeDecompressor(_OnDevice, Lz4SafeDecompressor):
    def decompress(self, src, src_off, src_len, dest, dest_off, max_dest_len):
        check_range(src, src_off, src_len)
        check_range(dest, dest_off, max_dest_len)
        comp, lens = self._batch([bytes(src[src_off:src_off + src_len])])
        out, out_lens, err = codec.decompress_safe_batch(
            comp, lens, max(1, max_dest_len))
        code = int(err[0])
        if code == codec.ERR_DEST_TOO_SMALL:
            raise Lz4Error("Output buffer too small")
        if code != codec.OK:
            raise Lz4Error("Malformed input")
        data = from_device_layout(out, out_lens)[0]
        dest[dest_off:dest_off + len(data)] = data
        return len(data)

    def decompress_batch(self, blocks: list[bytes],
                         max_dest_len: int) -> list[bytes]:
        """Decompress many blocks in one K1 launch; raises on the first
        block that does not decode."""
        if not blocks:
            return []
        comp, lens = self._batch(blocks)
        out, out_lens, err = codec.decompress_safe_batch(comp, lens,
                                                         max_dest_len)
        _raise_on_bad_block(err)
        return from_device_layout(out, out_lens)


def _raise_on_bad_block(err: torch.Tensor) -> None:
    bad = torch.nonzero(err).flatten()
    if bad.numel():
        raise Lz4Error(f"Malformed input in block {int(bad[0])}")


class FastDecompressor(_OnDevice, Lz4FastDecompressor):
    """The exact-decompressed-size contract on K1's fast entry point, which
    reports the number of source bytes consumed per block."""

    def decompress(self, src, src_off, dest, dest_off, dest_len):
        if src_off < 0 or src_off >= len(src):
            raise IndexError(f"src_off {src_off} out of bounds")
        check_range(dest, dest_off, dest_len)
        comp, avail = self._batch([bytes(src[src_off:])])
        out, src_read, err = codec.decompress_fast_batch(comp, avail, dest_len)
        if int(err[0]) != codec.OK:
            raise Lz4Error("Malformed input")
        dest[dest_off:dest_off + dest_len] = \
            out[0, :dest_len].cpu().numpy().tobytes()
        return int(src_read[0])

    def decompress_batch(self, blocks: list[bytes], dest_len: int):
        """Decode many blocks of exactly ``dest_len`` bytes each in one
        launch; returns (decoded blocks, bytes read from each). This batch
        form is the port's own: the JAX tier has only the scalar method."""
        if not blocks:
            return [], []
        comp, avail = self._batch(blocks)
        out, src_read, err = codec.decompress_fast_batch(comp, avail, dest_len)
        _raise_on_bad_block(err)
        rows = out[:, :dest_len].cpu().numpy()
        return [r.tobytes() for r in rows], src_read.cpu().tolist()


class XXH32(_OnDevice, XXHash32):
    def hash(self, buf, off, length, seed):
        check_range(buf, off, length)
        data, lens = self._batch([bytes(buf[off:off + length])])
        return xxhash_ref.as_s32(int(xxh32_batch(data, lens, seed & U32)[0]))

    def hash_batch(self, data, lengths, seed=0) -> torch.Tensor:
        """uint8[N, L], int32[N] -> uint32[N] on the device, through K3."""
        return xxh32_batch(*self._hash_args(data, lengths), int(seed) & U32)


class XXH64(_OnDevice, XXHash64):
    def hash(self, buf, off, length, seed):
        check_range(buf, off, length)
        data, lens = self._batch([bytes(buf[off:off + length])])
        return int(xxh64_batch(data, lens, seed & U64)[0])  # a signed int64

    def hash_batch(self, data, lengths, seed=0):
        """uint8[N, L], int32[N] -> (hi, lo) uint32[N] pair on the device,
        through K4: the JAX tier's contract; combine on the host with
        ``(int(hi) << 32) | int(lo)``."""
        return split_u64(xxh64_batch(*self._hash_args(data, lengths),
                                     int(seed) & U64))


def _stream_range(buf, off: int, length: int | None) -> memoryview:
    """``buf[off:off + length]`` as bytes, checked as
    ``core/xxhash_ref.py``'s streaming classes check it."""
    if length is None:
        length = len(buf) - off
    if off < 0 or length < 0 or off + length > len(buf):
        raise IndexError("range out of bounds")
    return memoryview(buf).cast("B")[off:off + length]


class StreamingXXH32(StreamingXXHash32):
    """Streaming XXH32 with its lane state on ``device``
    (``kernels/xxhash_stream.py``): an update that completes a stripe is one
    upload and one launch of K3's stream entry point. The JAX tier keeps
    the same state on its device (``kernels/xxhash_stream.py``)."""

    def __init__(self, seed: int, device: str | torch.device = "cuda"):
        super().__init__(seed)
        self._state = xxhash_stream.StreamState32(seed, device)

    def update(self, buf, off: int = 0, length: int | None = None):
        self._state.update(_stream_range(buf, off, length))

    def get_value(self) -> int:
        return xxhash_ref.as_s32(self._state.digest())

    def reset(self) -> None:
        self._state.reset()


class StreamingXXH64(StreamingXXHash64):
    """Streaming XXH64 with its lane state on ``device``
    (``kernels/xxhash_stream.py``): an update that completes a stripe is one
    upload and one launch of K4's stream entry point."""

    def __init__(self, seed: int, device: str | torch.device = "cuda"):
        super().__init__(seed)
        self._state = xxhash_stream.StreamState64(seed, device)

    def update(self, buf, off: int = 0, length: int | None = None):
        self._state.update(_stream_range(buf, off, length))

    def get_value(self) -> int:
        return xxhash_ref.as_s64(self._state.digest())

    def reset(self) -> None:
        self._state.reset()
