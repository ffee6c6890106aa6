"""The ``cuda`` tier: codec instances backed by the port's CUDA kernels.

Counterpart of ``lz4_tpu/api/pallas_instances.py``, with its class set, its
contracts and its error messages. The batch APIs (``compress_batch``,
``decompress_batch``, ``hash_batch``) are the tier's point; the scalar
methods run a batch of one on the device, as the JAX tier does.

Where each role runs:

- on the card: ``FastCompressor`` (K2), ``HighCompressor`` (K6, LZ4 HC
  at its level), ``SafeDecompressor`` (K1), ``FastDecompressor`` (K1's
  fast entry point), ``XXH32`` (K3), ``XXH64`` (K4) and the streaming
  hashes ``StreamingXXH32``/``StreamingXXH64``
  (their lane state on the card, updated by the stream entry points of K3
  and K4; ``kernels/xxhash_stream.py``). Each takes a ``device``,
  ``"cuda"`` by default; with ``"cpu"`` the kernels' plain versions run
  instead, which is what the CPU tests do. Every batch goes to the kernel,
  ragged or not: the kernels have no tile restriction, so there is no
  uniform-batch branch.
- the packed entry points :func:`compress_fast_packed` and
  :func:`decompress_safe_packed` (the contracts of
  ``lz4_tpu/api/native_instances.py:167,247``: one contiguous buffer each
  way), over :func:`compress_rows` (K2, or K6 at an HC level) and
  :func:`decode_rows`, which keep the batch on the card and are what the
  stream pipeline's engines run.

- the window codecs :func:`compress_blocks_with_dict` and
  :func:`decompress_blocks_with_history` (K2 and K1 with a window before
  each row, one shared dictionary or history a batch), the counterparts of
  ``native_instances.compress_block_with_dict`` and
  ``decompress_block_with_history`` (``:613-654``), which the frame
  formats run for dictionary and linked-block frames; and
  :func:`decode_rows_hist`, the packed decode of a batch against one
  shared history.

The host HC (``core/lz4_hc_ref.py``) is only K6's plain version: on the
card nothing switches to it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import xxhash_ref
from ..core.constants import (
    DEFAULT_COMPRESSION_LEVEL, U32, U64, max_compressed_length)
from ..core.device import resolve_device
from ..core.errors import Lz4Error
from ..core.lz4_hc_ref import check_range
from ..kernels import codec, hc, xxhash_stream
from ..kernels.layout import (
    DOWN, UP, from_device_layout, row_stride, staging, to_device_layout,
    upload_bytes)
from ..kernels.xxhash import split_u64, xxh32_batch, xxh64_batch
from ..utils.buffers import read_into
from ..utils.profiling import part
from .abstract import (
    Lz4Compressor, Lz4FastDecompressor, Lz4SafeDecompressor,
    StreamingXXHash32, StreamingXXHash64, XXHash32, XXHash64,
)


class _OnDevice:
    """A role that runs on ``device`` (the card unless told otherwise)."""

    def __init__(self, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)

    def _batch(self, blocks: list[bytes]):
        with part("upload"):
            return to_device_layout(blocks, device=self.device)

    def _hash_args(self, data, lengths):
        """``uint8[N, L]`` (numpy or torch) and lengths -> a batch on the
        device. Rows on the device are copied into the port's layout only
        when the kernels could not take them as they are; rows on the host
        go through the staging buffer, one upload for the rows and the
        lengths."""
        if isinstance(data, torch.Tensor) and data.device.type == "cuda":
            return self._device_hash_args(data, lengths)
        arr = np.asarray(data)
        lens = np.asarray(lengths, np.int32)
        if arr.dtype != np.uint8 or arr.ndim != 2:
            raise ValueError("expected uint8[N, L] data")
        n, width = arr.shape
        if lens.shape != (n,):
            raise ValueError("expected int32[N] lengths")
        if n and (lens.max() > width or lens.min() < 0):
            raise ValueError(f"lengths must lie in [0, {width}]")
        stride = width if width and width % 16 == 0 else row_stride(width)
        st = staging(self.device, UP)
        with part("upload"):
            host = st.take(n * stride + 4 * n)
            buf = host.numpy()
            buf[:n * stride].reshape(n, stride)[:, :width] = arr
            buf[n * stride:].view(np.int32)[:] = lens
            out = st.upload(host, self.device)
        return (out[:n * stride].view(n, stride),
                out[n * stride:].view(torch.int32))

    def _device_hash_args(self, data, lengths):
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


def _read_back(*ts: torch.Tensor) -> np.ndarray:
    """int32[N] tensors of one batch on the host, as rows of one array:
    one read-back, which waits for the card."""
    with part("check"):
        return torch.stack(ts).cpu().numpy()


def _raise_on_bad_block(err: np.ndarray) -> None:
    bad = np.flatnonzero(err)
    if bad.size:
        raise Lz4Error(f"Malformed input in block {int(bad[0])}")


def compress_rows(data: torch.Tensor, block_size: int, level: int = 0):
    """Compress ``data`` (a contiguous ``uint8[L]`` tensor) cut into blocks
    of ``block_size`` bytes, the last possibly short, in one launch on its
    device, K2 at ``level`` 0 and K6 (HC) at ``level`` 1..17: the packed
    compress of the stream pipeline's engines. It does not read the codes
    back, so that the caller can queue more work before
    :func:`check_compressed` does.

    Returns ``(src uint8[N, row_stride(block_size)], lens int32[N], comp
    uint8[N, row_stride(cap)], comp_lens int32[N], err int32[N])`` on that
    device, ``cap = max_compressed_length(block_size)``; ``src`` holds the
    blocks (the frame stores a block raw when compressing does not shrink
    it).
    """
    if data.dtype != torch.uint8 or data.dim() != 1 or not data.is_contiguous():
        raise ValueError("expected a contiguous uint8[L] tensor")
    if block_size < 1:
        raise ValueError("block_size must be >= 1")
    total = data.numel()
    n = -(-total // block_size)
    full = total // block_size
    dev = data.device
    with part("kernels"):
        src = torch.empty((n, row_stride(block_size)), dtype=torch.uint8,
                          device=dev)
        src[:full, :block_size] = data[:full * block_size].view(
            full, block_size)
        lens = torch.full((n,), block_size, dtype=torch.int32, device=dev)
        if n > full:
            src[full, :total - full * block_size] = data[full * block_size:]
            lens[full] = total - full * block_size
        cap = max_compressed_length(block_size)
        if level > 0:
            return (src, lens) + hc.compress_hc_batch(src, lens, cap, level)
        return (src, lens) + codec.compress_fast_batch(src, lens, cap)


def check_compressed(err: torch.Tensor) -> None:
    """Raise ``Lz4Error`` if a block of :func:`compress_rows` failed, which
    its cap rules out; reads the codes back."""
    with part("check"):
        if err.numel() and bool(err.any()):
            raise Lz4Error("device compression failed")


def decode_rows(comp: torch.Tensor, comp_lens: torch.Tensor, out_max: int):
    """Decode a batch in the port's layout in one K1 launch on its device:
    the packed decode of the ``cuda`` engine. It does not read the codes
    back: the caller may queue more work before it calls ``finish``.

    Returns ``(out uint8[N, row_stride(out_max)] on the device, finish)``;
    ``finish()`` reads the lengths and codes back and returns the lengths
    (``int32[N]`` numpy), or raises ``Lz4Error`` naming the first block
    that does not decode in ``out_max`` bytes.
    """
    with part("kernels"):
        out, out_lens, err = codec.decompress_safe_batch(comp, comp_lens,
                                                         out_max)

    def finish() -> np.ndarray:
        codes, lens = _read_back(err, out_lens)
        _raise_on_bad_block(codes)
        return lens

    return out, finish


def window_tensor(window, device: torch.device):
    """The last ``codec.WINDOW`` bytes of ``window`` (bytes-like) as a
    ``uint8[1, W]`` tensor on ``device`` (W at least 1), and their length:
    one shared row for the window kernels."""
    tail = memoryview(window).cast("B")[-codec.WINDOW:] if len(window) else b""
    t = upload_bytes(bytes(tail) or b"\0", device)[:max(1, len(tail))]
    return t.view(1, -1), len(tail)


def decode_rows_hist(comp: torch.Tensor, comp_lens: torch.Tensor,
                     out_max: int, hist: torch.Tensor, hist_len: int):
    """:func:`decode_rows` with the history ``hist`` (``uint8[1, W]``, its
    last ``hist_len`` bytes) before every row: one K1 launch with a
    history, the packed decode of dictionary frames."""
    lens = torch.full((comp.shape[0],), hist_len, dtype=torch.int32,
                      device=comp.device)
    with part("kernels"):
        out, out_lens, err = codec.decompress_safe_hist_batch(
            comp, comp_lens, out_max, hist, lens)

    def finish() -> np.ndarray:
        codes, lens = _read_back(err, out_lens)
        _raise_on_bad_block(codes)
        return lens

    return out, finish


def compress_blocks_with_dict(blocks, dictionary,
                              device: str | torch.device = "cuda"):
    """Compress many blocks against one dictionary (its last 64 KiB) in one
    upload and one launch of K2 with a dictionary: byte for byte what
    ``native_instances.compress_block_with_dict`` gives for each block.
    Returns a list of ``bytes``."""
    dev = resolve_device(device)
    if not len(blocks):
        return []
    src, lens = to_device_layout(blocks, device=dev)
    win, wlen = window_tensor(dictionary, dev)
    with part("kernels"):
        out, out_lens, err = codec.compress_dict_batch(
            src, lens, max_compressed_length(max(len(b) for b in blocks)), win,
            torch.full((len(blocks),), wlen, dtype=torch.int32, device=dev))
    err, out_lens = _read_back(err, out_lens)
    if err.any():
        raise Lz4Error("device compression failed")
    with part("download"):
        return from_device_layout(out, out_lens)


def decompress_blocks_with_history(blocks, out_max: int, history,
                                   device: str | torch.device = "cuda"):
    """Decode many blocks against one history (its last 64 KiB) in one
    upload and one launch of K1 with a history: what
    ``native_instances.decompress_block_with_history`` gives for each
    block. Raises ``Lz4Error`` on the first block that does not decode in
    ``out_max`` bytes. Returns a list of ``bytes``."""
    dev = resolve_device(device)
    if not len(blocks):
        return []
    comp, lens = to_device_layout(blocks, device=dev)
    out, finish = decode_rows_hist(comp, lens, out_max,
                                   *window_tensor(history, dev))
    out_lens = finish()
    with part("download"):
        return from_device_layout(out, out_lens)


def compress_fast_packed(src, block_size: int,
                         device: str | torch.device = "cuda"):
    """Compress the contiguous bytes ``src``, split into blocks of
    ``block_size`` (the last may be short), in one upload and one K2
    launch: the contract of ``native_instances.compress_fast_packed``.

    Returns ``(comp bytearray, offsets int64[N], lens int32[N])`` with
    block i's output at ``comp[offsets[i]:offsets[i] + lens[i]]``; here
    the blocks lie at a stride of the longest output.
    """
    dev = resolve_device(device)
    if not len(src):
        return bytearray(), np.zeros(0, np.int64), np.zeros(0, np.int32)
    data = upload_bytes(src, dev)
    _, _, comp, comp_lens, err = compress_rows(data, block_size)
    err, lens = _read_back(err, comp_lens)
    if err.any():
        raise Lz4Error("device compression failed")
    width = int(lens.max())
    with part("download"):
        arr = staging(dev, DOWN).download(comp[:, :width])
        out = bytearray(memoryview(arr).cast("B"))
    return out, np.arange(len(lens), dtype=np.int64) * width, lens


def decompress_safe_packed(comp, offsets, lens, out_max: int,
                           device: str | torch.device = "cuda"):
    """Decode the blocks ``comp[offsets[i]:offsets[i] + lens[i]]`` of the
    contiguous bytes ``comp`` in one upload and one K1 launch: the
    contract of ``native_instances.decompress_safe_packed``.

    Returns ``(dest bytearray, out_lens int32[N])`` with block i decoded
    at ``dest[i * out_max:]`` and zeros after its bytes; raises the
    ``Lz4Error`` of :meth:`SafeDecompressor.decompress_batch` on the first
    block that does not decode.
    """
    dev = resolve_device(device)
    n = len(lens)
    if not n:
        return bytearray(), np.zeros(0, np.int32)
    mv = memoryview(comp).cast("B")
    offsets = np.asarray(offsets, np.int64).tolist()
    blocks = [mv[o:o + k] for o, k in zip(offsets, np.asarray(lens).tolist())]
    with part("upload"):
        rows, rlens = to_device_layout(blocks, device=dev)
    out, finish = decode_rows(rows, rlens, out_max)
    out_lens = finish()
    with part("download"):
        arr = staging(dev, DOWN).download(out[:, :out_max])
        dest = bytearray(memoryview(arr).cast("B"))
    return dest, out_lens


class _BlockCompressor(_OnDevice, Lz4Compressor):
    """A compressor whose batch is one launch of ``_kernel(src, lens,
    dest_cap)``; ``_failed`` is the message of a batch with a failed
    block."""

    _failed = "device compression failed"

    def _kernel(self, src, lens, dest_cap):
        raise NotImplementedError

    def compress(self, src, src_off, src_len, dest, dest_off, max_dest_len):
        """The batch of one, compressed in full, then held to
        ``max_dest_len`` (``pallas_instances.py:82-97,136-151``)."""
        check_range(src, src_off, src_len)
        check_range(dest, dest_off, max_dest_len)
        blk, lens = self._batch([bytes(src[src_off:src_off + src_len])])
        out, out_lens, err = self._kernel(blk, lens,
                                          max_compressed_length(src_len))
        if int(err[0]) == codec.ERR_DEST_TOO_SMALL:
            raise Lz4Error("maxDestLen is too small")
        data = from_device_layout(out, out_lens)[0]
        if len(data) > max_dest_len:
            raise Lz4Error("maxDestLen is too small")
        dest[dest_off:dest_off + len(data)] = data
        return len(data)

    def compress_batch(self, blocks: list[bytes]) -> list[bytes]:
        """Compress many blocks in one launch; byte-identical to every
        other tier."""
        if not blocks:
            return []
        src, lens = self._batch(blocks)
        with part("kernels"):
            out, out_lens, err = self._kernel(
                src, lens, max_compressed_length(max(len(b) for b in blocks)))
        err, out_lens = _read_back(err, out_lens)
        if err.any():
            raise Lz4Error(self._failed)
        with part("download"):
            return from_device_layout(out, out_lens)


class FastCompressor(_BlockCompressor):
    """The fast scan on K2."""

    def _kernel(self, src, lens, dest_cap):
        return codec.compress_fast_batch(src, lens, dest_cap)


class HighCompressor(_BlockCompressor):
    """HC at ``level`` on K6 (``kernels/hc.py``), byte-identical to every
    other tier; the counterpart of the ``pallas`` tier's device HC
    (``kernels/jax_hc.py``)."""

    _failed = "device HC compression failed"

    def __init__(self, level: int = DEFAULT_COMPRESSION_LEVEL,
                 device: str | torch.device = "cuda"):
        super().__init__(device)
        self.level = level

    def _kernel(self, src, lens, dest_cap):
        return hc.compress_hc_batch(src, lens, dest_cap, self.level)

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
        out, finish = decode_rows(*self._batch(blocks), max_dest_len)
        out_lens = finish()
        with part("download"):
            return from_device_layout(out, out_lens)


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
        with part("kernels"):
            out, src_read, err = codec.decompress_fast_batch(comp, avail,
                                                             dest_len)
        err, src_read = _read_back(err, src_read)
        _raise_on_bad_block(err)
        with part("download"):
            return (from_device_layout(out, [dest_len] * len(blocks)),
                    src_read.tolist())


class XXH32(_OnDevice, XXHash32):
    def hash(self, buf, off, length, seed):
        check_range(buf, off, length)
        data, lens = self._batch([bytes(buf[off:off + length])])
        return xxhash_ref.as_s32(int(xxh32_batch(data, lens, seed & U32)[0]))

    def hash_batch(self, data, lengths, seed=0) -> torch.Tensor:
        """uint8[N, L], int32[N] -> uint32[N] on the device, through K3."""
        args = self._hash_args(data, lengths)
        with part("kernels"):
            return xxh32_batch(*args, int(seed) & U32)


class XXH64(_OnDevice, XXHash64):
    def hash(self, buf, off, length, seed):
        check_range(buf, off, length)
        data, lens = self._batch([bytes(buf[off:off + length])])
        return int(xxh64_batch(data, lens, seed & U64)[0])  # a signed int64

    def hash_batch(self, data, lengths, seed=0):
        """uint8[N, L], int32[N] -> (hi, lo) uint32[N] pair on the device,
        through K4: the JAX tier's contract; combine on the host with
        ``(int(hi) << 32) | int(lo)``."""
        args = self._hash_args(data, lengths)
        with part("kernels"):
            return split_u64(xxh64_batch(*args, int(seed) & U64))


def _stream_range(buf, off: int, length: int | None) -> memoryview:
    """``buf[off:off + length]`` as bytes, checked as the ``pallas`` tier's
    streaming classes check it: ``ValueError`` for a negative length,
    ``IndexError`` for a non-empty range out of bounds, and an empty range
    at any offset."""
    if length is None:
        length = len(buf) - off
    check_range(buf, off, length)
    return memoryview(buf).cast("B")[off:off + length] if length else \
        memoryview(b"")


def _update_from(state, src, max_bytes: int) -> int:
    """Read up to ``max_bytes`` of the binary stream ``src`` straight into
    the state's staging buffer (``readinto`` where ``src`` has it) and
    absorb them; returns the bytes read, 0 at the end of ``src``."""
    n = read_into(src, state.staged(max_bytes))
    state.update_staged(n)
    return n


class StreamingXXH32(StreamingXXHash32):
    """Streaming XXH32 with its lane state on ``device``
    (``kernels/xxhash_stream.py``): an update that completes a stripe is one
    upload through the pinned staging buffer and one launch of K3's stream
    entry point, on the state's own CUDA stream. The JAX tier keeps the
    same state on its device (``kernels/xxhash_stream.py``)."""

    def __init__(self, seed: int, device: str | torch.device = "cuda"):
        super().__init__(seed)
        self._state = xxhash_stream.StreamState32(seed, device)

    def update(self, buf, off: int = 0, length: int | None = None):
        self._state.update(_stream_range(buf, off, length))

    def update_from(self, src, max_bytes: int = 1 << 20) -> int:
        """The port's own: :func:`_update_from`."""
        return _update_from(self._state, src, max_bytes)

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

    def update_from(self, src, max_bytes: int = 1 << 20) -> int:
        """The port's own: :func:`_update_from`."""
        return _update_from(self._state, src, max_bytes)

    def get_value(self) -> int:
        return xxhash_ref.as_s64(self._state.digest())

    def reset(self) -> None:
        self._state.reset()
