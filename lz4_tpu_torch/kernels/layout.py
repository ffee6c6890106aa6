"""Batches of byte blocks as tensors: ``uint8[N, stride]`` + ``int32[N]``.

The JAX package carried one byte per int32 element because TPU vector
memory has no sub-word addressing (``lz4_tpu/kernels/jax_codec.py:12-15``).
The port keeps bytes as bytes. A row holds ``cap`` bytes rounded up to 16,
then ``PAD`` bytes of slack; the stride is a multiple of 16 so that every
row starts 16-byte aligned for the kernels' vector loads.

Copies between the host and a card go through pinned memory
(:class:`Staging`): one grow-only buffer a thread, card and direction, so
that a call allocates no pinned memory once the buffer is large enough.
:func:`to_device_layout` copies each block once, into the buffer's rows,
and uploads them in one copy; :func:`from_device_layout` downloads only
the columns up to the longest block. On the card the bytes past a block's
length are left as they are (no kernel reads them, see
``tests/test_torch_utils.py``), except the first byte of an empty row,
which is 0: K1's fast entry point reads it, as ``jax_codec`` does. On the
CPU the rows are a new zeroed tensor.

:func:`check_layout` validates a batch's structure and reads nothing back;
:func:`check_batch` adds the lengths' range, read back from the card. K1's
three wrappers (``codec.decompress_*``) call :func:`check_layout` alone:
K1 checks each row's length on the card, so that a launch of the decode
need not wait for the batch in flight. Every other kernel wrapper calls
:func:`check_batch`.

``from_jax_layout`` / ``to_jax_layout`` carry a batch across between the two
packages: this system has no weights, so the state that crosses is the
batch itself.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..core.device import resolve_device
from ..utils.profiling import readback

PAD = 16


def row_stride(cap: int) -> int:
    """Row stride of a batch whose blocks hold up to ``cap`` bytes."""
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    return ((cap + 15) & ~15) + PAD


def check_layout(data: torch.Tensor, lens: torch.Tensor) -> None:
    """Validate the structure of a ``(uint8[N, S], int32[N])`` batch:
    dtypes, ranks, contiguity, shapes and device. It reads nothing from
    the card, so a launch after it is queued behind the work in flight."""
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("expected a contiguous uint8[N, S] tensor")
    if (lens.dtype != torch.int32 or lens.dim() != 1
            or lens.shape[0] != data.shape[0] or not lens.is_contiguous()):
        raise ValueError("expected contiguous int32[N] lengths")
    if lens.device != data.device:
        raise ValueError("data and lengths must be on one device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


def check_rows(data: torch.Tensor, lens: torch.Tensor) -> None:
    """Shapes, types and devices of a ``(uint8[N, W], int32[N])`` batch
    whose rows may be a view into wider ones (contiguous within a row),
    without reading the lengths: the packers' inputs."""
    if data.dtype != torch.uint8 or data.dim() != 2 or data.stride(1) != 1:
        raise ValueError("expected a uint8[N, W] tensor with contiguous rows")
    if (lens.dtype != torch.int32 or lens.dim() != 1
            or lens.shape[0] != data.shape[0] or not lens.is_contiguous()):
        raise ValueError("expected contiguous int32[N] lengths")
    if lens.device != data.device:
        raise ValueError("data and lengths must be on one device")


def check_batch(data: torch.Tensor, lens: torch.Tensor) -> int:
    """:func:`check_layout`, and lengths within ``[0, S]``, which the
    kernels behind it trust; returns the longest (0 for no rows). This
    reads the lengths back, so it waits for the card."""
    check_layout(data, lens)
    if not lens.numel():
        return 0
    with readback("check_batch", lens):
        lo, hi = (int(x) for x in torch.aminmax(lens))
    if lo < 0 or hi > data.shape[1]:
        raise ValueError(f"lengths must lie in [0, {data.shape[1]}]")
    return hi


def cuda_stream(t: torch.Tensor | torch.device) -> int:
    """Handle of the current CUDA stream of the card ``t`` lies on (or
    names). Anything but a card of this machine (an index below
    ``torch.cuda.device_count()``) is refused; the kernels launch on the
    card a wrapper names (``build.Kernel``)."""
    dev = t if isinstance(t, torch.device) else t.device
    count = torch.cuda.device_count()
    if dev.type != "cuda" or not 0 <= (dev.index or 0) < count:
        raise ValueError(f"not a card of this machine: {dev}")
    return torch.cuda.current_stream(dev).cuda_stream


UP, DOWN = "up", "down"
# Pinned buffers grow to a multiple of this, so that batches of about one
# size share one allocation.
_GROW = 1 << 21


class Staging:
    """A grow-only pinned host buffer for copies one way between the host
    and one card.

    :meth:`take` hands out its first bytes once the last copy that read or
    wrote them has completed (an event recorded after that copy); it
    allocates pinned memory only when the buffer must grow. What
    :meth:`take` returned is valid until the next :meth:`take`.
    """

    def __init__(self):
        self._buf: torch.Tensor | None = None
        self._done: torch.cuda.Event | None = None

    def take(self, nbytes: int) -> torch.Tensor:
        """``uint8[nbytes]`` of the buffer, free to write."""
        if self._done is not None:
            with readback("staging"):
                self._done.synchronize()
            self._done = None
        if self._buf is None or self._buf.numel() < nbytes:
            self._buf = None
            size = max(_GROW, -(-nbytes // _GROW) * _GROW)
            self._buf = torch.empty((size,), dtype=torch.uint8,
                                    pin_memory=True)
        return self._buf[:nbytes]

    def _record(self, stream) -> None:
        self._done = torch.cuda.Event()
        self._done.record(stream)

    def upload(self, host: torch.Tensor, device: torch.device,
               stream: torch.cuda.Stream | None = None) -> torch.Tensor:
        """``host`` (a 1-D view of :meth:`take`'s bytes) on ``device``: one
        asynchronous copy on ``stream`` (the current one by default) into
        a new tensor allocated there."""
        stream = stream or torch.cuda.current_stream(device)
        with torch.cuda.stream(stream):
            out = torch.empty(host.shape, dtype=host.dtype, device=device)
            out.copy_(host, non_blocking=True)
        self._record(stream)
        return out

    def download(self, t: torch.Tensor) -> np.ndarray:
        """``t`` (on a card) in the buffer, as a numpy view of its shape:
        one copy on the current stream, waited for."""
        host = self.take(t.numel() * t.element_size()).view(t.dtype)
        host = host.view(t.shape)
        host.copy_(t, non_blocking=True)
        self._record(torch.cuda.current_stream(t.device))
        with readback("staging"):
            self._done.synchronize()
        return host.numpy()


class _PlainStaging:
    """What :func:`staging` gives for the CPU: new zeroed tensors, and no
    copies."""

    @staticmethod
    def take(nbytes: int) -> torch.Tensor:
        return torch.zeros((nbytes,), dtype=torch.uint8)

    @staticmethod
    def upload(host: torch.Tensor, device: torch.device,
               stream=None) -> torch.Tensor:
        return host

    @staticmethod
    def download(t: torch.Tensor) -> np.ndarray:
        return np.ascontiguousarray(t.numpy())


_PLAIN = _PlainStaging()
_local = threading.local()


def staging(device: str | torch.device, direction: str):
    """This thread's staging buffer for copies to (:data:`UP`) or from
    (:data:`DOWN`) ``device``; for the CPU, plain tensors."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return _PLAIN
    if direction not in (UP, DOWN):
        raise ValueError(f"direction must be {UP!r} or {DOWN!r}")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    table = _local.__dict__.setdefault("staging", {})
    return table.setdefault((index, direction), Staging())


def to_device_layout(blocks, cap: int | None = None,
                     device: str | torch.device = "cuda"):
    """Pack byte blocks (any bytes-like) into ``(uint8[N, row_stride(cap)],
    int32[N])`` on ``device``: each block copied once into the staging
    buffer's rows, then one upload.

    ``cap`` defaults to the longest block.
    """
    dev = resolve_device(device)
    n = len(blocks)
    longest = max((len(b) for b in blocks), default=0)
    cap = longest if cap is None else cap
    if longest > cap:
        raise ValueError(f"block of {longest} bytes exceeds cap {cap}")
    stride = row_stride(cap)
    st = staging(dev, UP)
    host = st.take(n * stride + 4 * n)
    arr = host.numpy()
    rows = arr[:n * stride].reshape(n, stride)
    lens = arr[n * stride:].view(np.int32)
    for i, b in enumerate(blocks):
        k = len(b)
        lens[i] = k
        if k:
            rows[i, :k] = np.frombuffer(b, np.uint8)
        else:
            rows[i, 0] = 0      # K1's fast entry point reads it
    out = st.upload(host, dev)
    return out[:n * stride].view(n, stride), out[n * stride:].view(torch.int32)


def upload_bytes(data, device: str | torch.device = "cuda") -> torch.Tensor:
    """The bytes-like ``data`` as ``uint8[len(data)]`` on ``device``: one
    copy into the staging buffer, one upload."""
    dev = resolve_device(device)
    mv = memoryview(data).cast("B")
    st = staging(dev, UP)
    host = st.take(len(mv))
    host.numpy()[:] = np.frombuffer(mv, np.uint8)
    return st.upload(host, dev)


def from_device_layout(t: torch.Tensor, lens) -> list[bytes]:
    """Unpack ``(uint8[N, S], lengths)`` into byte blocks. ``lens`` is an
    int32 tensor or host integers; only the columns up to the longest
    block are downloaded."""
    lens = lens.tolist() if isinstance(lens, torch.Tensor) else list(lens)
    width = max(lens, default=0)
    if not width:
        return [b""] * len(lens)
    arr = staging(t.device, DOWN).download(t[:, :width])
    return [arr[i, :k].tobytes() for i, k in enumerate(lens)]


def from_jax_layout(arr_i32, lens):
    """JAX package layout (``int32[N, W]``, one byte per element, as numpy)
    -> the port's ``(uint8[N, row_stride(W)], int32[N])`` on the CPU.

    All W columns are carried, so nothing of the JAX rows is lost.
    """
    arr_i32 = np.asarray(arr_i32)
    if arr_i32.ndim != 2:
        raise ValueError("expected a 2-D array")
    if arr_i32.size and (arr_i32.min() < 0 or arr_i32.max() > 255):
        raise ValueError("JAX layout holds byte values 0..255")
    n, w = arr_i32.shape
    t = torch.zeros((n, row_stride(w)), dtype=torch.uint8)
    t[:, :w] = torch.from_numpy(arr_i32.astype(np.uint8))
    return t, torch.from_numpy(np.asarray(lens, np.int32).copy())


def to_jax_layout(t: torch.Tensor, lens: torch.Tensor, jax_pad: int):
    """The port's layout -> the JAX package's ``(int32[N, cap + jax_pad],
    int32[N])`` as numpy, where ``cap`` is the row stride less ``PAD``:
    what ``jax_codec.to_device_layout(blocks, cap)`` gives for
    ``jax_pad=64``."""
    cap = t.shape[1] - PAD
    arr = np.zeros((t.shape[0], cap + jax_pad), np.int32)
    arr[:, :cap] = t[:, :cap].cpu().numpy()
    return arr, lens.cpu().numpy().astype(np.int32)
