"""Streaming XXH32 and XXH64 with the lane state on the card: the stream
update entry points of K3 and K4, and their plain versions.

Counterpart of ``lz4_tpu/kernels/xxhash_stream.py``, which keeps the whole
streaming state (``v1..v4``, the remainder, the total length) in device
arrays and absorbs chunks with ``lax.fori_loop``/``lax.scan``
(``stream32_update`` :109, ``stream64_update`` :136, the digests
:196-262). Here the state is split where each part is cheapest:

- the four lane accumulators live in a small tensor on the device
  (``uint32[4]``, or ``int64[4]`` holding u64 bit patterns, as
  ``kernels/xxhash.py`` holds XXH64 hashes);
- the remainder (under one stripe) and the total length stay on the host.

An update that does not complete a stripe only grows the remainder. One
that does absorbs the remainder and the new bytes' whole stripes in one
kernel launch from the carried state; the bytes after the last whole
stripe become the new remainder. Host bytes are copied once into the
pinned staging buffer (``layout.staging``), behind the remainder, and
uploaded in one copy; a ``uint8`` tensor already on the card is absorbed
where it lies (a stripe that joins the remainder to its head is put
together on the card). On a card every copy and launch of a state runs on
the state's own CUDA stream, after the work queued so far on the current
one, so that the hash overlaps what the caller queues next; a tensor it
reads is kept from the caching allocator until that stream is done with
it, and :meth:`digest` waits for the stream. The digest is computed on
the host from the lanes, the remainder and the total length, as
``stream32_digest``/``stream64_digest`` do, including the total past 2^32
bytes; it does not change the state.

A state on a CUDA device launches the kernel; a state on the CPU takes the
plain version, the stripe loop of ``core/xxhash_ref.py``.
"""

from __future__ import annotations

import ctypes
import struct

import numpy as np
import torch

from ..core import xxhash_ref
from ..core.constants import (
    PRIME1, PRIME2, PRIME5, PRIME64_1, PRIME64_2, PRIME64_4, PRIME64_5, U32,
    U64,
)
from ..core.device import resolve_device
from ..utils.profiling import readback
from .build import Kernel
from .layout import UP, cuda_stream, staging

_P, _I64 = ctypes.c_void_p, ctypes.c_longlong
XXH32_STREAM = Kernel("xxh32_stream", "xxh32", "lz4tt_xxh32_stream_update",
                      [_P, _I64, _P, _P])
XXH64_STREAM = Kernel("xxh64_stream", "xxh64", "lz4tt_xxh64_stream_update",
                      [_P, _I64, _P, _P])
# Bytes a stage of the updates' shared-memory ring holds
# (LZ4TT_XXH_STAGE in csrc/lz4tt_xxh_ring.cuh).
STAGE_BYTES = 32768


def _check_absorb(lanes: torch.Tensor, dtype, stripes: torch.Tensor,
                  stripe: int) -> int:
    if lanes.dtype != dtype or lanes.shape != (4,) or not lanes.is_contiguous():
        raise ValueError(f"lanes must be a contiguous {dtype}[4] tensor")
    if (stripes.dtype != torch.uint8 or stripes.dim() != 1
            or not stripes.is_contiguous() or stripes.numel() % stripe):
        raise ValueError(f"expected contiguous uint8[k * {stripe}] stripes")
    if stripes.device != lanes.device:
        raise ValueError("lanes and stripes must be on one device")
    return stripes.numel() // stripe


def absorb32(lanes: torch.Tensor, stripes: torch.Tensor) -> None:
    """Absorb the 16-byte stripes of ``stripes`` (uint8[16 k]) into the
    XXH32 lane accumulators ``lanes`` (uint32[4]), in place."""
    n = _check_absorb(lanes, torch.uint32, stripes, 16)
    if lanes.device.type == "cpu":
        absorb32_plain(lanes, stripes)
        return
    if stripes.data_ptr() % 16:
        raise ValueError("stripes must start 16-byte aligned")
    if n:
        XXH32_STREAM(stripes.data_ptr(), n, lanes.data_ptr(),
                     cuda_stream(lanes), device=lanes.device.index)


def absorb64(lanes: torch.Tensor, stripes: torch.Tensor) -> None:
    """Absorb the 32-byte stripes of ``stripes`` (uint8[32 k]) into the
    XXH64 lane accumulators ``lanes`` (int64[4], u64 bit patterns), in
    place."""
    n = _check_absorb(lanes, torch.int64, stripes, 32)
    if lanes.device.type == "cpu":
        absorb64_plain(lanes, stripes)
        return
    if stripes.data_ptr() % 16:
        raise ValueError("stripes must start 16-byte aligned")
    if n:
        XXH64_STREAM(stripes.data_ptr(), n, lanes.data_ptr(),
                     cuda_stream(lanes), device=lanes.device.index)


def _absorb_plain(lanes: list[int], data: bytes, fmt: str, round_fn):
    step = struct.calcsize(fmt)
    for off in range(0, len(data), step):
        x = struct.unpack_from(fmt, data, off)
        lanes = [round_fn(v, w) for v, w in zip(lanes, x)]
    return lanes


def absorb32_plain(lanes: torch.Tensor, stripes: torch.Tensor) -> None:
    """Plain version of :func:`absorb32`, on any device."""
    _check_absorb(lanes, torch.uint32, stripes, 16)
    v = _absorb_plain(lanes.tolist(), stripes.cpu().numpy().tobytes(),
                      "<IIII", xxhash_ref._round32)
    lanes.copy_(torch.tensor(v, dtype=torch.uint32))


def absorb64_plain(lanes: torch.Tensor, stripes: torch.Tensor) -> None:
    """Plain version of :func:`absorb64`, on any device."""
    _check_absorb(lanes, torch.int64, stripes, 32)
    v = _absorb_plain([x & U64 for x in lanes.tolist()],
                      stripes.cpu().numpy().tobytes(), "<QQQQ",
                      xxhash_ref._round64)
    lanes.copy_(torch.tensor([xxhash_ref.as_s64(x) for x in v],
                             dtype=torch.int64))


class _StreamState:
    """Lanes on ``device``, remainder and total length on the host."""

    STRIPE: int

    def __init__(self, seed: int, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.seed = seed
        self._side = None
        if self.device.type == "cuda":
            self._side = torch.cuda.Stream(self.device)
            # [0, STRIPE): the remainder on its way up; [STRIPE, 2 STRIPE):
            # a tensor's tail on its way down
            self._small = torch.empty((2 * self.STRIPE,), dtype=torch.uint8,
                                      pin_memory=True)
        self._tail = None       # (length, event) of that tail's copy
        self._host = None       # what staged() handed out
        self.reset()

    def _init_lanes(self) -> torch.Tensor:
        raise NotImplementedError

    def _absorb(self, stripes: torch.Tensor) -> None:
        raise NotImplementedError

    @property
    def lanes(self) -> torch.Tensor:
        """The lane accumulators, once every absorb queued has run."""
        self._settle()
        if self._side is not None:
            with readback("lanes"):
                self._side.synchronize()
        return self._v

    def reset(self) -> None:
        self._settle()
        if self._side is not None:
            with readback("reset"):
                self._side.synchronize()
        self._v = self._init_lanes()
        if self._side is not None:
            self._v.record_stream(self._side)
        self.mem = b""
        self.total_len = 0

    def _settle(self) -> None:
        """The remainder, once the copy of a tensor's tail has landed."""
        if self._tail is not None:
            k, done = self._tail
            with readback("settle"):
                done.synchronize()
            s = self.STRIPE
            self.mem = self._small.numpy()[s:s + k].tobytes()
            self._tail = None

    def _split(self, n: int):
        """Account for ``n`` new bytes; returns ``(held, whole, head)``:
        the remainder's length, the bytes of the whole stripes that
        remainder and new bytes make (0 when none completes), and how many
        of those are new."""
        self._settle()
        self.total_len += n
        held = len(self.mem)
        whole = (held + n) // self.STRIPE * self.STRIPE
        return held, whole, max(0, whole - held)

    def _on_side(self):
        """The state's stream, after the work queued on the current one."""
        self._side.wait_stream(torch.cuda.current_stream(self.device))
        return torch.cuda.stream(self._side)

    def staged(self, nbytes: int) -> np.ndarray:
        """A writable view of ``nbytes`` of the staging buffer (pinned on a
        card) for the caller to fill, e.g. with ``readinto``; then
        :meth:`update_staged` absorbs what was written. Valid until the
        staging buffer's next use."""
        self._host = staging(self.device, UP).take(self.STRIPE + nbytes)
        return self._host.numpy()[self.STRIPE:]

    def update_staged(self, n: int) -> None:
        """Absorb the first ``n`` bytes written into :meth:`staged`."""
        host, self._host = self._host, None
        arr, s = host.numpy(), self.STRIPE
        held, whole, head = self._split(n)
        if not whole:
            self.mem += arr[s:s + n].tobytes()
            return
        arr[s - held:s] = np.frombuffer(self.mem, np.uint8)
        self.mem = arr[s + head:s + n].tobytes()
        stripes = host[s - held:s - held + whole]
        if self._side is None:
            self._absorb(stripes)
            return
        with self._on_side():
            self._absorb(staging(self.device, UP).upload(
                stripes, self.device, self._side))

    def update(self, data) -> None:
        """Absorb ``data``: any contiguous bytes-like on the host, or a
        contiguous ``uint8[n]`` tensor on the state's device, which the
        caller does not write again until :attr:`lanes` or
        :meth:`digest` has been read (the state's stream reads it
        later)."""
        if isinstance(data, torch.Tensor):
            self._update_tensor(data)
            return
        mv = memoryview(data).cast("B")
        self.staged(len(mv))[:len(mv)] = np.frombuffer(mv, np.uint8)
        self.update_staged(len(mv))

    def _update_tensor(self, t: torch.Tensor) -> None:
        if (t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous()
                or t.device.type != self.device.type):
            raise ValueError("expected a contiguous uint8[n] tensor on the "
                             "state's device")
        n = t.numel()
        if not n:
            return
        held, whole, head = self._split(n)
        if not whole:
            self.mem += t.cpu().numpy().tobytes()
            return
        mem, s = self.mem, self.STRIPE
        if self._side is None:
            self.mem = t[head:].numpy().tobytes()
            self._absorb(torch.cat((torch.tensor(list(mem), dtype=torch.uint8),
                                    t[:head])))
            return
        small = self._small
        with self._on_side():
            small[s:s + n - head].copy_(t[head:], non_blocking=True)
            if held or t.data_ptr() % 16:
                stripes = torch.empty((whole,), dtype=torch.uint8,
                                      device=self.device)
                small.numpy()[:held] = np.frombuffer(mem, np.uint8)
                stripes[:held].copy_(small[:held], non_blocking=True)
                stripes[held:] = t[:head]
            else:
                stripes = t[:head]
            done = torch.cuda.Event()
            done.record(self._side)
            self._absorb(stripes)
        t.record_stream(self._side)
        self.mem = b""
        self._tail = (n - head, done)


class StreamState32(_StreamState):
    """Streaming XXH32: lanes ``uint32[4]`` on the device."""

    STRIPE = 16

    def _init_lanes(self) -> torch.Tensor:
        s = self.seed & U32
        lanes = [(s + PRIME1 + PRIME2) & U32, (s + PRIME2) & U32, s,
                 (s - PRIME1) & U32]
        return torch.tensor(lanes, dtype=torch.uint32, device=self.device)

    def _absorb(self, stripes: torch.Tensor) -> None:
        absorb32(self._v, stripes)

    def digest(self) -> int:
        """The unsigned XXH32 of everything absorbed; the state is kept."""
        v1, v2, v3, v4 = self.lanes.tolist()
        r = xxhash_ref._rotl32
        if self.total_len >= 16:
            h = r(v1, 1) + r(v2, 7) + r(v3, 12) + r(v4, 18)
        else:
            h = (self.seed & U32) + PRIME5
        h = (h + self.total_len) & U32   # the total's low word, as in Java
        return xxhash_ref._tail32(h, self.mem, 0, len(self.mem))


class StreamState64(_StreamState):
    """Streaming XXH64: lanes ``int64[4]`` (u64 bit patterns) on the
    device."""

    STRIPE = 32

    def _init_lanes(self) -> torch.Tensor:
        s = self.seed & U64
        lanes = [s + PRIME64_1 + PRIME64_2, s + PRIME64_2, s, s - PRIME64_1]
        return torch.tensor([xxhash_ref.as_s64(x) for x in lanes],
                            dtype=torch.int64, device=self.device)

    def _absorb(self, stripes: torch.Tensor) -> None:
        absorb64(self._v, stripes)

    def digest(self) -> int:
        """The unsigned XXH64 of everything absorbed; the state is kept."""
        lanes = [x & U64 for x in self.lanes.tolist()]
        if self.total_len >= 32:
            r = xxhash_ref._rotl64
            h = (r(lanes[0], 1) + r(lanes[1], 7) + r(lanes[2], 12)
                 + r(lanes[3], 18)) & U64
            for v in lanes:
                h ^= xxhash_ref._round64(0, v)
                h = (h * PRIME64_1 + PRIME64_4) & U64
        else:
            h = ((self.seed & U64) + PRIME64_5) & U64
        h = (h + self.total_len) & U64
        return xxhash_ref._tail64(h, self.mem, 0, len(self.mem))
