"""Batches of byte blocks as tensors: ``uint8[N, stride]`` + ``int32[N]``.

The JAX package carried one byte per int32 element because TPU vector
memory has no sub-word addressing (``lz4_tpu/kernels/jax_codec.py:12-15``).
The port keeps bytes as bytes. A row holds ``cap`` bytes rounded up to 16,
then ``PAD`` bytes of slack; the stride is a multiple of 16 so that every
row starts 16-byte aligned for the kernels' vector loads. Bytes past a
block's length are zero.

``from_jax_layout`` / ``to_jax_layout`` carry a batch across between the two
packages: this system has no weights, so the state that crosses is the
batch itself.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.device import resolve_device

PAD = 16


def row_stride(cap: int) -> int:
    """Row stride of a batch whose blocks hold up to ``cap`` bytes."""
    if cap < 0:
        raise ValueError(f"cap must be >= 0, got {cap}")
    return ((cap + 15) & ~15) + PAD


def check_batch(data: torch.Tensor, lens: torch.Tensor) -> None:
    """Validate a ``(uint8[N, S], int32[N])`` batch; lengths must lie in
    ``[0, S]`` (this reads them, so it waits for the card)."""
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("expected a contiguous uint8[N, S] tensor")
    if (lens.dtype != torch.int32 or lens.dim() != 1
            or lens.shape[0] != data.shape[0] or not lens.is_contiguous()):
        raise ValueError("expected contiguous int32[N] lengths")
    if lens.device != data.device:
        raise ValueError("data and lengths must be on one device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    if lens.numel():
        lo, hi = torch.aminmax(lens)
        if int(lo) < 0 or int(hi) > data.shape[1]:
            raise ValueError(f"lengths must lie in [0, {data.shape[1]}]")


def cuda_stream(t: torch.Tensor) -> int:
    """Handle of the current CUDA stream of ``t``'s device.

    The kernels' libraries launch on their runtime's current device, which
    is device 0; a tensor on another card is refused, not launched against
    the wrong context.
    """
    if t.device.index not in (None, 0):
        raise ValueError(f"the kernels run on cuda:0 only, got {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def to_device_layout(blocks: list[bytes], cap: int | None = None,
                     device: str | torch.device = "cuda"):
    """Pack byte blocks into ``(uint8[N, row_stride(cap)], int32[N])``.

    ``cap`` defaults to the longest block.
    """
    dev = resolve_device(device)
    longest = max((len(b) for b in blocks), default=0)
    cap = longest if cap is None else cap
    if longest > cap:
        raise ValueError(f"block of {longest} bytes exceeds cap {cap}")
    arr = np.zeros((len(blocks), row_stride(cap)), np.uint8)
    lens = np.zeros((len(blocks),), np.int32)
    for i, b in enumerate(blocks):
        arr[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return torch.from_numpy(arr).to(dev), torch.from_numpy(lens).to(dev)


def from_device_layout(t: torch.Tensor, lens: torch.Tensor) -> list[bytes]:
    """Unpack ``(uint8[N, S], int32[N])`` into byte blocks."""
    arr = t.cpu().numpy()
    return [arr[i, :n].tobytes() for i, n in enumerate(lens.cpu().tolist())]


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
