"""Batched LZ4 HC compression: the K6 kernel and its plain version.

The counterpart of ``lz4_tpu/kernels/jax_hc.py``: ``compress_hc_batch``
keeps its contract (a batch in; the output batch, its lengths and one
error code per block out) in the port's layout (``kernels/layout.py``),
and its output is byte-identical to it and to the host HC at every level.
A CUDA tensor goes to K6 (``csrc/lz4_hc.cu``); a CPU tensor goes to the
plain version, :func:`compress_hc_plain`. There is no fallback from one
to the other.

K6 keeps each block's match-finder tables and bucket index (1.375 MiB) in
a team's slice of a scratch tensor on the card (5.5 GiB at 4096 teams),
sized to the teams a launch runs (at most the resident CTAs, with no
budget) by ``build.Scratch``, which keeps it between calls up to its
``SCRATCH_KEEP``.

K6 has two kernels, and the wrapper picks one from what it sees of the
batch (:func:`takes_wide_path`): a batch that leaves the card room, at a
level whose walks speculate, of rows the bucket index takes, runs the wide
kernel (``lz4tt_compress_hc_wide``: a CTA of warps a row, which all sort
the row's bucket index; warp 0 runs the row, and while its walks run long
the other warps check a walk's candidates with it, a slice a warp at
once); any other batch, the warp kernel (a warp a row), whose rows are
resident all at once.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..core.errors import Lz4Error
from ..core.lz4_hc_ref import compress_hc
from ..utils.profiling import entry
from .build import Kernel, Scratch, c_function, resident_ctas
from .codec import ERR_DEST_TOO_SMALL
from .layout import check_batch, cuda_stream, row_stride

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = [_P, _I64, _P, _P, _I64, _I32, _I32, _P, _I32, _P, _P, _I32, _P]
HC = Kernel("lz4_hc", "lz4_hc", "lz4tt_compress_hc", _ARGS)
HC_WIDE = Kernel("lz4_hc_wide", "lz4_hc", "lz4tt_compress_hc_wide", _ARGS)
SCRATCH = Scratch(torch.uint8, budget=None)
# the fewest attempts a search whose walks speculate
# (LZ4TT_HC_SPEC_ATTEMPTS), and the longest row the bucket index takes
SPEC_ATTEMPTS = 16
INDEX_ROW = 1 << 16


def check_level(level: int) -> None:
    if not 1 <= level <= 17:
        raise ValueError(f"level must be 1..17, got {level}")


def resident_teams(index: int) -> int:
    """K6's teams (one warp a CTA) that card ``index`` holds at once."""
    return resident_ctas("lz4_hc", "lz4tt_hc_occupancy", index)


def wide_capacity(index: int) -> int:
    """The wide kernel's CTAs (a row each) that card ``index`` holds at
    once (its resident CTAs an SM times the SMs; queried once a card)."""
    return resident_ctas("lz4_hc", "lz4tt_hc_wide_occupancy", index)


def speculates(level: int) -> bool:
    """Whether the walks at ``level`` speculate (``lz4tt_hc_speculates``)."""
    return 1 << (level - 1) >= SPEC_ATTEMPTS


def takes_wide_path(n: int, level: int, longest: int, capacity: int) -> bool:
    """Whether a batch of ``n`` rows of at most ``longest`` bytes at
    ``level`` runs the wide kernel on a card that holds ``capacity`` of its
    CTAs at once: when the level's walks speculate, every row fits the
    bucket index, and the batch fits the card in one round. Any other
    batch runs the warp kernel: a serial walk gains nothing from the
    warps, and a second round of the wide kernel costs more than the warp
    kernel's one."""
    return 0 < n <= capacity and speculates(level) and longest <= INDEX_ROW


@functools.cache
def team_bytes() -> int:
    """Bytes of scratch one team's tables take (``LZ4TT_HC_TEAM_BYTES``)."""
    return c_function("lz4_hc", "lz4tt_hc_team_bytes", [], None)()


@entry
def compress_hc_batch(src: torch.Tensor, src_lens: torch.Tensor,
                      dest_cap: int, level: int = 9):
    """Batched LZ4 HC compression at ``level`` (1..17), byte-identical to
    ``jax_hc.compress_hc_batch`` and the host HC.

    Args:
      src: uint8[N, S] input blocks; src_lens: int32[N] exact lengths.
      dest_cap: per-block output capacity; a block that does not fit it
        by the reference's checks gets ``ERR_DEST_TOO_SMALL``
        (``max_compressed_length(L)`` never fails).

    Returns:
      (dest uint8[N, row_stride(dest_cap)], lens int32[N] (0 on an error
      row), err int32[N]).
    """
    check_level(level)
    longest = check_batch(src, src_lens)
    if dest_cap < 0:
        raise ValueError("dest_cap must be >= 0")
    if src.device.type == "cpu":
        return compress_hc_plain(src, src_lens, dest_cap, level)
    n, index = src.shape[0], src.device.index
    dest = torch.zeros((n, row_stride(dest_cap)), dtype=torch.uint8,
                       device=src.device)
    out_lens = torch.empty((n,), dtype=torch.int32, device=src.device)
    err = torch.empty((n,), dtype=torch.int32, device=src.device)
    capacity = wide_capacity(index)
    kernel, resident = ((HC_WIDE, capacity)
                        if takes_wide_path(n, level, longest, capacity)
                        else (HC, resident_teams(index)))
    teams, scratch = SCRATCH.teams(src, n, resident, team_bytes())
    kernel(src.data_ptr(), src.stride(0), src_lens.data_ptr(), dest.data_ptr(),
           dest.stride(0), dest_cap, level, scratch.data_ptr(), teams,
           out_lens.data_ptr(), err.data_ptr(), n, cuda_stream(src),
           device=index)
    return dest, out_lens, err


def compress_hc_plain(src: torch.Tensor, src_lens: torch.Tensor,
                      dest_cap: int, level: int = 9):
    """Plain version of :func:`compress_hc_batch`, on any device: the host
    HC (``core/lz4_hc_ref.py``) a row at a time, its ``Lz4Error`` as
    ``ERR_DEST_TOO_SMALL``."""
    check_level(level)
    check_batch(src, src_lens)
    src_np = src.cpu().numpy()
    lens = src_lens.cpu().tolist()
    dest = np.zeros((len(lens), row_stride(dest_cap)), np.uint8)
    out_lens = np.zeros((len(lens),), np.int32)
    err = np.zeros((len(lens),), np.int32)
    for i, n in enumerate(lens):
        buf = bytearray(dest_cap)
        try:
            k = compress_hc(src_np[i, :n].tobytes(), 0, n, buf, 0, dest_cap,
                            level)
        except Lz4Error:
            err[i] = ERR_DEST_TOO_SMALL
            continue
        out_lens[i] = k
        dest[i, :k] = np.frombuffer(buf, np.uint8, k)
    dev = src.device
    return (torch.from_numpy(dest).to(dev), torch.from_numpy(out_lens).to(dev),
            torch.from_numpy(err).to(dev))
