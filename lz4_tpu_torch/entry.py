"""Entry points of the port: the batched safe block decoder and the
several-GPU dry run.

Counterparts of ``__graft_entry__.py``: ``entry()`` returns ``(fn, args)``,
where ``fn`` decodes a batch of compressed blocks (the K1 kernel on the
card) and ``args`` is such a batch, compressed on the same device;
``dryrun_multigpu(n)`` runs the sharded roundtrip step and the
several-process frames on ``n`` ranks, as ``dryrun_multichip(n)`` runs them
on an ``n``-device mesh.
"""

from __future__ import annotations

import torch

from .core.constants import max_compressed_length
from .core.device import resolve_device
from .core.errors import Lz4Error
from .dist import multihost
from .kernels.codec import compress_fast_batch, decompress_safe_batch
from .kernels.layout import to_device_layout

BLOCK_LEN = 1024
N_BLOCKS = 8


def example_blocks() -> list[bytes]:
    """Deterministic compressible blocks (the fallback data of
    ``__graft_entry__._example_blocks``)."""
    data = bytes((i * 7 + (i >> 3)) & 0xFF for i in range(BLOCK_LEN * N_BLOCKS))
    return [data[i * BLOCK_LEN:(i + 1) * BLOCK_LEN] for i in range(N_BLOCKS)]


def entry(device: str | torch.device = "cuda"):
    """Returns ``(fn, (comp, comp_lens))``: ``fn(comp, comp_lens)`` is the
    batched safe decode to ``(out, out_lens, err)``."""
    dev = resolve_device(device)
    src, lens = to_device_layout(example_blocks(), BLOCK_LEN, dev)
    comp, comp_lens, err = compress_fast_batch(
        src, lens, max_compressed_length(BLOCK_LEN))
    if bool(err.any()):
        raise Lz4Error("compressing the example blocks failed")

    def forward(comp, comp_lens):
        return decompress_safe_batch(comp, comp_lens, BLOCK_LEN)

    return forward, (comp, comp_lens)


def dryrun_multigpu(n: int, device: str | torch.device = "cuda",
                    share_card: bool = False, *,
                    data_bytes: int = 3 * 65536 + 1234,
                    blocks_per_rank: int = 1, block_len: int = 65536,
                    timeout: float = 300.0, workdir=None) -> dict:
    """Spawn ``n`` ranks (``dist/multihost.py::run_ranks``) that each run
    ``sharded_roundtrip_step`` on ``n * blocks_per_rank`` blocks of
    ``block_len`` bytes (the JAX dry run's 1 block of 64 KiB a device by
    default) and ``compress_frame_multihost`` on ``data_bytes`` of seeded
    data, fast and HC at level 9 on its first 3,000 bytes, and the packed
    frame and the XXH64 of its blocks; every rank's results must be
    identical and every block of the step OK.

    Rank r runs on ``cuda:r`` over NCCL; with fewer than ``n`` cards this
    raises, unless ``share_card=True`` puts every rank on ``cuda:0`` with
    gloo collectives. ``device="cpu"`` runs gloo on the plain versions.
    Returns rank 0's results (``frame``, ``packed_frame``, ``hc_frame``,
    ``xxh64``, ``step``) with ``phase_ms`` and ``block_range`` by rank.
    """
    job = {"data_bytes": data_bytes, "step": [blocks_per_rank, block_len]}
    return multihost.dryrun(n, job, device, share_card, timeout, workdir)
