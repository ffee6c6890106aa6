"""Process-parallel scaling of the several-process path.

Counterpart of ``lz4_tpu/dist/multihost_scaling.py``: the same protocol
over the port's ranks. :func:`measure` times one fixed workload,
``compress_blocks_multihost`` on seeded alphabet-4 blocks (every block's
compressed bytes on every rank, the exchange included), three ways:

- ``t_multi``: ``nproc`` ranks in one process group over the whole
  workload; the slowest rank counts;
- ``t_os``: ``nproc`` independent processes (no group, no exchange), each
  on one share (``total_blocks // nproc`` blocks) at once: the same-width
  ceiling of plain process parallelism on this machine;
- ``t_ref``: one process on one share.

and reports ``multihost_efficiency`` (``t_ref / t_multi``),
``os_ceiling_efficiency`` (``t_ref / t_os``) and
``multihost_vs_os_ceiling`` (``t_os / t_multi``), medians over interleaved
multi/os/ref trials. Each worker is pinned to a core, warms up once and
keeps its best of 5 runs; in a group each run starts behind a barrier, and
on the card each run ends by synchronising the card before the clock is
read.

**Where the ranks run** (``placement`` in the result). On the CPU
(``device="cpu"``) the ranks are gloo processes on the plain versions. On
a machine with a card a rank (``device="cuda"``), rank r runs on
``cuda:r`` over NCCL. With fewer cards than ranks this raises, unless
``share_card=True`` puts every rank on ``cuda:0`` with gloo collectives:
their CUDA contexts take turns on the one card and the exchange goes
through host memory. Ranks sharing one H100 measure **sharing one card,
not scaling across cards**.

Differences from the JAX module, by design:

- no ``port`` argument: the ranks meet through a ``file://`` rendezvous in
  a temporary directory (``dist/multihost.py::run_ranks``), not a TCP
  coordinator, so concurrent measurements cannot collide;
- ``nproc > total_blocks`` raises ``ValueError``; the JAX module evens the
  shares down to zero blocks there and times no work;
- the result adds ``placement`` and the SHA-256 of the joined compressed
  blocks (``sha256``: the group's, equal on every rank or this raises;
  ``share_sha256``: one share's, equal across the independent and the
  one-process runs or this raises);
- the defaults are the main path's width, 4,096 blocks of 64 KiB (the JAX
  module's 32 x 4 KiB is a few microseconds of K2 on the card), and
  times and efficiencies are not rounded.

Run as a module for one JSON line (widths 2, 3 and 4, on the card; ranks
share ``cuda:0`` when the machine has fewer cards than the width, and the
line says so)::

    python -m lz4_tpu_torch.dist.multihost_scaling
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import statistics
import time

import numpy as np
import torch

from ..core.device import resolve_device
from ..kernels import build
from .mesh import BlockMesh
from .multihost import (
    barrier, compress_blocks_multihost, placement, run_ranks)

SEED = 3             # the JAX workers' blocks: default_rng(3), alphabet 4
REPS = 5             # timed runs a worker, after one warm-up run
JOB = "lz4_tpu_torch.dist.multihost_scaling:compress_job"


def scaling_blocks(n_blocks: int, block_len: int) -> np.ndarray:
    """The JAX workers' data: ``uint8[n_blocks, block_len]`` of an
    alphabet of 4 from ``default_rng(3)``."""
    return np.random.default_rng(SEED).integers(
        0, 4, (n_blocks, block_len), dtype=np.uint8)


def timed_runs(mesh: BlockMesh, fn, reps: int):
    """``reps`` runs of ``fn()``, each behind a barrier of ``mesh``'s group
    and ended by synchronising its card; returns (seconds of each run, the
    last run's result)."""
    times, out = [], None
    for _ in range(reps):
        barrier(mesh)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        t0 = time.perf_counter()
        out = fn()
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        times.append(time.perf_counter() - t0)
    return times, out


def sha256_of(blocks: list[bytes]) -> str:
    """SHA-256 of the blocks joined in order."""
    h = hashlib.sha256()
    for b in blocks:
        h.update(b)
    return h.hexdigest()


def compress_job(mesh: BlockMesh, job: dict) -> dict:
    """A worker: ``compress_blocks_multihost`` of ``job["blocks"]`` seeded
    blocks of ``job["block_len"]`` bytes on ``mesh``, once to warm up, then
    its best of :data:`REPS` timed runs and the digest of its output."""
    blocks = [row.tobytes()
              for row in scaling_blocks(job["blocks"], job["block_len"])]
    compress_blocks_multihost(blocks, mesh)
    times, out = timed_runs(
        mesh, lambda: compress_blocks_multihost(blocks, mesh), REPS)
    if len(out) != len(blocks) or not all(out):
        raise RuntimeError("multihost scaling: an empty compressed block")
    return {"best_s": min(times), "sha256": sha256_of(out),
            "world_size": mesh.world_size}


def _spawn(nproc: int, blocks: int, block_len: int, device, share_card,
           timeout: float, workdir, group: bool = True) -> tuple[float, str]:
    """Run :func:`compress_job` on ``nproc`` workers; return the slowest
    worker's best time and the digest every worker gave (raises if they
    differ)."""
    res = run_ranks(nproc, {"fn": JOB, "blocks": blocks,
                            "block_len": block_len},
                    device, share_card, timeout, workdir, group)
    digests = {r["sha256"] for r in res}
    if len(digests) != 1:
        raise RuntimeError(f"multihost scaling: the {nproc} workers' outputs "
                           f"differ ({len(digests)} digests)")
    return max(r["best_s"] for r in res), digests.pop()


def measure(total_blocks: int = 4096, block_len: int = 65536,
            nproc: int = 2, timeout: float = 420.0, trials: int = 3,
            device: str | torch.device = "cuda", share_card: bool = False,
            workdir=None) -> dict:
    """Time the fixed workload at ``nproc`` ranks in one group, against one
    process running one share (``total_blocks // nproc``) of it, and
    against ``nproc`` independent processes running a share each (the
    same-width ceiling); ``trials`` interleaved multi/os/ref triples,
    medians reported, per-trial efficiencies alongside.

    Shares are kept exactly even: ``total_blocks`` is cut to a multiple of
    ``nproc``. ``nproc > total_blocks`` raises ``ValueError``. Each
    spawn's logs go to a directory of ``workdir`` when one is given.
    """
    if not 1 <= nproc <= total_blocks:
        raise ValueError(f"nproc must be in 1..total_blocks "
                         f"({total_blocks}), not {nproc}")
    where = placement(nproc, device, share_card)
    if resolve_device(device).type == "cuda":
        build.build_all()       # before the workers, which would queue on it
    total_blocks -= total_blocks % nproc
    share = total_blocks // nproc

    def spawn(t, kind, n, blocks, group=True):
        sub = None if workdir is None else pathlib.Path(workdir, f"{t}-{kind}")
        return _spawn(n, blocks, block_len, device, share_card, timeout, sub,
                      group)

    effs, ceils, vs_ceils, multis, oss, refs = [], [], [], [], [], []
    digest = share_digest = None
    for t in range(trials):
        t_multi, digest = spawn(t, "multi", nproc, total_blocks)
        t_os, os_digest = spawn(t, "os", nproc, share, group=False)
        t_ref, share_digest = spawn(t, "ref", 1, share)
        if os_digest != share_digest:
            raise RuntimeError("multihost scaling: the independent workers' "
                               "share differs from one process's")
        multis.append(t_multi)
        oss.append(t_os)
        refs.append(t_ref)
        effs.append(t_ref / t_multi)
        ceils.append(t_ref / t_os)
        vs_ceils.append(t_os / t_multi)
    return {
        "total_blocks": total_blocks,
        "block_len": block_len,
        "processes": nproc,
        "placement": where,
        "t_multi_s": statistics.median(multis),
        "t_os_s": statistics.median(oss),
        "t_ref_s": statistics.median(refs),
        "trial_efficiencies": effs,
        "multihost_efficiency": statistics.median(effs),
        "os_ceiling_efficiency": statistics.median(ceils),
        "multihost_vs_os_ceiling": statistics.median(vs_ceils),
        "sha256": digest,
        "share_sha256": share_digest,
    }


def measure_widths(widths=(2, 3, 4), total_blocks: int = 4096,
                   block_len: int = 65536, timeout: float = 420.0,
                   device: str | torch.device = "cuda",
                   share_card: bool = False, workdir=None) -> dict:
    """:func:`measure` at each width, one dict keyed by width; the first
    (narrowest) width gets 3 trials, the others 2."""
    out = {}
    for w in widths:
        sub = None if workdir is None else pathlib.Path(workdir, f"w{w}")
        out[str(w)] = measure(total_blocks, block_len, w, timeout,
                              3 if w == min(widths) else 2, device,
                              share_card, sub)
    return out


def main() -> None:
    """``python -m``: :func:`measure_widths` on the card, ranks sharing
    ``cuda:0`` when there are fewer cards than the widest width."""
    widths = (2, 3, 4)
    resolve_device("cuda")
    cards = torch.cuda.device_count()
    share = cards < max(widths)
    out = measure_widths(widths, share_card=share)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "cards": cards, "share_card": share,
                      "widths": out}))


if __name__ == "__main__":
    main()
