"""Shard-parallel efficiency of the fast compress over ranks, beside a
control with no communication and no code of the codec.

Counterpart of ``lz4_tpu/dist/scaling.py``, which times the sharded compress
(``_compress_sharded``: the fast scan under ``shard_map``, outputs left
sharded, no exchange) on a mesh of w virtual devices in one process. The
port has no device mesh in one process (one rank a process,
``dist/__init__.py``), so :func:`measure` runs the same protocol over
ranks spawned by ``dist/multihost.py::run_ranks``:

- for each width w, w ranks each upload their own range of the seeded
  blocks (``BlockMesh.block_range``) once, then time K2
  (``kernels/codec.py::compress_fast_batch``) on it ``trials`` times, each
  run behind a barrier and ended by synchronising the card; nothing is
  exchanged in the timed window, and the slowest rank of a run counts
  (``times_s``: the best run);
- one process with no group times one share's rows (``total_blocks // w``)
  the same way (``local_ref_s``);
- ``shard_parallel_efficiency`` is ``local_ref_s / times_s``, and
  ``core_normalized_efficiency`` is it times ``w / min(w, cores)``;
- the control (:func:`control_step`): each rank runs 1,200 steps of
  ``tanh(v @ x0)`` on the first 256 x 256 float32 matrix of its range of
  ``max(widths)`` seeded matrices, timed with the same protocol
  (``control_efficiency``);
- ``control_relative_ratio`` is the codec's efficiency over the
  control's, clamped to its validity range: widths up to the core count,
  and only where the codec's efficiency is at most 1.05 times the
  control's; elsewhere ``None``. The headline is the width
  ``min(cores, max(widths))``.

"Cores" (``physical_cores`` in the result) are the parallel units the
ranks run on: ``os.cpu_count()`` on the CPU (``device="cpu"``: gloo ranks
on the plain versions), the number of distinct cards on the card. With
``share_card=True`` every rank runs on ``cuda:0`` (gloo collectives; the
ranks' CUDA contexts take turns on the one card), so the count is 1: ranks
sharing one H100 measure **sharing one card, not scaling across cards**,
and the headline is width 1. Without ``share_card`` rank r runs on
``cuda:r`` over NCCL, and widths above the card count are left out, as the
JAX module leaves out widths above its device count.

The result has every key of the JAX function's, and adds ``placement``
(by width) and ``sha256`` (by width): the SHA-256 of the width's
compressed blocks joined in order, gathered after the timed window, equal
on every rank and to one process's K2 output on the same rows, or this
raises. Times and efficiencies are not rounded. The defaults are the main
path's width, 4,096 blocks of 64 KiB; every width must divide
``total_blocks`` (``ValueError`` otherwise).

Run as a module for one JSON line (widths 1, 2, 4 and 8 on the card; ranks
share ``cuda:0`` when the machine has fewer cards than the widest width,
and the line says so)::

    python -m lz4_tpu_torch.dist.scaling
"""

from __future__ import annotations

import json
import os
import pathlib

import numpy as np
import torch

from ..core.constants import max_compressed_length
from ..core.device import resolve_device
from ..core.errors import Lz4Error
from ..kernels import build
from ..kernels.codec import compress_fast_batch
from ..kernels.layout import from_device_layout
from .mesh import BlockMesh
from .multihost import placement, run_ranks
from .multihost_scaling import scaling_blocks, sha256_of, timed_runs
from .sharded import _gather_blocks, upload_blocks

CONTROL_SEED = 0     # the JAX control's matrices: default_rng(0)
CONTROL_SIDE = 256
CONTROL_STEPS = 1200
WIDTH_JOB = "lz4_tpu_torch.dist.scaling:width_job"
LOCAL_JOB = "lz4_tpu_torch.dist.scaling:local_job"


def control_matrix(rows: int, row: int, device: torch.device) -> torch.Tensor:
    """Matrix ``row`` of the control's ``rows`` seeded float32 matrices of
    256 x 256, on ``device``."""
    base = np.random.default_rng(CONTROL_SEED).standard_normal(
        (rows, CONTROL_SIDE, CONTROL_SIDE)).astype(np.float32)
    return torch.from_numpy(base[row]).to(device)


def control_step(x0: torch.Tensor) -> torch.Tensor:
    """The control's work: 1,200 steps of ``v = tanh(v @ x0)`` from
    ``v = x0``. Not a kernel of the codec: it is what the ranks' overlap
    gives on work that holds no code of the port."""
    v = x0
    for _ in range(CONTROL_STEPS):
        v = torch.tanh(v @ x0)
    return v


def _blocks_out(out) -> list[bytes]:
    comp, comp_lens, err = out
    if bool(err.any()):
        raise Lz4Error("scaling: the fast compress failed on a block")
    return from_device_layout(comp, comp_lens)


def width_job(mesh: BlockMesh, job: dict) -> dict:
    """A rank of width ``mesh.world_size``: K2 on its range, warmed once
    and timed ``job["trials"]`` times; the control likewise; then the
    digest of every rank's compressed blocks gathered in order."""
    total, block_len, trials = job["blocks"], job["block_len"], job["trials"]
    start, end = mesh.block_range(total)
    src, lens = upload_blocks(scaling_blocks(total, block_len)[start:end],
                              mesh.device)
    cap = max_compressed_length(block_len)
    run = lambda: compress_fast_batch(src, lens, cap)
    run()
    times, out = timed_runs(mesh, run, trials)
    rows = job["control_rows"]
    x0 = control_matrix(rows, mesh.block_range(rows)[0], mesh.device)
    control_step(x0)
    control, _ = timed_runs(mesh, lambda: control_step(x0), trials)
    gathered = _gather_blocks(mesh, _blocks_out(out), total, "scaling")
    return {"times": times, "control_times": control,
            "sha256": sha256_of(gathered)}


def local_job(mesh: BlockMesh, job: dict) -> dict:
    """One process, no group: for each width w, K2 on the first
    ``blocks // w`` rows and the control on the first of ``control_rows //
    w`` matrices, each warmed once and timed ``job["trials"]`` times; and
    the digest of K2's output on every row."""
    total, block_len, trials = job["blocks"], job["block_len"], job["trials"]
    src, lens = upload_blocks(scaling_blocks(total, block_len), mesh.device)
    x0 = control_matrix(job["control_rows"], 0, mesh.device)
    cap = max_compressed_length(block_len)
    times, control = {}, {}
    for w in job["widths"]:
        k = total // w
        run = lambda: compress_fast_batch(src[:k], lens[:k], cap)
        run()
        times[w], _ = timed_runs(mesh, run, trials)
        control_step(x0)
        control[w], _ = timed_runs(mesh, lambda: control_step(x0), trials)
    digest = sha256_of(_blocks_out(compress_fast_batch(src, lens, cap)))
    return {"times": times, "control_times": control, "sha256": digest}


def _slowest_best(results: list[dict], key: str) -> float:
    """The best run of a width, a run's time being its slowest rank's."""
    return min(max(runs) for runs in zip(*(r[key] for r in results)))


def measure(total_blocks: int = 4096, block_len: int = 65536,
            widths=(1, 2, 4, 8), trials: int = 3,
            device: str | torch.device = "cuda", share_card: bool = False,
            timeout: float = 420.0, workdir=None) -> dict:
    """Best-of-``trials`` times of K2 on ``total_blocks`` seeded blocks
    over w ranks at each width, each paired with one process's time on
    one share (``total_blocks // w`` blocks), and the control; see the
    module's docstring for the keys. Each spawn's logs go to a directory
    of ``workdir`` when one is given."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        cores = os.cpu_count() or 1
    else:
        cards = torch.cuda.device_count()
        cores = 1 if share_card else cards
        if not share_card:
            widths = [w for w in widths if w <= cards]
        build.build_all()       # before the workers, which would queue on it
    widths = list(widths)
    for w in widths:
        if w < 1 or total_blocks % w:
            raise ValueError(f"width {w} does not divide {total_blocks} "
                             "blocks")
    job = {"blocks": total_blocks, "block_len": block_len, "trials": trials,
           "control_rows": max(widths)}

    def spawn(name, n, fn, **extra):
        sub = None if workdir is None else pathlib.Path(workdir, name)
        return run_ranks(n, {**job, "fn": fn, **extra}, device, share_card,
                         timeout, sub)

    local = spawn("local", 1, LOCAL_JOB, widths=widths)[0]
    out = {"total_blocks": total_blocks, "block_len": block_len,
           "physical_cores": cores, "placement": {}, "times_s": {},
           "local_ref_s": {}, "shard_parallel_efficiency": {},
           "core_normalized_efficiency": {}, "control_efficiency": {},
           "sha256": {}}
    for w in widths:
        ranks = spawn(f"w{w}", w, WIDTH_JOB)
        digests = {r["sha256"] for r in ranks}
        if digests != {local["sha256"]}:
            raise RuntimeError(f"scaling: width {w}'s compressed blocks "
                               "differ from one process's")
        t_mesh = _slowest_best(ranks, "times")
        t_local = min(local["times"][w])
        eff = t_local / t_mesh
        key = str(w)
        out["placement"][key] = placement(w, device, share_card)
        out["times_s"][key] = t_mesh
        out["local_ref_s"][key] = t_local
        out["shard_parallel_efficiency"][key] = eff
        out["core_normalized_efficiency"][key] = eff * w / min(w, cores)
        out["control_efficiency"][key] = (
            min(local["control_times"][w])
            / _slowest_best(ranks, "control_times"))
        out["sha256"][key] = local["sha256"]
    # the ratio of ratios, clamped to where the control is a valid
    # denominator (lz4_tpu/dist/scaling.py:172-184)
    out["control_relative_ratio"] = {}
    for key, raw in out["shard_parallel_efficiency"].items():
        ctrl = out["control_efficiency"][key]
        valid = ctrl and int(key) <= cores and raw <= ctrl * 1.05
        out["control_relative_ratio"][key] = (
            min(raw / ctrl, 1.0) if valid else None)
    hw = str(min(cores, max(widths)))
    out["headline_width"] = int(hw)
    out["headline_efficiency"] = out["shard_parallel_efficiency"].get(hw)
    out["headline_control_relative"] = out["control_relative_ratio"].get(hw)
    return out


def main() -> None:
    """``python -m``: :func:`measure` on the card, ranks sharing ``cuda:0``
    when there are fewer cards than the widest width."""
    widths = (1, 2, 4, 8)
    resolve_device("cuda")
    cards = torch.cuda.device_count()
    share = cards < max(widths)
    out = measure(widths=widths, share_card=share)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "cards": cards, "share_card": share, **out}))


if __name__ == "__main__":
    main()
