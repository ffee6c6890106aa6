"""Several processes on the block axis: the process group, each process's
block range, and a dry run that spawns the ranks.

Counterpart of ``lz4_tpu/dist/multihost.py``. Every process is given the
full global block list, compresses only its own contiguous range
(:func:`process_block_range`) on its own device, and the results are
gathered in process order, which is block order, so that every process
holds the same frame. In ``torch.distributed`` a process is a rank, and
``dist/sharded.py`` already works that way, so
:func:`compress_blocks_multihost` and :func:`compress_frame_multihost` are
its functions under the JAX package's names: one code path. At one
process nothing is exchanged.

:func:`dryrun_multihost` runs the real several-process path: it spawns
the ranks as worker processes that meet through a ``file://`` rendezvous
in a temporary directory, and requires every rank's frames to be
identical. :func:`run_ranks` is the one spawner of the port: the dry run's
ranks, and the scaling modules' groups and independent workers
(``dist/multihost_scaling.py``, ``dist/scaling.py``), each a job that names
the function its workers run.
"""

from __future__ import annotations

import contextlib
import datetime
import hashlib
import importlib
import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from ..core.device import resolve_device
from ..kernels.xxhash import join_u64
from .mesh import BlockMesh, block_mesh, block_range
from .sharded import (
    _host_bytes, compress_frame_sharded, compress_frame_sharded_packed,
    shard_compress_blocks, shard_xxh64, sharded_roundtrip_step)

FRAME_BLOCK = 1 << 16
DRYRUN_SEED = 7              # the data of lz4_tpu's dryrun_multihost
HC_BYTES = 3000              # HC runs at level 9 on this much of it


def initialize(init_method: str, world_size: int, rank: int,
               backend: str | None = None,
               timeout: datetime.timedelta = datetime.timedelta(seconds=300),
               device: str | torch.device = "cuda") -> None:
    """Join the process group of ``world_size`` ranks as ``rank``, through
    ``init_method`` (``file://...`` or ``tcp://host:port``); nothing when
    ``world_size <= 1``.

    On a card, this rank's card becomes the current device: ``device``'s
    index, or ``cuda:rank`` when it names none. The backend is NCCL on a
    card and gloo on the CPU unless ``backend`` names one (gloo lets ranks
    share a card: pass ``device="cuda:0", backend="gloo"``).
    """
    if world_size <= 1:
        return
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank if dev.index is None else dev.index)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=world_size, rank=rank,
        timeout=timeout)


def process_block_range(n_blocks: int) -> tuple[int, int]:
    """[start, end) of the global blocks this process owns: contiguous
    runs of ``ceil(n_blocks / processes)``, so concatenating the outputs in
    process order gives the global order."""
    if dist.is_available() and dist.is_initialized():
        return block_range(n_blocks, dist.get_rank(), dist.get_world_size())
    return 0, n_blocks


def compress_blocks_multihost(blocks, mesh: BlockMesh | None = None,
                              level: int | None = None) -> list[bytes]:
    """Compress ``blocks`` cooperatively across all processes: each its
    own range, every process gets the whole ordered list (fast scan, or HC
    at ``level``). :func:`~.sharded.shard_compress_blocks`."""
    return shard_compress_blocks(blocks, mesh, level)


def compress_frame_multihost(data, block_size: int = FRAME_BLOCK,
                             mesh: BlockMesh | None = None,
                             content_checksum: bool = True,
                             level: int | None = None) -> bytes:
    """One byte-exact LZ4 frame of ``data``, compressed cooperatively
    across all processes; every process gets the same frame.
    :func:`~.sharded.compress_frame_sharded`."""
    return compress_frame_sharded(data, block_size, mesh, content_checksum,
                                  level)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

_WORKER = ("from lz4_tpu_torch.dist.multihost import _worker_main; "
           "_worker_main()")
DRYRUN_JOB = "lz4_tpu_torch.dist.multihost:run_job"
# what a rank's result may hold that the others' do not
_PER_RANK = ("phase_ms", "block_range")


def dryrun_data(n_bytes: int) -> bytes:
    """The dry run's input: seeded bytes of an alphabet of 5."""
    return np.random.default_rng(DRYRUN_SEED).integers(
        0, 5, n_bytes, dtype=np.uint8).tobytes()


def frame_rows(data: bytes, block_size: int = FRAME_BLOCK):
    """``data`` cut into frame blocks as ``uint8[N, block_size]`` rows (the
    last zero-padded) and their lengths."""
    n = -(-len(data) // block_size)
    rows = np.zeros((n, block_size), np.uint8)
    rows.reshape(-1)[:len(data)] = np.frombuffer(data, np.uint8)
    lens = np.full(n, block_size, np.int32)
    if n:
        lens[-1] = len(data) - (n - 1) * block_size
    return rows, lens


def run_job(mesh: BlockMesh, job: dict) -> dict:
    """What each rank of the dry run computes: the frame of
    ``dryrun_data(job["data_bytes"])`` through the listed and the packed
    sharded paths, the HC frame (level 9) of its first ``HC_BYTES``, the
    XXH64 of its frame blocks (``shard_xxh64``) and, if ``job["step"]``
    is ``(n_blocks_per_dev, block_len)``, a :func:`sharded_roundtrip_step`
    (its body, offsets and hashes as digests)."""
    data = dryrun_data(job["data_bytes"])
    rows, lens = frame_rows(data)
    hi, lo = shard_xxh64(rows, lens, 0, mesh)
    out = {
        "frame": compress_frame_multihost(data, FRAME_BLOCK, mesh),
        "packed_frame": compress_frame_sharded_packed(data, FRAME_BLOCK, mesh),
        "hc_frame": compress_frame_multihost(data[:HC_BYTES], FRAME_BLOCK,
                                             mesh, level=9),
        "xxh64": [h & (2 ** 64 - 1) for h in join_u64(hi, lo).tolist()],
    }
    if job.get("step"):
        st = sharded_roundtrip_step(mesh, *job["step"])

        def digest(t):
            return hashlib.sha256(_host_bytes(t.contiguous().view(
                torch.uint8))).hexdigest()

        out["step"] = {
            "blocks": st.ok.numel(), "ok": bool(st.ok.all()),
            "compressed_total": st.compressed_total,
            "body_total": st.body_total, "body_sha256": digest(st.body),
            "offsets_sha256": digest(st.offsets),
            "hashes_sha256": digest(st.hashes.view(torch.int32))}
        out["phase_ms"] = st.phase_ms
        out["block_range"] = st.block_range
    return out


def _pin(worker: int) -> None:
    """Pin this process to one core of its affinity set, worker ``w`` to
    the ``w``-th (``lz4_tpu/dist/multihost_scaling.py:47-51``)."""
    try:
        cores = sorted(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {cores[worker % len(cores)]})
    except (AttributeError, OSError):
        pass


def _worker_main() -> None:
    """A worker of :func:`run_ranks`: ``python -c _WORKER <spec json>``;
    runs ``spec["job"]["fn"]`` (``module:function``, the dry run's
    :func:`run_job` by default) on this rank's mesh."""
    spec = json.loads(sys.argv[1])
    print(f"worker {spec['worker']}: rank {spec['rank']} of "
          f"{spec['world_size']} on {spec['device']}, pid {os.getpid()}",
          flush=True)
    _pin(spec["worker"])
    torch.set_num_threads(1)
    module, name = spec["job"].get("fn", DRYRUN_JOB).split(":")
    job_fn = getattr(importlib.import_module(module), name)
    dev = torch.device(spec["device"])
    initialize(spec["init_method"], spec["world_size"], spec["rank"],
               spec["backend"], datetime.timedelta(seconds=spec["timeout"]),
               dev)
    try:
        result = job_fn(block_mesh(dev), spec["job"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(spec["out"], "wb") as f:
        pickle.dump(result, f)


def _placement(n: int, device, share_card: bool) -> tuple[list[str], str]:
    """Each rank's device and the backend."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ["cpu"] * n, "gloo"
    if share_card:
        return ["cuda:0"] * n, "gloo"
    cards = torch.cuda.device_count()
    if cards < n:
        raise RuntimeError(
            f"{n} ranks need {n} cards, this machine has {cards}; "
            "share_card=True puts every rank on cuda:0 (gloo collectives)")
    return [f"cuda:{r}" for r in range(n)], "nccl"


def placement(n: int, device: str | torch.device = "cuda",
              share_card: bool = False) -> str:
    """Where :func:`run_ranks` puts ``n`` ranks, in words: ``"cpu, gloo"``,
    ``"cuda:0 shared by n ranks, gloo"``, ``"one card a rank, nccl"``, or
    ``"cuda:0, one rank"``. Raises as :func:`run_ranks` does when the cards
    are too few."""
    devices, backend = _placement(n, device, share_card)
    if devices[0] == "cpu":
        return "cpu, gloo"
    if n == 1:
        return "cuda:0, one rank"
    if backend == "gloo":
        return f"cuda:0 shared by {n} ranks, gloo"
    return "one card a rank, nccl"


def barrier(mesh: BlockMesh) -> None:
    """Wait for every rank of ``mesh``'s group; nothing without one."""
    if mesh.group is None:
        return
    if mesh.backend == "nccl":
        dist.barrier(mesh.group, device_ids=[mesh.device.index])
    else:
        dist.barrier(mesh.group)


def _tail(path: pathlib.Path, limit: int = 6000) -> str:
    text = path.read_text(errors="replace") if path.exists() else ""
    return text[-limit:]


def run_ranks(n: int, job: dict, device: str | torch.device = "cuda",
              share_card: bool = False, timeout: float = 300.0,
              workdir=None, group: bool = True) -> list[dict]:
    """Run ``job`` on ``n`` worker processes, one a rank, and return each
    worker's result in rank order.

    ``job["fn"]`` names what each worker runs, ``"module:function"``
    called as ``function(mesh, job)`` with the worker's
    :class:`~.mesh.BlockMesh`; without it the dry run's :func:`run_job`.
    With ``group=False`` the workers are ``n`` independent processes,
    each a world of one rank: no process group, no exchange. Worker ``w``
    is pinned to the ``w``-th core of the caller's affinity set.

    On ``device="cuda"`` rank r runs on ``cuda:r`` over NCCL, and fewer
    than ``n`` cards is an error unless ``share_card``, which puts every
    rank on ``cuda:0`` with gloo collectives; ``device="cpu"`` runs gloo
    on the plain versions. The ranks meet through a ``file://`` rendezvous
    in ``workdir`` (a new temporary directory by default); each writes its
    output to ``rank<r>.log`` there. A worker that fails raises
    ``RuntimeError`` with its log; so do the workers still running after
    ``timeout`` seconds (one stuck in a barrier whose peer hangs), each
    with its log. Every worker is killed and reaped before this returns or
    raises.
    """
    devices, backend = _placement(n, device, share_card)
    what = job.get("fn", DRYRUN_JOB).split(":")[1]
    root = str(pathlib.Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    with contextlib.ExitStack() as stack:
        if workdir is None:
            workdir = stack.enter_context(tempfile.TemporaryDirectory())
        work = pathlib.Path(workdir)
        work.mkdir(parents=True, exist_ok=True)
        init = (work / "rendezvous").resolve().as_uri()
        logs = [work / f"rank{r}.log" for r in range(n)]
        outs = [work / f"rank{r}.pkl" for r in range(n)]
        procs = []
        try:
            for r in range(n):
                spec = {"worker": r, "rank": r if group else 0,
                        "world_size": n if group else 1,
                        "device": devices[r], "backend": backend,
                        "init_method": init, "timeout": timeout, "job": job,
                        "out": str(outs[r])}
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-c", _WORKER, json.dumps(spec)],
                        stdout=log, stderr=subprocess.STDOUT, env=env))
            deadline = time.monotonic() + timeout
            while True:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    raise RuntimeError(f"{what}: " + "\n".join(
                        f"rank {r} failed (exit {codes[r]}):\n"
                        f"{_tail(logs[r])}" for r in bad))
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    late = [r for r, c in enumerate(codes) if c is None]
                    raise RuntimeError(f"{what}: rank(s) {late} still "
                                       f"running after {timeout} s, killed:\n"
                                       + "\n".join(f"rank {r}:\n"
                                                   f"{_tail(logs[r])}"
                                                   for r in late))
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
    return results


def dryrun(n: int, job: dict, device: str | torch.device = "cuda",
           share_card: bool = False, timeout: float = 300.0,
           workdir=None) -> dict:
    """:func:`run_ranks`, then require every rank's result to be the same
    (what is per rank aside) and every step block OK; returns rank 0's
    result with ``phase_ms`` and ``block_range`` as lists by rank."""
    results = run_ranks(n, job, device, share_card, timeout, workdir)
    common = [{k: v for k, v in r.items() if k not in _PER_RANK}
              for r in results]
    for r in range(1, n):
        if common[r] != common[0]:
            diff = sorted(k for k in common[0] if common[r].get(k)
                          != common[0][k])
            raise RuntimeError(f"dry run: rank {r} differs from rank 0 in "
                               f"{diff}")
    if "step" in common[0] and not common[0]["step"]["ok"]:
        raise RuntimeError(f"dry run: sharded roundtrip failed: "
                           f"{common[0]['step']}")
    out = dict(common[0])
    for key in _PER_RANK:
        if key in results[0]:
            out[key] = [r[key] for r in results]
    return out


def dryrun_multihost(nproc: int = 2, data_bytes: int = 3 * 65536 + 1234,
                     device: str | torch.device = "cuda",
                     share_card: bool = False, timeout: float = 300.0,
                     workdir=None):
    """The real several-process path: ``nproc`` ranks run
    ``compress_frame_multihost`` on ``dryrun_data(data_bytes)`` (fast, and
    HC at level 9 on its first ``HC_BYTES``), and every rank's frames must
    be identical. Returns ``(frame, hc_frame)``. At ``nproc=4`` and 5
    blocks the ranges are ``[0,2),[2,4),[4,5),[5,5)``: uneven, one empty."""
    out = dryrun(nproc, {"data_bytes": data_bytes}, device, share_card,
                 timeout, workdir)
    return out["frame"], out["hc_frame"]
