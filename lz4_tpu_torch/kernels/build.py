"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/lz4_tpu_torch/<source-hash>/`` beside the package (or under
``$LZ4_TPU_TORCH_BUILD_DIR``; ``utils/config.py`` has the knobs). All sources build at once, one ``nvcc`` each,
in parallel; a file lock keeps concurrent processes from building together.
The libraries are loaded with ``ctypes``. Every C entry point returns
``cudaGetLastError()`` after its launch, and :class:`Kernel` raises if it is
not 0.

Each library links ``nvcc``'s static CUDA runtime, so each keeps its own
current device for each host thread. Every library exports
``lz4tt_set_device`` (``csrc/lz4tt_device.cuh``); a launch names its card,
and runs under torch's device guard for that card after the library's
current device has been set to it (:func:`_set_device`), so that a rank on
``cuda:k`` launches on ``cuda:k``.

Modelled on ``lz4_tpu/native/build.py``; nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading

import torch

from ..utils import config
from .layout import cuda_stream

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class KernelBuildError(RuntimeError):
    pass


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> pathlib.Path:
    base = config.build_root() or CSRC.parent.parent / "build" / "lz4_tpu_torch"
    return base / source_digest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = config.cuda_home() / "bin" / "nvcc"
    if not path.exists():
        raise KernelBuildError("nvcc not found (set CUDA_HOME or PATH)")
    return str(path)


@functools.cache
def build_all() -> dict[str, pathlib.Path]:
    """Compile every ``csrc/*.cu`` that is not built yet; return name -> .so.

    ``nvcc``'s report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<name>.log``.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {p.stem: out_dir / f"lib{p.stem}.so" for p in sources()}
    with open(out_dir / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        todo = [p for p in sources() if not libs[p.stem].exists()]
        if todo:
            nvcc = _nvcc()
            procs = []
            for p in todo:
                tmp = out_dir / f"lib{p.stem}.tmp.so"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(p)]
                procs.append((p, tmp, cmd, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
            failed = []
            for p, tmp, cmd, proc in procs:
                log, _ = proc.communicate()
                (out_dir / f"{p.stem}.log").write_text(log)
                if proc.returncode != 0:
                    failed.append(f"{' '.join(cmd)}\n{log}")
                else:
                    os.replace(tmp, libs[p.stem])
            if failed:
                raise KernelBuildError("nvcc failed:\n" + "\n".join(failed))
    return libs


@functools.cache
def _library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_all()[name]))


_current = threading.local()


def _set_device(source: str, device: int) -> None:
    """Make card ``device`` the current device of ``source``'s library on
    this thread, unless it was the last one set there."""
    table = _current.__dict__.setdefault("device", {})
    if table.get(source) == device:
        return
    fn = _library(source).lz4tt_set_device
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    rc = fn(device)
    if rc != 0:
        raise RuntimeError(f"lz4tt_set_device({device}) in {source}: "
                           f"CUDA error {rc}")
    table[source] = device


class Kernel:
    """One C entry point of one ``csrc/<source>.cu``, with a launch count.

    ``launches`` goes up by one for every call of the kernel, and only
    there, so a run can show that its main path went through the kernel.
    """

    registry: list["Kernel"] = []

    def __init__(self, name: str, source: str, symbol: str, argtypes: list):
        self.name = name
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        Kernel.registry.append(self)

    def __call__(self, *args, device: int) -> None:
        """Launch on card ``device`` (the index of the tensors' card)."""
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            _set_device(self.source, device)
            rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1


def c_function(source: str, symbol: str, argtypes: list,
               device: int | None = 0):
    """The C function ``symbol`` of ``csrc/<source>.cu``, returning int,
    with no launch count: for measurements beside the kernels. Each call
    runs on card ``device`` as a launch does; ``None`` for a function that
    uses no card."""
    fn = getattr(_library(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    if device is None:
        return fn

    def on_card(*args):
        with torch.cuda.device(device):
            _set_device(source, device)
            return fn(*args)

    return on_card


def occupancy(source: str, symbol: str,
              device: int = 0) -> tuple[int, int]:
    """(resident CTAs per SM, threads per CTA) of a kernel of
    ``csrc/<source>.cu`` on card ``device``, from its C entry point
    ``symbol``; no launch."""
    fn = c_function(source, symbol, [ctypes.POINTER(ctypes.c_int)] * 2,
                    device)
    ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(ctypes.byref(ctas), ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")
    return ctas.value, threads.value


@functools.cache
def resident_ctas(source: str, symbol: str, device: int = 0) -> int:
    """CTAs of a kernel of ``csrc/<source>.cu`` that card ``device`` holds
    at once: its resident CTAs per SM (:func:`occupancy`) times the SMs."""
    ctas, _ = occupancy(source, symbol, device)
    return ctas * torch.cuda.get_device_properties(device).multi_processor_count


# The most scratch one launch takes (fewer teams, each looping over more
# blocks, when rows are so wide that a wave of them would need more), and
# the most a Scratch keeps between calls: a 4096 x 64 KiB wave of K7 or K8
# fits, 4 MiB rows and K6's 4096 teams do not.
SCRATCH_BUDGET = 4 << 30
SCRATCH_KEEP = 512 << 20


class Scratch:
    """A kernel's scratch on the card, a slice a team: one tensor a card and
    CUDA stream, grown to what a launch asks for and kept between calls up
    to ``SCRATCH_KEEP`` bytes, so that such a call allocates nothing. A
    larger one is the launch's own and goes back to PyTorch's allocator
    when the wrapper returns. Launches on one stream run in order, so they
    share it; a buffer it replaces or drops is freed in that stream's
    order too. ``budget`` (bytes, None for none) caps a launch's scratch
    by its teams."""

    def __init__(self, dtype: torch.dtype, budget: int | None = SCRATCH_BUDGET):
        self.dtype = dtype
        self.budget = budget
        self.last_nbytes = 0
        self._bufs: dict[tuple[int, int], torch.Tensor] = {}
        self._lock = threading.Lock()

    def teams(self, t: torch.Tensor, n: int, resident: int,
              per_team: int) -> tuple[int, torch.Tensor]:
        """Teams for ``n`` blocks on ``t``'s card (at most ``resident``, and
        within the budget at ``per_team`` elements a team), and their
        scratch for its current stream."""
        teams = min(n, resident)
        if self.budget is not None:
            teams = min(teams, self.budget // (self.dtype.itemsize * per_team))
        teams = max(1, teams)
        return teams, self.take(t, teams * per_team)

    def take(self, t: torch.Tensor, numel: int) -> torch.Tensor:
        """At least ``numel`` elements on ``t``'s card, for its current
        stream."""
        key = (t.device.index, cuda_stream(t))
        with self._lock:
            buf = self._bufs.get(key)
            if buf is None or buf.numel() < numel:
                buf = torch.empty((numel,), dtype=self.dtype, device=t.device)
                if buf.numel() * buf.element_size() <= SCRATCH_KEEP:
                    self._bufs[key] = buf
            self.last_nbytes = buf.numel() * buf.element_size()
            return buf

    def nbytes(self) -> int:
        """Bytes kept between calls."""
        return sum(b.numel() * b.element_size() for b in self._bufs.values())

    def clear(self) -> None:
        with self._lock:
            self._bufs.clear()


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in Kernel.registry}


def reset_launch_counts() -> None:
    for k in Kernel.registry:
        k.launches = 0
