"""Build, load and launch the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, at first use, into
``build/lz4_tpu_torch/<source-hash>/`` beside the package (or
``$LZ4_TPU_TORCH_BUILD_DIR``). All sources build at once, one ``nvcc`` each,
in parallel; a file lock keeps concurrent processes from building together.
The libraries are loaded with ``ctypes``. Every C entry point returns
``cudaGetLastError()`` after its launch, and :class:`Kernel` raises if it is
not 0.

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
    root = os.environ.get("LZ4_TPU_TORCH_BUILD_DIR")
    base = (pathlib.Path(root) if root
            else CSRC.parent.parent / "build" / "lz4_tpu_torch")
    return base / source_digest()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
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

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(_library(self.source), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        rc = self._fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc} at launch")
        self.launches += 1


def c_function(source: str, symbol: str, argtypes: list):
    """The C function ``symbol`` of ``csrc/<source>.cu``, returning int,
    with no launch count: for measurements beside the kernels."""
    fn = getattr(_library(source), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def occupancy(source: str, symbol: str) -> tuple[int, int]:
    """(resident CTAs per SM, threads per CTA) of a kernel of
    ``csrc/<source>.cu``, from its C entry point ``symbol``; no launch."""
    fn = c_function(source, symbol, [ctypes.POINTER(ctypes.c_int)] * 2)
    ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
    rc = fn(ctypes.byref(ctas), ctypes.byref(threads))
    if rc != 0:
        raise RuntimeError(f"{symbol}: CUDA error {rc}")
    return ctas.value, threads.value


def launch_counts() -> dict[str, int]:
    return {k.name: k.launches for k in Kernel.registry}


def reset_launch_counts() -> None:
    for k in Kernel.registry:
        k.launches = 0
