"""Environment-variable configuration of the port, in one place.

The counterpart of ``lz4_tpu/utils/config.py``. The port's knobs, both read
by ``kernels/build.py``:

===========================  =================================================
``LZ4_TPU_TORCH_BUILD_DIR``  where the kernels' libraries are built, one
                             directory a source digest under it (default
                             ``build/lz4_tpu_torch`` beside the package)
``CUDA_HOME``                the CUDA toolkit whose ``bin/nvcc`` builds them
                             when no ``nvcc`` is on ``PATH`` (default
                             ``/usr/local/cuda``)
===========================  =================================================

The JAX package's knobs that have no counterpart, and why none is made up:

- ``TPULZ4_DEFAULT_TIER``: the port has one tier, ``cuda``; the device is
  an argument of each entry point (``device="cpu"`` for the plain
  versions).
- ``TPULZ4_NO_NATIVE``, ``TPULZ4_CXX`` and ``TPULZ4_NATIVE_DIR``: the port
  builds no host library; its kernels need ``nvcc`` and are the device
  path itself.
- ``TPULZ4_NO_JAX_CACHE`` and ``TPULZ4_JAX_CACHE_DIR``: there is no XLA
  compile; a kernel library is built once a source digest and kept in the
  build directory.
- ``GRAFT_DRYRUN_REAL``: ``dryrun_multigpu`` takes its device and whether
  its ranks share a card as arguments.
"""

from __future__ import annotations

import os
import pathlib

DEFAULT_CUDA_HOME = "/usr/local/cuda"


def build_root() -> pathlib.Path | None:
    """``LZ4_TPU_TORCH_BUILD_DIR``, or None for the default."""
    root = os.environ.get("LZ4_TPU_TORCH_BUILD_DIR")
    return pathlib.Path(root) if root else None


def cuda_home() -> pathlib.Path:
    """``CUDA_HOME``, or the toolkit's usual place."""
    return pathlib.Path(os.environ.get("CUDA_HOME", DEFAULT_CUDA_HOME))
