"""tpu-lz4 on PyTorch and CUDA: the device codec of ``lz4_tpu`` with
hand-written Hopper kernels.

Imports ``torch`` and ``numpy``, never ``jax`` or ``lz4_tpu``. Entry points
run on the card (``device="cuda"``) unless the caller passes
``device="cpu"``, which runs the kernels' plain versions; a missing card is
an error. Kernels are built with ``nvcc`` at first use.

``Lz4Factory.cuda_instance()`` and ``XXHashFactory.cuda_instance()`` give
the lz4-java style codec and hash objects of the ``cuda`` tier;
``lz4_tpu_torch.dist`` splits blocks over the ranks of a
``torch.distributed`` group, and ``dryrun_multigpu(n)`` runs it on ``n``
spawned ranks.
"""

from .api.factory import Lz4Factory, XXHashFactory
from .dist.sharded import compress_frame_packed, roundtrip_step
from .entry import dryrun_multigpu, entry
from .kernels.codec import (
    compress_fast_batch, decompress_fast_batch, decompress_safe_batch)
from .kernels.xxhash import xxh32_batch, xxh64_batch

__all__ = ["Lz4Factory", "XXHashFactory", "compress_fast_batch",
           "compress_frame_packed", "decompress_fast_batch",
           "decompress_safe_batch", "dryrun_multigpu", "entry",
           "roundtrip_step", "xxh32_batch", "xxh64_batch"]
