"""Measurement and buffer helpers: the counterpart of ``lz4_tpu/utils``
(``profiling``, ``timing``, ``buffers``) on ``torch.profiler`` and CUDA
events, and ``config``, the port's environment knobs."""

from .buffers import as_bytes, chunk_bytes
from .profiling import annotate, part, trace
from .timing import DeviceTimer, median_throughput

__all__ = ["DeviceTimer", "annotate", "as_bytes", "chunk_bytes",
           "median_throughput", "part", "trace"]
