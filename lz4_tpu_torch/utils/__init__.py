"""Measurement and buffer helpers: the counterpart of ``lz4_tpu/utils``
(``profiling``, ``buffers``) on ``torch.profiler``, the program's own
spans and read-back counts, and ``config``, the port's environment
knobs."""

from .buffers import as_bytes, chunk_bytes
from .profiling import (
    annotate, part, readback, reset_sync_counts, span, sync_counts, trace)

__all__ = ["annotate", "as_bytes", "chunk_bytes", "part", "readback",
           "reset_sync_counts", "span", "sync_counts", "trace"]
