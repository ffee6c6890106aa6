"""Profiling hooks: ``torch.profiler`` traces around the codec pipelines.

Counterpart of ``lz4_tpu/utils/profiling.py`` (``jax.profiler``).
:func:`trace` records a region, host and device, into a Chrome trace;
:func:`annotate` names a part of it, so that host time can be split by
part (``chip_smoke.py --host-split`` reads the spans).
"""

from __future__ import annotations

import contextlib
import os

import torch

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the enclosed region, on the host and, where this build of
    torch can trace one, the card, and write it to
    ``log_dir/trace.json`` (Chrome's trace format). Yields the
    ``torch.profiler.profile``, whose ``key_averages()`` the caller may
    read after the region."""
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=sorted(torch.profiler.supported_activities(),
                          key=lambda a: a.value))
    with prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """A named part of a traced region: ``torch.profiler.record_function``,
    a span on the host's timeline."""
    return torch.profiler.record_function(name)


# The parts of a batch that the stream pipeline and the tier name on the
# host's timeline; ``chip_smoke.py --host-split`` sums the spans by part.
PARTS = ("read", "upload", "kernels", "check", "download", "content_hash",
         "write")
PREFIX = "lz4tt."


def part(name: str):
    """:func:`annotate` for one of :data:`PARTS` (``lz4tt.<name>``)."""
    if name not in PARTS:
        raise ValueError(f"unknown part {name!r}")
    return annotate(PREFIX + name)
