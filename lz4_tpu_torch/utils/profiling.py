"""Profiling hooks: ``torch.profiler`` traces around the codec pipelines.

Counterpart of ``lz4_tpu/utils/profiling.py`` (``jax.profiler``).
:func:`trace` records a region, host and device, into a Chrome trace.
The program names its own parts on the host's timeline with spans,
``torch.profiler.record_function`` ranges named ``lz4tt.<name>``, which the
profiler records on the clock of the card's operations:

- :func:`part`: a part of a batch of the stream pipeline and the tier
  (``chip_smoke.py --host-split`` sums them by part);
- an entry point's whole call (``lz4tt.compress_fast_batch`` and the like);
- :func:`readback`: ``lz4tt.sync.<site>``, where the host waits for the
  card's results; it also counts the waits by site (:func:`sync_counts`).

A span is opened only while a profiler records; otherwise every one is the
same context that does nothing, so that spans cost nearly nothing with
tracing off.
"""

from __future__ import annotations

import contextlib
import functools
import os
import threading

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


PREFIX = "lz4tt."
SYNC = "sync."
_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named part of a traced region: ``torch.profiler.record_function``
    of ``name``, a span on the host's timeline, while a profiler records;
    else a context that does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


def span(name: str):
    """:func:`annotate` of ``lz4tt.<name>``."""
    return annotate(PREFIX + name)


def entry(fn):
    """``fn`` with its whole call in the span of its own name."""
    name = fn.__name__

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)

    return wrapped


# The parts of a batch that the stream pipeline and the tier name on the
# host's timeline; ``chip_smoke.py --host-split`` sums the spans by part.
PARTS = ("read", "upload", "kernels", "check", "download", "content_hash",
         "write")


def part(name: str):
    """:func:`span` for one of :data:`PARTS` (``lz4tt.<name>``)."""
    if name not in PARTS:
        raise ValueError(f"unknown part {name!r}")
    return span(name)


_syncs: dict[str, int] = {}
_syncs_lock = threading.Lock()


def readback(site: str, read: torch.Tensor | None = None):
    """The span ``lz4tt.sync.<site>``, around a read of results on the
    host that waits for the card: a tensor's values, an event or a stream.
    ``read`` is the tensor read; where it lies on a card, or is None (a
    wait on an event or a stream), the site's count goes up by one. A
    count is one entry of the site, however many values it reads."""
    if read is None or read.is_cuda:
        with _syncs_lock:
            _syncs[site] = _syncs.get(site, 0) + 1
    return span(SYNC + site)


def sync_counts() -> dict[str, int]:
    """Waits for the card so far, by :func:`readback`'s site."""
    with _syncs_lock:
        return dict(_syncs)


def reset_sync_counts() -> None:
    with _syncs_lock:
        _syncs.clear()
