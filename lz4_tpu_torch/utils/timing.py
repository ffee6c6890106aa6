"""Measurement helpers (``lz4_tpu/utils/timing.py``).

:func:`median_throughput` keeps the JAX contract: at least two distinct
inputs, a warm-up call first, the median over the rest. On the card ``fn``
must synchronise before it returns (``torch.cuda.synchronize()``), or the
host clock measures only the launches.
"""

from __future__ import annotations

import statistics
import time

import torch


def median_throughput(fn, inputs, bytes_per_call: int, warmup=None) -> float:
    """Median GB/s of ``fn(x)`` over each distinct ``x`` of ``inputs``
    after the first; ``warmup`` (default: the first input) is run once
    before the timed calls."""
    if len(inputs) < 2:
        raise ValueError("need >= 2 distinct inputs")
    fn(warmup if warmup is not None else inputs[0])
    times = []
    for x in inputs[1:]:
        t0 = time.perf_counter()
        fn(x)
        times.append(time.perf_counter() - t0)
    return bytes_per_call / statistics.median(times) / 1e9


class DeviceTimer:
    """Named spans, summed over every entry: host wall in ``spans``
    (seconds).

    The port's own addition to the JAX class: ``section(name, stream)``
    also records CUDA events on ``stream`` around the span, and
    :meth:`device_spans` sums the card's time between them (milliseconds),
    synchronising on the events first.
    """

    def __init__(self):
        self.spans: dict[str, float] = {}
        self._events: dict[str, list] = {}

    def section(self, name: str, stream: torch.cuda.Stream | None = None):
        timer = self

        class _Span:
            def __enter__(self):
                if stream is not None:
                    self._start = torch.cuda.Event(enable_timing=True)
                    self._start.record(stream)
                self._t0 = time.perf_counter()
                return self

            def __exit__(self, *exc):
                timer.spans[name] = (timer.spans.get(name, 0.0)
                                     + time.perf_counter() - self._t0)
                if stream is not None:
                    end = torch.cuda.Event(enable_timing=True)
                    end.record(stream)
                    timer._events.setdefault(name, []).append(
                        (self._start, end))
                return False

        return _Span()

    def device_spans(self) -> dict[str, float]:
        """Milliseconds of the card's stream between each section's
        events, summed by name."""
        out = {}
        for name, pairs in self._events.items():
            for start, end in pairs:
                end.synchronize()
                out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out

    def report(self) -> str:
        text = ", ".join(f"{k}={v * 1e3:.1f}ms" for k, v in self.spans.items())
        device = self.device_spans()
        if device:
            text += "; on the card: " + ", ".join(
                f"{k}={v:.3f}ms" for k, v in device.items())
        return text
