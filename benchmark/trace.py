"""Spans around the benchmark's calls into the program, and the reading of
the device trace that ``torch.profiler`` takes of a traced window.

A span is a ``torch.profiler.record_function`` named ``bench.<call>``,
opened by the benchmark's own code around each call into the program
(``bench.window`` spans the measured window). In the trace every device
operation (kernel, copy, set) carries the correlation id of the runtime
call that launched it, and that call's host time lies inside the span
around the program call that made it, whatever the kernel is named. So an
operation is charged to the span around its launch, and the
device's idle time to the spans the host was inside meanwhile.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

PREFIX = "bench."
WINDOW = PREFIX + "window"
HARNESS = "harness"      # idle time while the host was in no call's span
BREAKDOWN_ENTRIES = 10


def spans(enabled: bool):
    """``span(name)``: a ``record_function`` named ``bench.<name>`` when
    ``enabled``, else a context that does nothing."""
    if not enabled:
        return lambda name: contextlib.nullcontext()
    import torch

    return lambda name: torch.profiler.record_function(PREFIX + name)


@dataclasses.dataclass(frozen=True)
class Interval:
    name: str
    start: int      # ns, on the profiler's clock
    end: int


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: int
    end: int
    span: str | None    # the call it was launched from, None outside all


def union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """The merged union of ``(start, end)`` intervals, in order."""
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class _SpanIndex:
    """The calls' spans of one caller, which follow one another without
    overlapping: which one a host time lies in."""

    def __init__(self, calls: list[Interval]):
        self.calls = sorted(calls, key=lambda s: s.start)
        self.starts = [s.start for s in self.calls]

    def at(self, t: int) -> str | None:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.calls[i].end:
            return self.calls[i].name
        return None

    def cover(self, t0: int, t1: int) -> list[tuple[str, int]]:
        """How ``[t0, t1)`` splits over the calls' spans, in ns, the time
        outside every span as :data:`HARNESS`. The spans of one caller do
        not overlap."""
        out: dict[str, int] = {}
        i = max(0, bisect.bisect_right(self.starts, t0) - 1)
        j = bisect.bisect_left(self.starts, t1)
        inside = 0
        for s in self.calls[i:j]:
            d = min(s.end, t1) - max(s.start, t0)
            if d > 0:
                out[s.name] = out.get(s.name, 0) + d
                inside += d
        if t1 - t0 > inside:
            out[HARNESS] = out.get(HARNESS, 0) + t1 - t0 - inside
        return list(out.items())


class Trace:
    """One traced window: its length, the device operations in it with the
    call each was launched from, and the idle gaps between them."""

    def __init__(self, window: Interval, calls: list[Interval],
                 ops: list[tuple[str, int, int, int | None]]):
        """``calls``: the spans of the calls (not the window);
        ``ops``: (name, start, end, host launch time or None)."""
        self.window = window
        index = _SpanIndex(calls)
        self.index = index
        self.ops = [DeviceOp(name, s, e,
                             index.at(t) if t is not None else None)
                    for name, s, e, t in ops]

    @property
    def window_s(self) -> float:
        return (self.window.end - self.window.start) / 1e9

    def _clipped(self) -> list[tuple[int, int]]:
        w0, w1 = self.window.start, self.window.end
        return [(max(o.start, w0), min(o.end, w1)) for o in self.ops
                if o.end > w0 and o.start < w1]

    def busy(self) -> list[tuple[int, int]]:
        """The union of the device's operations within the window."""
        return union(self._clipped())

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def idle_share(self) -> float:
        return 1.0 - self.busy_s / self.window_s

    def op_seconds(self, calls: set[str]) -> float:
        """Device seconds of the operations launched from spans named in
        ``calls`` (all of them, wherever they ran)."""
        return sum(o.end - o.start for o in self.ops if o.span in calls) / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """The window's idle intervals."""
        out, t = [], self.window.start
        for s, e in self.busy():
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.window.end > t:
            out.append((t, self.window.end))
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time in the window, by
        name, and the idle time by the call the host was inside meanwhile;
        at most ten of each, in seconds."""
        w0, w1 = self.window.start, self.window.end
        by_op: dict[str, float] = {}
        for o in self.ops:
            d = min(o.end, w1) - max(o.start, w0)
            if d > 0:
                by_op[o.name] = by_op.get(o.name, 0.0) + d / 1e9
        by_call: dict[str, float] = {}
        for s, e in self.gaps():
            for name, d in self.index.cover(s, e):
                by_call[name] = by_call.get(name, 0.0) + d / 1e9

        def top(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                    [:BREAKDOWN_ENTRIES]]

        return {"device_ops": top(by_op), "idle_gaps": top(by_call)}


def from_profiler(prof) -> Trace:
    """A :class:`Trace` of a ``torch.profiler.profile`` that recorded one
    ``bench.window``, from its events in memory (nothing is written)."""
    window, calls, ops = None, [], []
    launch_at: dict[int, int] = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_host = str(e.device_type()).endswith("CPU")
        if e.is_user_annotation() or name.startswith(PREFIX):
            if on_host and name.startswith(PREFIX):
                iv = Interval(name[len(PREFIX):], e.start_ns(), e.end_ns())
                if name == WINDOW:
                    window = iv
                else:
                    calls.append(iv)
            continue
        if on_host:
            # the runtime's launches and copies carry the correlation id
            # of the device operation they started
            if name.startswith("cu") and e.correlation_id():
                launch_at.setdefault(e.correlation_id(), e.start_ns())
        else:
            ops.append((name, e.start_ns(), e.end_ns(), e.correlation_id()))
    if window is None:
        raise RuntimeError("the trace holds no bench.window span")
    return Trace(window, calls,
                 [(n, s, t, launch_at.get(c)) for n, s, t, c in ops])
