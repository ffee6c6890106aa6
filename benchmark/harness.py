"""One run of one cell: set-up, the measured window, the traced window's
per-layer metrics, and the check of what the window produced. What a batch
does, and what the check compares, is the cell's pipeline's
(``pipelines/<name>.py``); this module drives any of them.

The loop is closed, with one caller: batches are drawn in turn from a ring
of distinct batches made on the device from the seed, and the caller
submits batch i+1 before it waits for batch i (``in_flight`` batches at
most). A batch counts in the window when it completes inside it. On the
card a batch's time runs from an event that the host records on a side
stream nothing else uses, which the card stamps as the host submits, to an
event after the batch's last operation: device timestamps, where the
host's clock would be off by about half a millisecond a reading.
"""

from __future__ import annotations

import collections
import dataclasses
import subprocess
import sys
import time

import numpy as np
import torch

from . import check, data, layers, trace
from .cells import Cell, metric_reader, pipeline
from .system import Port

FORBIDDEN = ("jax", "jaxlib", "flax", "lz4_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Top-level names of loaded modules (of ``names``, by default
    ``sys.modules``) that the benchmark must not load, compared whole
    (``lz4_tpu_torch`` is not ``lz4_tpu``)."""
    tops = {name.split(".")[0] for name in list(
        sys.modules if names is None else names)}
    return sorted(tops.intersection(FORBIDDEN))


class CudaClock:
    def __init__(self, device: torch.device):
        self.device = device
        self.side = torch.cuda.Stream(device)

    def event(self, side: bool = False):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(self.side if side else torch.cuda.current_stream(self.device))
        return ev

    @staticmethod
    def wait(ev) -> None:
        ev.synchronize()

    @staticmethod
    def ms(a, b) -> float:
        return a.elapsed_time(b)

    def sync(self) -> None:
        torch.cuda.synchronize(self.device)


class HostClock:
    """Batch times on the host, for runs of the plain versions on the CPU
    (the benchmark's tests)."""

    @staticmethod
    def event(side: bool = False) -> float:
        return time.perf_counter()

    @staticmethod
    def wait(ev) -> None:
        pass

    @staticmethod
    def ms(a, b) -> float:
        return (b - a) * 1e3

    @staticmethod
    def sync() -> None:
        pass


@dataclasses.dataclass
class Record:
    index: int
    slot: int
    held: bool
    ev_submit: object
    ev_done: object
    out: dict | None
    t_done: float = float("inf")
    ms: float = float("nan")
    verdict: np.ndarray | None = None


@dataclasses.dataclass
class Ring:
    src: list[torch.Tensor]          # raw rows of each slot
    lens: torch.Tensor               # int32[N], every block full


class Caller:
    """The one caller of the closed loop, drawing batches in turn from the
    ring."""

    def __init__(self, pipe, clock, n_slots: int, in_flight: int, span,
                 on_done=None):
        self.pipe, self.clock, self.span = pipe, clock, span
        self.n_slots, self.in_flight = n_slots, in_flight
        self.on_done = on_done
        self.records: list[Record] = []
        self.pending: collections.deque = collections.deque()

    def _complete(self, rec: Record) -> None:
        with self.span("wait"):
            self.clock.wait(rec.ev_done)
        rec.t_done = time.perf_counter()
        rec.ms = self.clock.ms(rec.ev_submit, rec.ev_done)
        rec.verdict = self.pipe.finish(rec.out)
        if self.on_done is not None:
            self.on_done(rec)
        if not rec.held:
            rec.out = None

    def submit(self, held: bool) -> None:
        i = len(self.records)
        slot = i % self.n_slots
        ev0 = self.clock.event(side=True)
        out = self.pipe.submit(slot)
        ev1 = self.clock.event()
        rec = Record(i, slot, held, ev0, ev1, out)
        self.records.append(rec)
        self.pending.append(rec)
        if len(self.pending) >= self.in_flight:
            self._complete(self.pending.popleft())

    def run_until(self, t_end: float, hold_at: list[float]) -> None:
        """Submit until the host clock reaches ``t_end``; the first batch
        submitted at or after each time of ``hold_at`` is held."""
        holds = sorted(hold_at)
        while True:
            t = time.perf_counter()
            if t >= t_end:
                return
            held = bool(holds) and t >= holds[0]
            if held:
                holds.pop(0)
            self.submit(held)

    def drain(self) -> None:
        while self.pending:
            self._complete(self.pending.popleft())


def percentile(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


def window_values(records: list[Record], t_end: float, seconds: float,
                  batch_bytes) -> dict:
    """The window's rate (GB/s: the bytes of every batch that completed
    in it, ``batch_bytes(slot)`` each, over its whole length), and the
    median and 95th percentile of those batches' times (ms), with their
    count."""
    done = [r for r in records if r.t_done <= t_end]
    lat = [r.ms for r in done]
    nbytes = sum(batch_bytes(r.slot) for r in done)
    return {"rate": nbytes / seconds / 1e9,
            "count": len(lat),
            "median": percentile(lat, 50) if lat else float("nan"),
            "p95": percentile(lat, 95) if lat else float("nan")}


def power_limit() -> str | None:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


@dataclasses.dataclass
class Run:
    """What one run found: the result's keys, and the lines for standard
    error."""
    result: dict
    notes: list[str]


def setup_phases(marks: list[tuple[str, float]], t_start: float) -> str:
    """Each phase of set-up with its seconds, as the line on standard
    error reads them."""
    out, t = [], t_start
    for name, at in marks:
        out.append(f"{name} {at - t:.3f}")
        t = at
    return "set-up phases (s): " + ", ".join(out)


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float, port: Port | None = None,
        overrides: dict | None = None, n_workers: int | None = None,
        marks: list[tuple[str, float]] | None = None) -> Run:
    """Run ``cell`` once on ``device`` for ``seconds``, from ``seed``;
    with ``traced``, under ``torch.profiler``, reporting the per-layer
    metrics. ``port`` replaces the program (the tests plant faults in it),
    ``overrides`` changes its configuration (the control), ``n_workers``
    sets the reference's worker processes; ``t_start`` is when the process
    started, on ``time.perf_counter``'s clock, and ``marks`` the set-up
    phases the caller timed before this call."""
    cfg, tr = cell.config, cell.traffic
    if tr["loop"] != "closed" or tr["callers"] != 1:
        raise ValueError(f"traffic {tr['name']!r}: only a closed loop with "
                         "one caller is driven")
    marks = list(marks or [])
    port = port or Port(cfg, overrides)
    marks.append(("program", time.perf_counter()))
    on_card = device.type == "cuda"
    clock = CudaClock(device) if on_card else HostClock()
    span = trace.spans(traced)
    rng = np.random.default_rng(seed % 2 ** 64)
    hold_fracs = sorted(rng.uniform(0.05, 0.85, tr["held_batches"]))
    notes = []

    # -- set-up: the ring, the pipeline's own set-up, the warm-up ----------
    L = cfg["block_bytes"]
    n = cfg["batch_blocks"][tr["pipeline"]]
    n_slots = tr["ring_batches"]
    g = data.generator(seed, device)
    stride = port.row_stride(L)
    ring = Ring([data.make_batch(n, L, stride, g, device)[0]
                 for _ in range(n_slots)],
                torch.full((n,), L, dtype=torch.int32, device=device))
    clock.sync()
    marks.append(("ring", time.perf_counter()))
    pipe = pipeline(cell)(port, cfg, ring, span)
    clock.sync()
    marks.append(("pipeline", time.perf_counter()))
    # every shape the window uses, each slot at least once, and as many
    # batches held as the window holds, so that the allocator has grown to
    # the window's needs
    slot_bytes: dict[int, layers.SlotBytes] = {}

    def measure(rec: Record) -> None:
        if rec.slot not in slot_bytes:
            slot_bytes[rec.slot] = pipe.slot_bytes(rec.out, rec.slot)

    caller = Caller(pipe, clock, n_slots, tr["in_flight"], span, measure)
    for i in range(n_slots + tr["held_batches"] + tr["in_flight"]):
        caller.submit(held=i < tr["held_batches"])
    caller.drain()
    slot_bytes = [slot_bytes[s] for s in range(n_slots)]
    del caller
    clock.sync()
    launches0 = port.launches()
    marks.append(("warm-up", time.perf_counter()))

    # -- the window ---------------------------------------------------------
    prof = None
    if traced:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    caller = Caller(pipe, clock, n_slots, tr["in_flight"], span)
    t0 = time.perf_counter()
    setup_s = t0 - t_start
    t_end = t0 + seconds
    with span("window"):
        caller.run_until(t_end, [t0 + f * seconds for f in hold_fracs])
    caller.drain()
    if prof is not None:
        prof.stop()
    launches = port.launches() - launches0
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0

    records = caller.records
    done = [r for r in records if r.t_done <= t_end]
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": (torch.cuda.get_device_name(device) if on_card
                            else "cpu"),
                   "count": cell.chips if on_card else 0,
                   "memory_peak_bytes": int(peak)}
    w = window_values(records, t_end, seconds, pipe.batch_bytes)
    notes.append(setup_phases(marks, t_start))
    notes.append(f"batches in the window {w['count']}, batch median "
                 f"{w['median']!r} ms, p95 {w['p95']!r} ms, submitted "
                 f"{len(records)}")
    metrics, breakdown = {}, None
    if traced:
        tr_data = trace.from_profiler(prof) if on_card else None
        del prof
        ctx = layers.Context([r.slot for r in records], slot_bytes, launches,
                             tr_data)
        for m in cell.per_layer:
            value = metric_reader(m["name"], cell.root)(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if tr_data is not None:
            device_info["busy_s"] = tr_data.busy_s
            device_info["window_s"] = tr_data.window_s
            breakdown = tr_data.breakdown()
    else:
        values = {tr["rate_metric"]: w["rate"], "batch_p95_ms": w["p95"],
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            if m["name"] not in values:
                raise KeyError(f"cell {cell.name} reports {m['name']}, which "
                               f"the {tr['pipeline']!r} pipeline does not "
                               "measure")
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    if on_card:
        limit = power_limit()
        if limit:
            notes.append(f"card {limit}")

    # -- the check, once the window has closed and its state is freed ----
    t_check = time.perf_counter()
    held = [pipe.to_host(r.out) | {"index": r.index, "slot": r.slot}
            if r.t_done <= t_end else None for r in records if r.held]
    for r in records:
        r.out = None
    raw: dict[int, np.ndarray] = {}

    def raw_rows(slot: int) -> np.ndarray:
        if slot not in raw:
            raw[slot] = ring.src[slot].cpu().numpy()
        return raw[slot]

    verdict = pipe.judge(raw_rows, held, done, rng,
                         check.workers() if n_workers is None else n_workers)
    if not done:
        verdict.count("missing", 1)
    notes.append(f"the check took {time.perf_counter() - t_check:.1f} s")
    result = {"correct": verdict.correct,
              "attempted": sum(pipe.batch_bytes(r.slot) for r in done) // L,
              "failed": len(verdict.bad),
              "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["compared"] = verdict.compared()
    return Run(result, notes)
