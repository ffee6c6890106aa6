"""What a per-layer metric's reader reads: the traced window's batches,
each ring slot's bytes, the program's launch count and the device trace;
and the arithmetic the readers share."""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import roofline
from .trace import Trace


@dataclasses.dataclass
class SlotBytes:
    """One ring slot's batch, as the program wrote or read it: blocks,
    bytes a block, compressed bytes, payload bytes (compressed, or raw
    where stored raw) and the frame body's bytes (0 on a read)."""
    n: int
    block_bytes: int
    comp_total: int
    payload_total: int = 0
    body_total: int = 0


@dataclasses.dataclass
class Context:
    slots: list[int]            # the ring slot of each batch submitted
    slot_bytes: list[SlotBytes]
    launches: int               # the program's kernel launches in them
    trace: Trace | None


def launches_per_batch(ctx: Context) -> float | None:
    if not ctx.slots:
        return None
    return ctx.launches / len(ctx.slots)


def roofline_pct(ctx: Context, calls: set[str],
                 nbytes: Callable[[SlotBytes], int]) -> float | None:
    """The least time of the batches' bytes over the device time of every
    operation launched from the spans of ``calls``, in %; None where those
    calls launched nothing."""
    if ctx.trace is None:
        return None
    device_s = ctx.trace.op_seconds(calls)
    least = sum(roofline.least_seconds(nbytes(ctx.slot_bytes[s]))
                for s in ctx.slots)
    return roofline.share_pct(least, device_s)


def idle_pct(ctx: Context) -> float | None:
    if ctx.trace is None:
        return None
    return 100.0 * ctx.trace.idle_share()
