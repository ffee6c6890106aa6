"""The metric arithmetic on synthetic batch times and spans."""

import math

import pytest

from benchmark import harness, layers, roofline
from benchmark.trace import Interval, Trace, union

MS = 1_000_000  # ns


def _record(i, t_done, ms):
    r = harness.Record(i, i % 4, False, None, None, None)
    r.t_done, r.ms = t_done, ms
    return r


def test_rate_is_over_the_whole_window_and_p95_over_every_batch():
    # 100 batches done inside a 10 s window, 5 after it
    recs = [_record(i, 0.1 * (i + 1) - 0.05, 10.0 + i) for i in range(100)]
    recs += [_record(100 + i, 10.5 + i, 1000.0) for i in range(5)]
    w = harness.window_values(recs, t_end=10.0, seconds=10.0,
                              batch_bytes=lambda slot: 2 * 10 ** 9)
    assert w["count"] == 100
    assert w["rate"] == pytest.approx(100 * 2 / 10)    # GB/s
    assert w["median"] == pytest.approx(59.5)
    assert w["p95"] == pytest.approx(10 + 94.05)        # linear, over 100
    assert math.isnan(harness.window_values([], 1, 1, lambda s: 1)["p95"])
    # batches of different sizes count each its own bytes
    w = harness.window_values(recs, 10.0, 10.0, lambda slot: slot * 10 ** 9)
    assert w["rate"] == pytest.approx(sum(i % 4 for i in range(100)) / 10)


def _trace(ops, calls, window=(0, 100 * MS)):
    return Trace(Interval("window", *window),
                 [Interval(n, s, e) for n, s, e in calls], ops)


def test_idle_is_the_window_less_the_union_of_device_ops():
    # overlapping ops on two streams, one op sticking out of the window
    ops = [("k1", 10 * MS, 30 * MS, None), ("k2", 20 * MS, 40 * MS, None),
           ("copy", 50 * MS, 60 * MS, None), ("late", 95 * MS, 130 * MS, None)]
    t = _trace(ops, [])
    assert union([(1, 3), (2, 5), (7, 8)]) == [(1, 5), (7, 8)]
    assert t.busy_s == pytest.approx((30 + 10 + 5) / 1000)
    assert t.window_s == pytest.approx(0.1)
    assert t.idle_share() == pytest.approx(0.55)
    assert t.gaps() == [(0, 10 * MS), (40 * MS, 50 * MS), (60 * MS, 95 * MS)]


def test_ops_are_charged_to_the_span_they_were_launched_from():
    calls = [("compress", 0, 10 * MS), ("pack", 10 * MS, 20 * MS),
             ("wait", 20 * MS, 90 * MS)]
    ops = [("K2", 5 * MS, 50 * MS, 9 * MS),       # launched in compress
           ("scan", 50 * MS, 51 * MS, 12 * MS),   # launched in pack
           ("memcpy", 51 * MS, 52 * MS, 15 * MS),
           ("orphan", 60 * MS, 61 * MS, None)]
    t = _trace(ops, calls)
    assert t.op_seconds({"compress"}) == pytest.approx(0.045)
    assert t.op_seconds({"pack"}) == pytest.approx(0.002)
    b = t.breakdown()
    assert b["device_ops"][0] == ["K2", pytest.approx(0.045)]
    # gaps: [0,5) in compress; [52,60) and [61,90) in wait; [90,100) in none
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle["compress"] == pytest.approx(0.005)
    assert idle["wait"] == pytest.approx(0.008 + 0.029)
    assert idle[harness.trace.HARNESS] == pytest.approx(0.010)


def _ctx(trace, slots=(0, 1)):
    sb = [layers.SlotBytes(4096, 65536, 187 * 10 ** 6, 186 * 10 ** 6,
                           188 * 10 ** 6)] * 2
    return layers.Context(list(slots), sb, 6, trace)


def test_a_roofline_share_reads_the_same_with_a_kernel_split_in_two():
    calls = [("compress_fast_batch", 0, 1 * MS),
             ("compress_fast_batch", 40 * MS, 41 * MS)]
    whole = _trace([("K2", 1 * MS, 31 * MS, MS // 2),
                    ("K2", 41 * MS, 71 * MS, 40 * MS + 1)], calls)
    split = _trace([("K2a", 1 * MS, 11 * MS, MS // 2),
                    ("K2b", 11 * MS, 31 * MS, MS // 2 + 1),
                    ("K2a", 41 * MS, 51 * MS, 40 * MS + 1),
                    ("K2b", 51 * MS, 71 * MS, 40 * MS + 2)], calls)
    one = layers.roofline_pct(
        _ctx(whole), {"compress_fast_batch"},
        lambda b: roofline.compress_bytes(b.n, b.block_bytes, b.comp_total))
    two = layers.roofline_pct(
        _ctx(split), {"compress_fast_batch"},
        lambda b: roofline.compress_bytes(b.n, b.block_bytes, b.comp_total))
    nbytes = 2 * (4096 * 65536 + 187 * 10 ** 6 + 8 * 4096)
    assert one == pytest.approx(two)
    assert one == pytest.approx(100 * nbytes / 3.35e12 / 0.060)
    # a call that launched nothing has no share, never 0
    assert layers.roofline_pct(_ctx(whole), {"frame_body_packed"},
                               lambda b: 1) is None


def test_layer_counters_read_what_they_find():
    """The cells a counter reports in are ``BENCHMARK.json``'s to say; a
    counter reads nothing only where there is nothing to read."""
    ctx = _ctx(_trace([], []), slots=(0, 1, 2))
    assert layers.launches_per_batch(ctx) == 2.0
    assert layers.idle_pct(ctx) == pytest.approx(100.0)
    assert layers.launches_per_batch(_ctx(None, slots=())) is None
    assert layers.idle_pct(_ctx(None)) is None
