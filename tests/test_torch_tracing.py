"""The port's own spans and read-back counts (``utils/profiling.py``), and
``chip_smoke.py``'s readers of them: the host split and the idle split of
the benchmark's cells by the port's innermost span."""

import json
import types

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.kernels import codec, hc, layout
from lz4_tpu_torch.utils import profiling

MS = 1_000_000  # ns


@pytest.fixture(autouse=True)
def _fresh_counts():
    profiling.reset_sync_counts()
    yield
    profiling.reset_sync_counts()


def _batch(n=3, size=700):
    rng = np.random.default_rng(5)
    blocks = [testing.block_of(rng, kind, size)
              for kind in testing.HC_KINDS[:n]]
    return layout.to_device_layout(blocks, device="cpu")


def _cpu_profile(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return chip_smoke._port_events(prof)[0]


def test_no_span_builds_a_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    for ctx in (profiling.span("x"), profiling.annotate("y"),
                profiling.part("kernels"), profiling.readback("s")):
        assert ctx is profiling._OFF
        with ctx:
            pass
    src, lens = _batch()
    comp, comp_lens, _ = codec.compress_fast_batch(src, lens, 1000)
    codec.decompress_safe_batch(comp, comp_lens, 700)
    with pytest.raises(ValueError):
        profiling.part("compress")


def _call(name):
    src, lens = _batch()
    cap = max_compressed_length(700)
    if name == "compress_fast_batch":
        return lambda: codec.compress_fast_batch(src, lens, cap)
    if name == "compress_hc_batch":
        return lambda: hc.compress_hc_batch(src, lens, cap, 9)
    comp, comp_lens, _ = codec.compress_fast_batch(src, lens, cap)
    if name == "decompress_safe_batch":
        return lambda: codec.decompress_safe_batch(comp, comp_lens, 700)
    if name == "frame_body_packed":
        return lambda: sharded.frame_body_packed(src, lens, comp, comp_lens)
    if name == "block_stream_body_packed":
        return lambda: sharded.block_stream_body_packed(src, lens, comp,
                                                        comp_lens, 1024)
    body, total = sharded.block_stream_body_packed(src, lens, comp, comp_lens,
                                                   1024)
    index = sharded.block_stream_index(body, total, 8)
    if name == "block_stream_index":
        return lambda: sharded.block_stream_index(body, total, 8)
    return lambda: sharded.decompress_block_stream_batch(body, index, 1024)


@pytest.mark.parametrize("name", sorted(set(chip_smoke.ENTRY_OF.values())))
def test_entry_spans_wrap_the_calls_and_nest(name):
    spans = _cpu_profile(_call(name))
    outer = [s for s in spans if s[2] == name]
    assert len(outer) == 1
    s0, e0, _ = outer[0]
    assert all(s0 <= s <= e <= e0 for s, e, _ in spans)
    inner = {n for _, _, n in spans} - {name}
    # the compress calls read their lengths back first; the decode reads
    # none back, as K1 checks each row's length on the card; the CPU's
    # frame body is its plain version, which reads nothing back from a card
    reads = name.startswith("compress")
    assert ("sync.check_batch" in inner) == reads
    assert all(n.startswith("sync.") for n in inner)


def test_readback_counts_by_site_and_not_for_host_tensors():
    card = types.SimpleNamespace(is_cuda=True)
    for read in (None, card, None):
        with profiling.readback("a", read):
            pass
    with profiling.readback("b"):
        pass
    with profiling.readback("a", torch.zeros(2)):
        pass
    assert profiling.sync_counts() == {"a": 3, "b": 1}
    # host batches wait for no card
    _call("decompress_safe_batch")()
    codec._check_window(torch.zeros((1, 8), dtype=torch.uint8),
                        torch.zeros(1, dtype=torch.int32), 1,
                        torch.device("cpu"), "hist")
    assert profiling.sync_counts() == {"a": 3, "b": 1}


def test_reset_sync_counts():
    with profiling.readback("a"):
        pass
    counts = profiling.sync_counts()
    counts["a"] = 9                 # a copy
    assert profiling.sync_counts() == {"a": 1}
    profiling.reset_sync_counts()
    assert profiling.sync_counts() == {}


def test_host_split_gives_exclusive_times_of_a_sync_span_in_a_part(tmp_path):
    def x(name, ts, dur, cat="user_annotation"):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
                "tid": 1}
    events = [x(chip_smoke.CALL_SPAN, 0, 1000),
              x("lz4tt.kernels", 0, 200),
              x("lz4tt.check", 300, 400),
              x("lz4tt.sync.decompress_rows", 350, 300),
              x("k", 0, 500, "kernel")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = chip_smoke.read_trace(path)
    assert out["parts_ms"]["check"] == 0.1
    assert out["parts_ms"]["sync.decompress_rows"] == 0.3
    assert out["parts_ms"]["kernels"] == 0.2
    assert out["other_ms"] == 0.4
    assert out["device_busy_ms"] == 0.5


SPANS = [  # two batches of a write: entries, each with a read-back inside
    (10 * MS, 30 * MS, "compress_fast_batch"),
    (12 * MS, 20 * MS, "sync.check_batch"),
    (30 * MS, 50 * MS, "frame_body_packed"),
    (35 * MS, 45 * MS, "sync.frame_body"),
    (60 * MS, 70 * MS, "compress_fast_batch"),
    (61 * MS, 62 * MS, "sync.check_batch")]


def test_innermost_pieces_follow_nested_spans():
    assert chip_smoke.innermost(SPANS) == [
        (10 * MS, 12 * MS, "compress_fast_batch"),
        (12 * MS, 20 * MS, "sync.check_batch"),
        (20 * MS, 30 * MS, "compress_fast_batch"),
        (30 * MS, 35 * MS, "frame_body_packed"),
        (35 * MS, 45 * MS, "sync.frame_body"),
        (45 * MS, 50 * MS, "frame_body_packed"),
        (60 * MS, 61 * MS, "compress_fast_batch"),
        (61 * MS, 62 * MS, "sync.check_batch"),
        (62 * MS, 70 * MS, "compress_fast_batch")]
    # three deep, and a span that shares its parent's start and end
    deep = [(0, 10, "a"), (2, 8, "b"), (3, 5, "c"), (0, 10, "d")]
    assert chip_smoke.innermost(deep) == [
        (0, 2, "d"), (2, 3, "b"), (3, 5, "c"), (5, 8, "b"), (8, 10, "d")]
    assert chip_smoke.innermost([]) == []


def test_idle_is_split_by_the_innermost_port_span():
    gaps = [(0, 11 * MS), (15 * MS, 33 * MS), (44 * MS, 46 * MS),
            (55 * MS, 100 * MS)]
    got = chip_smoke.idle_by_span(gaps, SPANS)
    assert got == {None: 10 * MS + 5 * MS + 30 * MS,
                   "compress_fast_batch": 1 * MS + 10 * MS + 1 * MS + 8 * MS,
                   "sync.check_batch": 5 * MS + 1 * MS,
                   "frame_body_packed": 3 * MS + 1 * MS,
                   "sync.frame_body": 1 * MS}
    assert sum(got.values()) == sum(b - a for a, b in gaps)
    shares = chip_smoke.idle_shares(got, 100 * MS)
    assert shares["sync_idle_pct"] == pytest.approx(7.0)
    assert shares["enqueue_idle_pct"] == pytest.approx(24.0)
    assert chip_smoke.idle_by_span(gaps, []) == {None: 76 * MS}


def test_kernel_launches_are_matched_to_their_entry_spans():
    launches = [
        ("void (anonymous namespace)::compress_kernel(unsigned char const*)",
         11 * MS),
        ("(anonymous namespace)::pack_kernel(unsigned char const*, long)",
         40 * MS),
        ("(anonymous namespace)::pack_kernel(unsigned char const*, long)",
         55 * MS),                              # outside every span
        ("void (anonymous namespace)::decode_kernel<false, false>(int)", None),
        ("(anonymous namespace)::compress_dict_kernel(unsigned char*)",
         11 * MS),                              # not a cell's kernel
        ("Memcpy DtoH (Device -> Pinned)", 16 * MS)]
    assert chip_smoke.launches_in_entries(launches, SPANS) == {
        "compress_kernel": [1, 1], "pack_kernel": [1, 2],
        "decode_kernel": [0, 1]}


def test_idle_split_runs_a_cell_on_the_harness_profiler(monkeypatch):
    """``idle_split``'s plumbing on a stand-in for ``harness.run``: a CPU
    profiler session over two write batches, read by the patched
    ``trace.from_profiler`` and the harness's two launch counts."""
    from benchmark import harness, trace as bench_trace

    src, lens = _batch()
    cap = max_compressed_length(700)

    def run(cell, seed, seconds, traced, device, t_start, port):
        port.launches()
        span = bench_trace.spans(True)
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with span("window"):
                for _ in range(2):
                    with span(port.compress_name):
                        comp, comp_lens, _ = port.compress(src, lens, cap)
                    with span("frame_body_packed"):
                        port.frame_body(src, lens, comp, comp_lens)
        tr = bench_trace.from_profiler(prof)
        port.launches()
        return harness.Run({"breakdown": tr.breakdown()}, ["a note"])

    monkeypatch.setattr(harness, "run", run)
    real = bench_trace.from_profiler
    out = chip_smoke.idle_split(["block64k_fast.write"], 7, 1.0)
    assert bench_trace.from_profiler is real
    got = out["block64k_fast.write"]
    assert got["batches"] == 2
    assert got["host_syncs_per_batch"] == 0.0       # host tensors
    # no device work: the whole window is idle, and the entry spans lie
    # inside the benchmark's spans around the same calls
    assert got["idle_pct"] == pytest.approx(100.0)
    in_port = got["sync_idle_pct"] + got["enqueue_idle_pct"]
    assert 0 < in_port <= got["bench_call_idle_pct"] <= 100.0
    assert got["sync_idle_pct"] > 0
    assert got["launches_in_entry_spans"] == {}
