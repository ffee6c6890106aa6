"""``lz4_tpu_torch.utils`` (profiling, timing, buffers) against the cases
of ``tests/test_aux.py`` and the JAX package's helpers; the host split that
``chip_smoke.py`` reads from a trace; and the proof that the staging
buffer's rows need no zeroed tails: no kernel body (built for the host
with g++, as in ``test_torch_host_kernels.py``) gives another result when
every byte past a row's length is ``0xA5``."""

import io
import json

import numpy as np
import pytest
import torch

import chip_smoke
from lz4_tpu.utils import buffers as jax_buffers
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.kernels import codec, hc, layout, sequences
from lz4_tpu_torch.utils import (
    DeviceTimer, annotate, as_bytes, chunk_bytes, median_throughput, part,
    trace)
from lz4_tpu_torch.utils.buffers import read_into
from lz4_tpu_torch.utils.profiling import TRACE_FILE
from test_torch_host_kernels import (  # noqa: F401
    _host_codec, _host_hc, _host_parallel, _host_parse, _ptr, lib)


def test_trace_and_annotate_write_a_chrome_trace(tmp_path):
    with trace(str(tmp_path)) as prof:
        with annotate("outer"):
            with part("kernels"):
                torch.ones(8).sum()
    events = json.loads((tmp_path / TRACE_FILE).read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert {"outer", "lz4tt.kernels"} <= names
    assert any(e.key == "lz4tt.kernels" for e in prof.key_averages())
    with pytest.raises(ValueError):
        part("compress")


def test_timing_utils():
    t = DeviceTimer()
    with t.section("a"):
        pass
    with t.section("a"):
        pass
    assert "a" in t.spans and "a=" in t.report()
    assert t.device_spans() == {}
    gbps = median_throughput(lambda x: sum(x), [[1], [2], [3]], 10 ** 9)
    assert gbps > 0
    with pytest.raises(ValueError):
        median_throughput(lambda x: x, [[1]], 1)


@pytest.mark.parametrize("data, size", [(b"abcdef", 4), (b"", 4),
                                        (b"abcdefgh", 4), (b"x", 1)])
def test_buffer_utils_match_the_jax_helpers(data, size):
    assert chunk_bytes(data, size) == jax_buffers.chunk_bytes(data, size)
    for buf in (data, bytearray(data), memoryview(data)):
        assert as_bytes(buf) == jax_buffers.as_bytes(buf) == data
    assert as_bytes(bytearray(b"ab")) == b"ab"
    with pytest.raises(TypeError):
        as_bytes("str")
    with pytest.raises(ValueError):
        chunk_bytes(data, 0)


class _ReadOnly:
    """A stream without ``readinto`` that returns at most 5 bytes a read."""

    def __init__(self, data):
        self._b = io.BytesIO(data)

    def read(self, n):
        return self._b.read(min(n, 5))


@pytest.mark.parametrize("make", [io.BytesIO, _ReadOnly])
def test_read_into_fills_from_any_stream(make):
    buf = np.zeros(12, np.uint8)
    assert read_into(make(b"0123456789abcdefg"), buf) == 12
    assert buf.tobytes() == b"0123456789ab"
    buf[:] = 0
    assert read_into(make(b"xyz"), buf[2:]) == 3
    assert buf.tobytes() == b"\0\0xyz" + bytes(7)
    assert read_into(make(b""), buf) == 0


def test_host_split_reads_a_trace(tmp_path):
    """Exclusive host time of nested spans, what no span covers, and the
    union of the card's intervals clipped to the call."""
    def x(name, ts, dur, cat="user_annotation", tid=1):
        return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat,
                "tid": tid}
    events = [x(chip_smoke.CALL_SPAN, 100, 1000),
              x("lz4tt.kernels", 100, 300), x("lz4tt.upload", 150, 100),
              x("lz4tt.write", 600, 200), x("lz4tt.write", 650, 50),
              x("k", 50, 100, "kernel"), x("k", 120, 100, "kernel"),
              x("m", 900, 400, "gpu_memcpy"), x("aten::add", 0, 99, "cpu_op")]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    out = chip_smoke.read_trace(path)
    assert out["wall_ms"] == 1.0
    assert out["parts_ms"]["kernels"] == 0.2 and out["parts_ms"]["upload"] == 0.1
    assert out["parts_ms"]["write"] == 0.2
    assert out["other_ms"] == 0.5
    assert out["device_busy_ms"] == 0.32     # [100, 220) and [900, 1100)
    assert out["kernels"] == 2 and out["copies"] == 1


def test_plain_hc_pool_matches_the_plain_version_and_reaps_its_workers():
    """``chip_smoke.PlainPool`` gives what ``hc.compress_hc_plain`` gives,
    row by row, and no worker process outlives its ``with``, whether the
    block ends or raises."""
    rng = np.random.default_rng(41)
    blocks = [testing.block_of(rng, k, n) for n in (0, 12, 13, 1000, 5000)
              for k in testing.HC_KINDS]
    src, lens = layout.to_device_layout(blocks, device="cpu")
    cap = max_compressed_length(5000)
    with chip_smoke.PlainPool(2) as pool:
        procs = list(pool.procs)
        for level, dest_cap in ((1, cap), (9, cap), (9, 40)):
            got, _ = chip_smoke.hc_plain(pool, src, lens, dest_cap, level)
            want = hc.compress_hc_plain(src, lens, dest_cap, level)
            assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(p.returncode is not None for p in procs)
    with pytest.raises(RuntimeError):
        with chip_smoke.PlainPool(2) as pool:
            procs = list(pool.procs)
            raise RuntimeError("a phase failed")
    assert all(p.returncode is not None for p in procs)


# --- no kernel reads a row past its length ---------------------------------

def _tails(t: torch.Tensor, lens: torch.Tensor) -> torch.Tensor:
    """``t`` with every byte past a row's length 0xA5, but the first byte
    of an empty row, which ``layout.to_device_layout`` sets to 0 (K1's fast
    entry point reads it)."""
    out = t.clone()
    col = torch.arange(t.shape[1])
    out[col[None, :] >= lens[:, None].long()] = 0xA5
    out[lens == 0, 0] = 0
    return out


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(31)
    blocks = testing.mixed_blocks(rng, (0, 5, 12, 13, 1000, 65536, 65547))
    src, lens = layout.to_device_layout(blocks, device="cpu")
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(65547))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    fuzz = testing.fuzz_blocks(rng, comp_blocks, 96) + [b""]
    c, cl = layout.to_device_layout(comp_blocks + fuzz, device="cpu")
    return (src, lens), (c, cl), (comp, comp_lens)


@pytest.mark.parametrize("kernel", ["compress", "decode", "decode_fast",
                                    "xxh32", "xxh64", "parse", "pack", "hc",
                                    "parallel"])
def test_row_tails_change_no_kernel_output(lib, batches, kernel):  # noqa: F811
    (src, lens), (c, cl), (comp, comp_lens) = batches

    def run(zero_tails: bool):
        s = src if zero_tails else _tails(src, lens)
        k = c if zero_tails else _tails(c, cl)
        if kernel == "compress":
            cap = max_compressed_length(65547)
            return _host_codec(lib.host_compress, s, lens,
                               layout.row_stride(cap), cap)
        if kernel in ("decode", "decode_fast"):
            fn = lib.host_decode if kernel == "decode" else lib.host_decode_fast
            return [_host_codec(fn, k, cl, layout.row_stride(m), m)
                    for m in (0, 1000, 65547)]
        if kernel in ("xxh32", "xxh64"):
            dtype = torch.int32 if kernel == "xxh32" else torch.int64
            out = []
            for rows in (1, 32):
                h = torch.zeros((s.shape[0],), dtype=dtype)
                getattr(lib, f"host_{kernel}")(_ptr(s), s.stride(0), _ptr(lens),
                                               7, _ptr(h), s.shape[0], rows)
                out.append(h)
            return out
        if kernel == "hc":
            cap = max_compressed_length(65547)
            return [_host_hc(lib, s, lens, cap, level) for level in (1, 2)]
        if kernel == "parallel":
            return _host_parallel(lib, s, lens, max_compressed_length(65547))
        if kernel == "parse":
            return _host_parse(lib, k, cl, sequences.max_seq_for(k.shape[1]))
        offs = sharded.pack_offsets(torch.where(
            lens > 0, torch.minimum(lens, comp_lens) + 4, 0))
        body = torch.zeros((int(offs[-1]) + 4 + 65547,), dtype=torch.uint8)
        t_comp = comp if zero_tails else _tails(comp, comp_lens)
        lib.host_pack(_ptr(s), s.stride(0), _ptr(lens), _ptr(t_comp),
                      t_comp.stride(0), _ptr(comp_lens), _ptr(offs),
                      _ptr(body), s.shape[0], 1)
        return body

    def flat(x):
        return [t for y in (x if isinstance(x, (list, tuple)) else [x])
                for t in (y if isinstance(y, (list, tuple)) else [y])]

    for a, b in zip(flat(run(True)), flat(run(False)), strict=True):
        assert torch.equal(a, b)
