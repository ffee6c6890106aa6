"""The LZ4Block cells: found from their files, their reference against the
program's plain versions, their metrics' arithmetic, and the check: the
sound program is correct, and each planted fault of the stream, and the
control, makes ``correct`` false. Runs of the harness on the program's
plain versions on the CPU, at a size they run in seconds."""

import copy
import struct
import time

import numpy as np
import pytest
import torch

from benchmark import (
    cells, data, harness, layers, lz4block_layers, lz4block_port, reference,
    roofline)
from benchmark import reference_lz4block as ref
from benchmark.system import Port
from benchmark.trace import Interval, Trace
from lz4_tpu_torch.kernels import block_stream as bs
from lz4_tpu_torch.kernels.codec import compress_fast_plain
from lz4_tpu_torch.kernels.layout import row_stride
from lz4_tpu_torch.kernels.xxhash import xxh32_plain

SEED = 2 ** 31 + 4099
CELLS = ("block64k_lz4block.write", "block64k_lz4block.read")


def _cell(name: str, block_bytes: int = 4096, n: int = 8, **traffic):
    """The cell cut to ``n`` blocks of ``block_bytes`` a batch, every
    block's row checked."""
    cell = cells.find_cell(cells.load_spec(), name)
    cell.config = copy.deepcopy(cell.config)
    cell.config["block_bytes"] = block_bytes
    cell.config["batch_blocks"] = {"lz4block_write": n, "lz4block_read": n}
    cell.config["check"] = {"rows": {"lz4block_write": 3 * n,
                                     "lz4block_read": 4 * n},
                            "decoded_batches": 3}
    cell.traffic = {**cell.traffic, **traffic}
    return cell


def _run(cell, port, seconds=4.0):
    return harness.run(cell, SEED, seconds, False, torch.device("cpu"),
                       time.perf_counter(), port=port, n_workers=1).result


def test_the_cells_are_found_with_their_parts():
    spec = cells.load_spec()
    for name in CELLS:
        cell = cells.find_cell(spec, name)
        assert cell.chips == 1
        assert cell.config["name"] == "block64k_lz4block"
        assert cell.config["checksum_seed"] == 0x9747B28C
        assert cell.config["checksum_mask"] == (1 << 28) - 1
        pipe = cell.traffic["pipeline"]
        assert cell.config["batch_blocks"][pipe] == 4096
        assert cells.pipeline(cell).__module__.endswith(pipe)
        reported = {m["name"] for m in cell.end_to_end}
        assert reported == {cell.traffic["rate_metric"], "batch_p95_ms",
                            "setup_s"}
        side = "write" if name.endswith("write") else "read"
        names = {m["name"] for m in cell.per_layer}
        assert names == ({"lz4block_pack_roofline", "compress_fast_roofline",
                          "launches_per_batch.write", "idle_pct.write"}
                         if side == "write" else
                         {"lz4block_index_roofline", "lz4block_read_roofline",
                          "launches_per_batch.read", "idle_pct.read"})
        for m in cell.per_layer:
            assert callable(cells.metric_reader(m["name"]))


@pytest.fixture(scope="module")
def batch():
    """Eight 4 KiB blocks of the mix, compressed by the plain K2."""
    L = 4096
    src, _ = data.make_batch(8, L, row_stride(L),
                             data.generator(SEED, "cpu"), "cpu")
    lens = torch.full((8,), L, dtype=torch.int32)
    comp, comp_lens, _ = compress_fast_plain(
        src, lens, reference.max_compressed_length(L))
    return src, lens, comp, comp_lens, L


def test_the_reference_writes_and_reads_the_programs_stream(batch):
    src, lens, comp, comp_lens, L = batch
    body, total = bs.block_stream_body_packed_plain(src, lens, comp,
                                                    comp_lens, L)
    rows = src.numpy()
    sums = ref.xxh32_rows(rows, L, bs.DEFAULT_SEED) & np.uint32(bs.CHECK_MASK)
    assert sums.tolist() == (xxh32_plain(src, lens, bs.DEFAULT_SEED)
                             & bs.CHECK_MASK).tolist()
    level = ref.level_of(L)
    want = b"".join(ref.write_block(
        rows[i, :L].tobytes(), comp[i, :int(comp_lens[i])].numpy().tobytes(),
        level, int(sums[i])) for i in range(8)) + ref.end_block(level)
    assert body.numpy().tobytes() == want and total == len(want)
    blocks, end_level = ref.read_stream(want)
    assert end_level == level and len(blocks) == 8
    for i, blk in enumerate(blocks):
        raw = rows[i, :L].tobytes()
        assert not ref.block_fault(blk, raw, int(sums[i]), level)
        got = (blk.payload if blk.method == ref.METHOD_RAW
               else reference.decompress_safe(blk.payload, blk.orig_len))
        assert got == raw
        assert ref.stored_as_stated("lz4_fast", {}, raw, blk.method,
                                    blk.payload)
    for cut in (want[:-21], want[:-22], want + b"\0"):
        with pytest.raises(ref.MalformedStream):
            ref.read_stream(cut)


@pytest.mark.parametrize("length", [0, 1, 15, 16, 17, 63, 100, 4096])
@pytest.mark.parametrize("seed", [0, 0x9747B28C, 0xFFFFFFFF])
def test_reference_xxh32_agrees_with_the_program(length, seed):
    rows = np.random.default_rng(length).integers(
        0, 256, (5, max(length, 1) + 7), dtype=np.uint8)
    lens = torch.full((5,), length, dtype=torch.int32)
    want = xxh32_plain(torch.from_numpy(rows.copy()), lens, seed)
    assert ref.xxh32_rows(rows, length, seed).tolist() == want.tolist()


def test_the_reference_reader_applies_the_readers_rules():
    good = ref.header(ref.METHOD_LZ4, 6, 100, 65536, 5)
    assert ref.read_header(good, 0) == (ref.METHOD_LZ4, 6, 100, 65536, 5)
    for bad in (ref.header(0x30, 6, 100, 65536, 5),           # method
                ref.header(ref.METHOD_LZ4, 5, 100, 65536, 5),  # level
                ref.header(ref.METHOD_RAW, 6, 100, 65536, 5),  # raw lengths
                ref.header(ref.METHOD_LZ4, 6, 0, 5, 5),        # lengths
                ref.header(ref.METHOD_LZ4, 6, 70000, 65536, 5),  # bound
                ref.header(ref.METHOD_RAW, 6, 0, 0, 1),        # empty check
                b"LZ4Blocl" + good[8:], good[:20]):
        with pytest.raises(ref.MalformedStream):
            ref.read_header(bad, 0)


def test_the_rooflines_count_the_bytes_of_each_call():
    b = lz4block_layers.StreamBytes(n=4, block_bytes=1000, comp_total=2500,
                                    payload_total=2300, body_total=2405,
                                    lz4_total=1300, records=5)
    assert lz4block_layers.pack_bytes(b) == 4000 + 1300 + 32 + 2405
    assert lz4block_layers.index_bytes(b) == 45 * 5
    assert lz4block_layers.read_bytes(b) == 2300 + 4000 + 40
    # 1 ms of device time in each span, two batches of slot 0
    ms = 1_000_000
    calls = [("block_stream_body_packed", 0, ms), ("block_stream_index",
             2 * ms, 3 * ms), ("decompress_block_stream_batch", 4 * ms,
                               5 * ms)]
    ops = [("k", s, s + ms // 2, s) for _, s, _ in calls]
    trace = Trace(Interval("window", 0, 10 * ms),
                  [Interval(n, s, e) for n, s, e in calls], ops)
    ctx = layers.Context([0, 0], [b], 9, trace)
    for metric, nbytes in (("lz4block_pack_roofline", 2 * 7737),
                           ("lz4block_index_roofline", 2 * 225),
                           ("lz4block_read_roofline", 2 * 6340)):
        got = cells.metric_reader(metric)(ctx)
        assert got == pytest.approx(100 * roofline.least_seconds(nbytes)
                                    / 0.0005)
    assert cells.metric_reader("launches_per_batch.read")(ctx) == 4.5
    assert cells.metric_reader("idle_pct.read")(ctx) == pytest.approx(85.0)
    assert cells.metric_reader("compress_fast_roofline")(ctx) is None
    empty = layers.Context([0], [b], 0, None)
    assert cells.metric_reader("lz4block_read_roofline")(empty) is None


@pytest.mark.parametrize("name", CELLS)
def test_the_sound_program_is_correct(name):
    cell = _cell(name)
    result = _run(cell, Port(cell.config))
    assert result["correct"], result["compared"]
    assert result["failed"] == 0 and result["attempted"] > 0


def _patch_headers(body: torch.Tensor, fn) -> torch.Tensor:
    """``body`` with ``fn(header bytes, raw payload or None, is the end
    block) -> header or (header, payload)`` applied to each block."""
    s = body.numpy().tobytes()
    out, at = bytearray(), 0
    while at < len(s):
        magic, token, cl, ol, ck = struct.unpack_from("<8sBIII", s, at)
        head, payload = s[at:at + 21], s[at + 21:at + 21 + cl]
        got = fn(head, payload, ol == 0)
        head, payload = got if isinstance(got, tuple) else (got, payload)
        out += head + payload
        at += 21 + cl
    return torch.frombuffer(out, dtype=torch.uint8).clone()


class BrokenStream(lz4block_port.BlockStream):
    """The stream calls with one fault planted in the stream written."""

    def __init__(self, port, fault):
        super().__init__(port)
        self.fault = fault

    def body(self, src, lens, comp, comp_lens, block_size):
        body, total = super().body(src, lens, comp, comp_lens, block_size)
        f = self.fault
        raws = iter(src[:, :block_size].numpy())
        if f == "no_end":
            body = body[:-21].clone()
        elif f == "byte":
            body = body.clone()
            body[body.numel() // 2] ^= 1
        else:
            def patch(head, payload, end):
                if end:
                    return head
                raw = next(raws).tobytes()
                h = bytearray(head)
                if f == "seed0":
                    h[17:21] = struct.pack(
                        "<I", ref.xxh32_rows(np.frombuffer(raw, np.uint8)[None],
                                             len(raw), 0)[0] & bs.CHECK_MASK)
                elif f == "unmasked":
                    h[17:21] = struct.pack("<I", int(ref.xxh32_rows(
                        np.frombuffer(raw, np.uint8)[None], len(raw),
                        bs.DEFAULT_SEED)[0]))
                elif f == "level":
                    h[8] = (h[8] & 0xF0) | ((h[8] & 0x0F) + 1)
                elif f == "shrunk_raw" and h[8] & 0xF0 == ref.METHOD_LZ4:
                    h[8] = ref.METHOD_RAW | (h[8] & 0x0F)
                    h[9:13] = struct.pack("<I", len(raw))
                    return bytes(h), raw
                return bytes(h)
            body = _patch_headers(body, patch)
        return body, body.numel()


class BrokenPort(Port):
    def __init__(self, config, fault):
        super().__init__(config)
        self.block_stream = BrokenStream(self, fault)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ["seed0", "unmasked", "level", "shrunk_raw",
                                   "no_end", "byte"])
def test_a_planted_fault_of_the_stream_is_found(name, fault):
    """Checks with seed 0, or not masked to 28 bits, a wrong level nibble,
    a block that compressing made smaller stored raw, no end block, a
    flipped byte: each makes the write cell's stream, or the stream the
    read cell set up, wrong."""
    cell = _cell(name)
    result = _run(cell, BrokenPort(cell.config, fault))
    assert not result["correct"], result["compared"]
    wrong = {k for k, v in result["compared"].items() if v["value"] > 0}
    assert wrong & ({"stream", "decoded"} if name.endswith("write")
                    else {"setup_stream"}), wrong


class BrokenDecode(lz4block_port.BlockStream):
    def decode(self, stream, index, block_size):
        out, out_lens, err = super().decode(stream, index, block_size)
        out[1, 5] ^= 1
        return out, out_lens, err


class BrokenReadPort(Port):
    def __init__(self, config):
        super().__init__(config)
        self.block_stream = BrokenDecode(self)


def test_a_wrong_decoded_block_is_found():
    cell = _cell("block64k_lz4block.read")
    result = _run(cell, BrokenReadPort(cell.config))
    assert not result["correct"]
    assert result["compared"]["decoded"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The port's parallel compressor in place of the fast scan: valid
    LZ4, read back soundly, but not the stated codec's bytes."""
    cell = _cell(name)
    result = _run(cell, Port(cell.config, cell.config["control"]), 8.0)
    assert not result["correct"], result["compared"]
    wrong = {k for k, v in result["compared"].items() if v["value"] > 0}
    assert wrong in ({"rows"}, {"setup_stream"}), wrong


def test_a_program_without_the_calls_fails_at_once():
    """The program before the stream's calls (the parent of the change
    that added them) cannot run the cells: the run stops before any
    batch."""
    cell = _cell("block64k_lz4block.read")
    port = Port(cell.config)

    class Old:
        pass

    port._sharded = Old()
    with pytest.raises(RuntimeError, match="no LZ4Block stream calls"):
        _run(cell, port)
