"""The LZ4Block stream's batch calls (``kernels/block_stream.py``) in their
plain versions on the CPU: the packed body against the JAX package's
writer and the port's stream classes, the walk of the headers and the
decode against the reader, and planted faults against the JAX reader's
errors."""

import io

import numpy as np
import pytest
import torch

import lz4_tpu.formats as jfmt
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.errors import Lz4Error, Lz4FrameError
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.formats import (
    Lz4BlockInputStream, Lz4BlockOutputStream, decompress_block_stream)
from lz4_tpu_torch.kernels import block_stream as bs
from lz4_tpu_torch.kernels import codec, layout
from lz4_tpu_torch.kernels.xxhash import xxh32_plain

KINDS = ("alphabet4", "text", "incompressible")


def _blocks(data: bytes, block_size: int) -> list[bytes]:
    return [data[i:i + block_size] for i in range(0, len(data), block_size)]


def _pack(data: bytes, block_size: int):
    """The plain packer's body of ``data``, compressed by the plain K2."""
    blocks = _blocks(data, block_size)
    src, lens = layout.to_device_layout(blocks, cap=block_size, device="cpu")
    comp, comp_lens, _ = codec.compress_fast_plain(
        src, lens, block_size + block_size // 255 + 16)
    return bs.block_stream_body_packed_plain(src, lens, comp, comp_lens,
                                             block_size)


def _stream_of(data: bytes, block_size: int) -> bytes:
    out = io.BytesIO()
    s = Lz4BlockOutputStream(out, block_size=block_size, device="cpu")
    s.write(data)
    s.finish()
    return out.getvalue()


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_size, size", [
    (1 << 16, 2 * 65536 + 777), (64, 64 * 40 + 13), (1024, 5000)],
    ids=["64KiB", "64B", "1KiB_tail"])
def test_plain_body_is_the_writers_stream(kind, block_size, size):
    rng = np.random.default_rng(size)
    data = testing.block_of(rng, kind, size)
    body, total = _pack(data, block_size)
    want = jfmt.compress_block_stream(data, block_size)
    assert total == body.numel() == len(want)
    assert body.numpy().tobytes() == want
    assert _stream_of(data, block_size) == want


def test_plain_body_of_no_blocks_is_the_end_block():
    src = torch.zeros((0, 32), dtype=torch.uint8)
    lens = torch.zeros((0,), dtype=torch.int32)
    body, total = bs.block_stream_body_packed_plain(src, lens, src, lens)
    assert body.numpy().tobytes() == jfmt.compress_block_stream(b"")
    assert total == bs.HEADER_LENGTH


def test_plain_body_refuses_lengths_past_the_block_size():
    src, lens = layout.to_device_layout([bytes(100)], device="cpu")
    with pytest.raises(ValueError):
        bs.block_stream_body_packed_plain(src, lens, src, lens, 64)
    with pytest.raises(ValueError):
        bs.block_stream_body_packed_plain(src, lens, src, lens, 63)


@pytest.mark.parametrize("block_size", [64, 1024, 1 << 16])
def test_plain_index_and_decode_read_the_stream(block_size):
    rng = np.random.default_rng(block_size)
    data = b"".join(testing.block_of(rng, k, 3000) for k in KINDS)
    body, total = _pack(data, block_size)
    n = -(-len(data) // block_size)
    index = bs.block_stream_index(body, total, n + 1)
    count, end = index.meta.tolist()
    assert (count, end) == (n + 1, total)
    assert index.table[bs.CODE].tolist() == [bs.OK] * (n + 1)
    assert index.table[bs.OLEN, -1] == 0
    lz4 = index.table[bs.METHOD] == bs.COMPRESSION_METHOD_LZ4
    n_lz4 = int(lz4.sum())
    assert sorted(index.order.tolist()) == list(range(n + 1))
    assert bool(lz4[index.order[:n_lz4]].all())
    assert not bool(lz4[index.order[n_lz4:]].any())
    assert index.order[:n_lz4].tolist() == sorted(index.order[:n_lz4].tolist())
    out, out_lens, err = bs.decompress_block_stream_batch(body, index,
                                                          block_size)
    assert err.tolist() == [bs.OK] * (n + 1)
    got = layout.from_device_layout(out, out_lens)
    assert b"".join(got) == data
    # the checks, hashed again
    sums = xxh32_plain(out, out_lens, bs.DEFAULT_SEED).to(torch.int64)
    assert torch.equal(sums[:n] & bs.CHECK_MASK,
                       index.table[bs.CHECK, :n].to(torch.int64))


def test_index_stops_at_max_blocks_and_goes_on_from_its_end():
    rng = np.random.default_rng(3)
    data = testing.block_of(rng, "text", 10 * 1024)
    body, total = _pack(data, 1024)
    first = bs.block_stream_index(body, total, 4)
    count, end = first.meta.tolist()
    assert count == 4 and end == int(first.table[bs.AT, 3]) + 21 + int(
        first.table[bs.CLEN, 3])
    rest, _ = bs.walk(body.numpy().tobytes(), total, end, True, 100)
    full = bs.block_stream_index(body, total, 100)
    assert full.meta.tolist()[0] == 4 + len(rest) == 11
    assert full.table[:, 4:11].T.tolist() == [list(r) for r in rest]
    assert full.table[bs.CODE, 11:].tolist() == [bs.NONE] * 89


@pytest.mark.parametrize("stop", [True, False])
def test_index_across_concatenated_streams(stop):
    rng = np.random.default_rng(4)
    a, b = (testing.block_of(rng, "alphabet4", 3000) for _ in range(2))
    blob = jfmt.compress_block_stream(a, 1024) + jfmt.compress_block_stream(
        b, 2048)
    stream = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    index = bs.block_stream_index(stream, len(blob), 64, stop)
    count, end = index.meta.tolist()
    codes = index.table[bs.CODE, :count].tolist()
    assert codes == [bs.OK] * count
    assert count == (4 if stop else 4 + 3)      # the end blocks are records
    assert end == (len(jfmt.compress_block_stream(a, 1024)) if stop
                   else len(blob))
    out, lens, err = bs.decompress_block_stream_batch(stream, index, 2048)
    assert b"".join(layout.from_device_layout(out, lens)) == (
        a if stop else a + b)


@pytest.mark.parametrize("blob, stop, codes", [
    (b"", True, [bs.PREMATURE]), (b"", False, []),
    (b"LZ4Block", True, [bs.PREMATURE]), (b"x" * 30, False, [bs.CORRUPTED])])
def test_index_of_streams_with_no_first_block(blob, stop, codes):
    stream = torch.frombuffer(bytearray(blob + b"\0"), dtype=torch.uint8)
    index = bs.block_stream_index(stream, len(blob), 2, stop)
    count, end = index.meta.tolist()
    assert index.table[bs.CODE, :count].tolist() == codes
    assert end == 0


@pytest.mark.parametrize("case", sorted(testing.LZ4BLOCK_FAULTS))
def test_planted_faults_give_their_code_and_error(case):
    """Each fault's record carries its code, the records before it are
    sound, and the one-shot reader raises what the JAX reader raises."""
    blob, at = testing.lz4block_fault(case, np.random.default_rng(7))
    stream = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    index = bs.block_stream_index(stream, len(blob), 16)
    _, _, err = bs.decompress_block_stream_batch(
        stream, index, testing.LZ4BLOCK_FAULT_BLOCK)
    count = int(index.meta[0])
    codes = err[:count].tolist()
    want = testing.LZ4BLOCK_FAULTS[case]
    if at < 0:
        assert codes == [bs.OK] * count and count == 5
    else:
        assert codes[:at] == [bs.OK] * at
        assert codes[at] == want
    try:
        jax = jfmt.Lz4BlockInputStream(io.BytesIO(blob)).read()
    except Exception as e:     # noqa: BLE001 - the error is compared
        jax = e
    for read in (lambda: decompress_block_stream(blob, device="cpu"),
                 lambda: Lz4BlockInputStream(io.BytesIO(blob),
                                             device="cpu").read()):
        if isinstance(jax, bytes):
            assert read() == jax
            continue
        with pytest.raises(Lz4Error) as got:
            read()
        assert type(got.value).__name__ == type(jax).__name__
        # the JAX codec names its decoder after the message
        assert str(got.value) == str(jax).split(" (")[0]
        assert isinstance(got.value, Lz4FrameError) == (want != bs.MALFORMED)
    assert isinstance(jax, bytes) == (want == bs.OK)


def test_one_shot_reads_windows_and_batches(monkeypatch):
    """Windows and output batches far smaller than the stream: a record
    cut by a window's end is read again from the next."""
    from lz4_tpu_torch.formats import block_stream as fbs

    rng = np.random.default_rng(5)
    data = b"".join(testing.block_of(rng, k, 5000) for k in KINDS)
    blob = jfmt.compress_block_stream(data, 1024)
    monkeypatch.setattr(fbs, "_BATCH_BYTES", 2500)
    monkeypatch.setattr(fbs, "_WINDOW_RECORDS", 3)
    assert decompress_block_stream(blob, device="cpu") == data
    cat = blob + jfmt.compress_block_stream(data[:3000], 64)
    assert decompress_block_stream(cat, stop_on_empty_block=False,
                                   device="cpu") == data + data[:3000]
    with pytest.raises(Lz4FrameError, match="prematurely"):
        decompress_block_stream(blob[:-21], device="cpu")


def test_the_batch_calls_are_those_of_the_frame_body():
    assert sharded.block_stream_body_packed is bs.block_stream_body_packed
    assert sharded.block_stream_index is bs.block_stream_index
    assert (sharded.decompress_block_stream_batch
            is bs.decompress_block_stream_batch)


def test_index_slices_and_refuses_bad_inputs():
    blob = jfmt.compress_block_stream(bytes(3000), 1024)
    stream = torch.frombuffer(bytearray(blob), dtype=torch.uint8)
    index = bs.block_stream_index(stream, len(blob), 8)
    assert index.table.shape[1] == 8 and index[2:5].table.shape[1] == 3
    lz4 = [r for r in index.order.tolist() if 2 <= r < 5]
    assert index[2:5].order.tolist() == [r - 2 for r in lz4]
    even = index[::2]
    assert torch.equal(even.table, index.table[:, ::2])
    assert even.order.tolist() == [r // 2 for r in index.order.tolist()
                                   if r % 2 == 0]
    out, lens, err = bs.decompress_block_stream_batch(stream, index[1:3], 1024)
    assert lens.tolist() == [1024, 952] and err.tolist() == [0, 0]
    out, lens, err = bs.decompress_block_stream_batch(stream, index[:2], 1000)
    assert err.tolist() == [bs.TOO_LARGE] * 2 and lens.tolist() == [0, 0]
    with pytest.raises(ValueError):
        bs.block_stream_index(stream, len(blob) + 1, 8)
    with pytest.raises(ValueError):
        bs.block_stream_index(stream, len(blob), 0)
