"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and ``nvcc``; without one it skips. The
file imports nothing from the JAX package, so on a machine without JAX it
runs alone, without ``tests/conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_card.py
"""

import io
import struct

import numpy as np
import pytest
import torch

from lz4_tpu_torch import (
    Lz4Factory, XXHashFactory, compress_frame_packed, roundtrip_step, testing)
from lz4_tpu_torch.core import xxhash_ref
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.kernels import (
    build, codec, gather_decode, hc, layout, linked_decode,
    parallel_compress, segment_decode, sequences, xxhash, xxhash_stream)
from lz4_tpu_torch.streams import compress_stream, decompress_stream

pytestmark = pytest.mark.cuda

EDGE_SIZES = (0, 5, 12, 13, 1000, 65536, 70000)
TIER_KERNELS = ("lz4_compress", "lz4_decode", "lz4_decode_fast", "xxh32",
                "xxh64")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _assert_codec_equal(kern, plain, all_lens=True):
    assert torch.equal(kern[2], plain[2])
    ok = kern[2] == 0
    rows = torch.ones_like(ok) if all_lens else ok
    assert torch.equal(kern[1][rows], plain[1][rows])
    for i in torch.nonzero(ok).flatten().tolist():
        n = int(kern[1][i])
        assert torch.equal(kern[0][i, :n], plain[0][i, :n]), i


@pytest.mark.parametrize("dest_cap", [max_compressed_length(70000), 600])
def test_compress_kernel_matches_plain(cuda_device, dest_cap):
    rng = np.random.default_rng(dest_cap)
    src, lens = layout.to_device_layout(
        testing.mixed_blocks(rng, EDGE_SIZES), device=cuda_device)
    before = codec.COMPRESS.launches
    kern = codec.compress_fast_batch(src, lens, dest_cap)
    assert codec.COMPRESS.launches == before + 1
    _assert_codec_equal(kern, codec.compress_fast_plain(src, lens, dest_cap))


@pytest.mark.parametrize("out_max", [0, 1, 64, 1000, 70000])
def test_decode_kernel_matches_plain(cuda_device, out_max):
    rng = np.random.default_rng(out_max)
    blocks = testing.mixed_blocks(rng, EDGE_SIZES)
    src, lens = layout.to_device_layout(blocks, device=cuda_device)
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    c, cl = layout.to_device_layout(
        comp_blocks + testing.fuzz_blocks(rng, comp_blocks, 256),
        device=cuda_device)
    bufs = [torch.full((c.shape[0], out_max + 64), 0xA5, dtype=torch.uint8,
                       device=cuda_device) for _ in range(2)]
    kern = codec.decompress_safe_batch(c, cl, out_max, out=bufs[0])
    plain = codec.decompress_safe_plain(c, cl, out_max, out=bufs[1])
    _assert_codec_equal(kern, plain, all_lens=False)
    for buf in bufs:
        assert bool((buf[:, out_max:] == 0xA5).all())
    if out_max == 70000:
        assert layout.from_device_layout(kern[0], kern[1])[:len(blocks)] == \
            blocks


@pytest.mark.parametrize("empty", [False, True], ids=["cap", "cap0"])
@pytest.mark.parametrize("name", testing.DECODERS)
def test_decode_lengths_outside_the_row_match_the_cpu(cuda_device, name,
                                                      empty):
    """A row whose length lies outside ``[0, S]`` (each of
    ``testing.BAD_LENGTHS``) is ``ERR_MALFORMED`` with length 0 on the card,
    its output row untouched, and every row's code, length and bytes are
    the CPU's, with room for the blocks and with none (``dest_cap`` 0)."""
    comp, lens, cap = testing.length_batch(np.random.default_rng(5), "cpu")
    cap = 0 if empty else cap
    n, stride = comp.shape
    rows = [1, 4, 7]
    for i, length in zip(rows, testing.BAD_LENGTHS.values()):
        lens[i] = length(stride)
    outs = [torch.full((n, cap + 16), 0xA5, dtype=torch.uint8, device=dev)
            for dev in (cuda_device, "cpu")]
    kern = testing.decode_with(name, comp.to(cuda_device),
                               lens.to(cuda_device), cap, out=outs[0])
    plain = testing.decode_with(name, comp, lens, cap, out=outs[1])
    assert kern[2].tolist() == plain[2].tolist()
    assert kern[2][rows].tolist() == [codec.ERR_MALFORMED] * len(rows)
    assert kern[1].tolist() == plain[1].tolist()
    assert kern[1][rows].tolist() == [0] * len(rows)
    if cap:
        assert kern[2].tolist().count(codec.OK) == n - len(rows)
    assert torch.equal(outs[0].cpu(), outs[1])
    assert bool((outs[1][rows] == 0xA5).all())


@pytest.mark.parametrize("name", ["safe", "fast"])
def test_decode_launch_waits_for_no_read_back(cuda_device, name):
    """The decode wrappers read nothing back: behind a kernel that keeps
    the stream busy, the call returns with the stream still busy, and no
    ``check_batch`` read-back is counted."""
    from lz4_tpu_torch.utils import profiling

    comp, lens, cap = testing.length_batch(np.random.default_rng(5),
                                           cuda_device)
    testing.decode_with(name, comp, lens, cap)
    torch.cuda.synchronize()
    before = profiling.sync_counts().get("check_batch", 0)
    torch.cuda._sleep(1 << 28)
    _, _, err = testing.decode_with(name, comp, lens, cap)
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy
    assert profiling.sync_counts().get("check_batch", 0) == before
    assert err.tolist() == [codec.OK] * comp.shape[0]


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF])
def test_xxh32_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed & 0xFF)
    sizes = list(range(101)) + [1000, 65536]
    data, lens = layout.to_device_layout(
        [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes],
        device=cuda_device)
    assert torch.equal(xxhash.xxh32_batch(data, lens, seed),
                       xxhash.xxh32_plain(data, lens, seed))


@pytest.mark.parametrize("seed", [0, (1 << 64) - 1, 0xCAFEBABE12345678])
def test_xxh64_kernel_matches_plain(cuda_device, seed):
    rng = np.random.default_rng(seed & 0xFF)
    blocks = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
              for n in list(range(101)) + [1000, 65536]]
    data, lens = layout.to_device_layout(blocks, device=cuda_device)
    before = xxhash.XXH64.launches
    kern = xxhash.xxh64_batch(data, lens, seed)
    assert xxhash.XXH64.launches == before + 1
    assert torch.equal(kern, xxhash.xxh64_plain(data, lens, seed))
    assert [v & ((1 << 64) - 1) for v in kern.tolist()] == \
        [xxhash_ref.xxh64(b, 0, len(b), seed) for b in blocks]


@pytest.mark.parametrize("n", [1, 133, 3000])
def test_hash_kernels_split_rows_as_plain(cuda_device, n):
    """K3 and K4 with one CTA a row (n = 1) and several rows a CTA (133,
    3000 rows), ragged lengths up to 3000 bytes, against the plain
    versions."""
    rng = np.random.default_rng(n)
    lens = rng.integers(0, 3001, n).astype(np.int32)
    data = torch.from_numpy(rng.integers(0, 256, (n, 3008),
                                         dtype=np.uint8)).to(cuda_device)
    lt = torch.from_numpy(lens).to(cuda_device)
    assert torch.equal(xxhash.xxh32_batch(data, lt, 5),
                       xxhash.xxh32_plain(data, lt, 5))
    assert torch.equal(xxhash.xxh64_batch(data, lt, 5),
                       xxhash.xxh64_plain(data, lt, 5))


@pytest.mark.parametrize("dest_len", [0, 1, 64, 1000, 65536])
def test_decode_fast_kernel_matches_plain(cuda_device, dest_len):
    rng = np.random.default_rng(dest_len)
    src, lens = layout.to_device_layout(
        testing.mixed_blocks(rng, EDGE_SIZES), device=cuda_device)
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    c, cl = layout.to_device_layout(
        comp_blocks + testing.fuzz_blocks(rng, comp_blocks, 256),
        device=cuda_device)
    bufs = [torch.full((c.shape[0], dest_len + 64), 0xA5, dtype=torch.uint8,
                       device=cuda_device) for _ in range(2)]
    before = codec.DECODE_FAST.launches
    kern = codec.decompress_fast_batch(c, cl, dest_len, out=bufs[0])
    assert codec.DECODE_FAST.launches == before + 1
    plain = codec.decompress_fast_plain(c, cl, dest_len, out=bufs[1])
    assert torch.equal(kern[2], plain[2])
    ok = kern[2] == 0
    assert torch.equal(kern[1][ok], plain[1][ok])
    assert torch.equal(bufs[0][ok], bufs[1][ok])
    for buf in bufs:
        assert bool((buf[:, dest_len:] == 0xA5).all())
    exact = (lens == dest_len).nonzero().flatten()
    assert bool((kern[2][exact] == 0).all())
    assert torch.equal(kern[1][exact], comp_lens[exact])


def test_factories_on_the_card(cuda_device):
    """The cuda tier builds and self-tests on the card, and its batch APIs
    go through all five kernels."""
    lz4 = Lz4Factory.cuda_instance()
    xxh = XXHashFactory.cuda_instance()
    assert lz4.device.type == xxh.device.type == "cuda"
    rng = np.random.default_rng(3)
    blocks = testing.mixed_blocks(rng, (100, 4096))
    build.reset_launch_counts()
    comp = lz4.fast_compressor().compress_batch(blocks)
    assert lz4.safe_decompressor().decompress_batch(comp, 4096) == blocks
    out, read = lz4.fast_decompressor().decompress_batch(comp[4:], 4096)
    assert out == blocks[4:] and read == [len(c) for c in comp[4:]]
    data = rng.integers(0, 256, (8, 4096), dtype=np.uint8)
    lens = np.array([4096, 0, 1, 63, 64, 4095, 2000, 4096], np.int32)
    h32 = xxh.hash32().hash_batch(data, lens, 5)
    hi, lo = xxh.hash64().hash_batch(data, lens, 5)
    counts = build.launch_counts()
    assert all(counts[k] >= 1 for k in TIER_KERNELS)
    assert h32.cpu().tolist() == [xxhash_ref.xxh32(data[i].tobytes(), 0,
                                                   int(n), 5)
                                  for i, n in enumerate(lens)]
    assert [(h << 32) | low for h, low in zip(hi.cpu().tolist(),
                                                lo.cpu().tolist())] == \
        [xxhash_ref.xxh64(data[i].tobytes(), 0, int(n), 5)
         for i, n in enumerate(lens)]


def test_roundtrip_step_matches_cpu(cuda_device):
    build.reset_launch_counts()
    gpu = roundtrip_step(64, 65536, seed=5, device=cuda_device)
    counts = build.launch_counts()
    assert [counts[k] for k in ("lz4_compress", "lz4_decode", "xxh32",
                                "frame_pack")] == [1, 1, 1, 1]
    assert sum(counts.values()) == 4
    cpu = roundtrip_step(64, 65536, seed=5, device="cpu")
    assert bool(gpu.ok.all()) and bool(cpu.ok.all())
    assert gpu.compressed_total == cpu.compressed_total
    assert gpu.offsets.cpu().tolist() == cpu.offsets.tolist()
    assert gpu.hashes.cpu().tolist() == cpu.hashes.tolist()
    assert torch.equal(gpu.body.cpu(), cpu.body)
    assert set(gpu.phase_ms) == {"compress", "checksum", "decode", "pack"}


def test_compress_frame_packed_matches_cpu(cuda_device):
    data = np.random.default_rng(8).integers(0, 8, 300_000, dtype=np.uint8)
    data = data.tobytes()
    assert compress_frame_packed(data, device=cuda_device) == \
        compress_frame_packed(data, device="cpu")


def test_wrappers_reject_unaligned_hash_rows(cuda_device):
    data = torch.zeros((2, 40), dtype=torch.uint8, device=cuda_device)
    lens = torch.tensor([3, 40], dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        xxhash.xxh32_batch(data, lens)
    with pytest.raises(ValueError):
        xxhash.xxh64_batch(data, lens)


def _comp_batch(device, rng, n_fuzz):
    """K2 output of the edge blocks and periods 1-15, the boundary blocks,
    then fuzz."""
    blocks = testing.mixed_blocks(rng, EDGE_SIZES)
    blocks += [bytes(rng.integers(0, 256, p, dtype=np.uint8)) * (4096 // p)
               for p in range(1, 16)]
    src, lens = layout.to_device_layout(blocks, device=device)
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    comp_blocks += testing.boundary_blocks()
    comp_blocks += testing.fuzz_blocks(rng, comp_blocks, n_fuzz)
    return blocks, layout.to_device_layout(comp_blocks, device=device)


@pytest.mark.parametrize("max_seq", [None, 40])
def test_parse_kernel_matches_plain(cuda_device, max_seq):
    rng = np.random.default_rng(11)
    _, (c, cl) = _comp_batch(cuda_device, rng, 256)
    before = sequences.PARSE.launches
    kern = sequences.parse_sequences(c, cl, max_seq)
    assert sequences.PARSE.launches == before + 1
    plain = sequences.parse_plain(c, cl, max_seq)
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    assert sequences.PARSE_MALFORMED in kern[1].tolist()


@pytest.mark.parametrize("max_seq", [None, 1, 2, 31, 32, 33, 101, 102])
def test_parse_kernel_run_edges(cuda_device, max_seq):
    """The parser's runs of 3-byte sequences and chains of short ones at
    their edges: malformed offsets inside them, runs and chains ending
    exactly at the block end, length extensions, and widths inside a
    run. Memory of the tables' size is
    filled with garbage and freed first, so the caching allocator hands
    it to the wrapper's ``torch.empty``: the kernel writes every entry."""
    c, cl = layout.to_device_layout(testing.run_blocks(), device=cuda_device)
    s = max_seq or sequences.max_seq_for(int(cl.max()))
    junk = torch.full((6, c.shape[0], s), 0x5A5A5A5A, dtype=torch.int32,
                      device=cuda_device)
    del junk
    kern = sequences.parse_sequences(c, cl, max_seq)
    plain = sequences.parse_plain(c, cl, kern[0].shape[2])
    for k, p in zip(kern, plain):
        assert torch.equal(k, p)
    if max_seq is None:
        bad = testing.RUN_MALFORMED
        assert kern[1][:bad].tolist() == [sequences.PARSE_MALFORMED] * bad


def _pack_rows(device, shift):
    """``testing.pack_cases`` as rows of random bytes, the source rows
    ``shift`` bytes into a wider buffer."""
    rng = np.random.default_rng(shift)
    cases = testing.pack_cases()
    n, width = len(cases), layout.row_stride(70000)
    raw = torch.from_numpy(rng.integers(0, 256, (n, width + 16),
                                        dtype=np.uint8)).to(device)
    comp = torch.from_numpy(rng.integers(0, 256, (n, width),
                                         dtype=np.uint8)).to(device)
    lens, comp_lens = (torch.tensor(c, dtype=torch.int32, device=device)
                       for c in zip(*cases))
    return raw[:, shift:shift + width], lens, comp, comp_lens


@pytest.mark.parametrize("shift", [0, 3])
def test_frame_pack_kernel_matches_plain(cuda_device, shift):
    src, lens, comp, comp_lens = _pack_rows(cuda_device, shift)
    before = sharded.FRAME_PACK.launches
    body, total = sharded.frame_body_packed(src, lens, comp, comp_lens)
    assert sharded.FRAME_PACK.launches == before + 1
    want, want_total = sharded.frame_body_packed_plain(src, lens, comp,
                                                       comp_lens)
    assert total == want_total and torch.equal(body, want)


def test_frame_pack_rejects_lengths_past_rows(cuda_device):
    src, lens, comp, comp_lens = _pack_rows(cuda_device, 0)
    for bad in ((src[:, :1000], lens, comp, comp_lens),
                (src, lens, comp[:, :1000], comp_lens)):
        with pytest.raises(ValueError):
            sharded.frame_body_packed(*bad)


@pytest.mark.parametrize("out_max", [64, 4096, 70000])
def test_segment_kernel_matches_plain(cuda_device, out_max):
    rng = np.random.default_rng(out_max)
    blocks, (c, cl) = _comp_batch(cuda_device, rng, 64)
    tables, n_seq, _ = sequences.parse_sequences(c, cl)
    bad = tables.clone()
    rows = torch.nonzero(n_seq > 1).flatten()[:12]
    bad[1, rows[:6], 0] = c.shape[1]          # literals past the block
    # the second sequence's literals before the first one's end
    bad[0, rows[6:], 1] = bad[3, rows[6:], 0] + bad[5, rows[6:], 0] - 1
    for t in (tables, bad):
        bufs = [torch.full((c.shape[0], out_max + 64), 0xA5, dtype=torch.uint8,
                           device=cuda_device) for _ in range(2)]
        before = segment_decode.SEGMENT.launches
        _, err = segment_decode.decompress_segments(c, cl, n_seq, t, out_max,
                                                    out=bufs[0])
        assert segment_decode.SEGMENT.launches == before + 1
        _, want = segment_decode.decompress_segments_plain(c, cl, n_seq, t,
                                                           out_max, out=bufs[1])
        assert torch.equal(err, want)
        assert torch.equal(bufs[0], bufs[1])
        assert bool((bufs[0][:, out_max:] == 0xA5).all())
    assert bool((err[rows] == codec.ERR_MALFORMED).all())
    if out_max == 70000:
        out = segment_decode.decompress_blocks(
            layout.from_device_layout(c, cl)[:len(blocks)], out_max)
        assert out == blocks


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, (1 << 64) - 1])
def test_stream_update_kernels_match_plain(cuda_device, seed):
    rng = np.random.default_rng(seed & 0xFF)
    data = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    stage = xxhash_stream.STAGE_BYTES
    cuts = [0, 1, 15, 16, 17, 31, 32, 33, 40, 1000, 65536, stage - 16, stage,
            stage + 16, 4 * stage + 16]
    for state_cls, ref in ((xxhash_stream.StreamState32, xxhash_ref.xxh32),
                           (xxhash_stream.StreamState64, xxhash_ref.xxh64)):
        kern = state_cls(seed, cuda_device)
        plain = state_cls(seed, "cpu")
        pos = 0
        for n in cuts + [len(data)]:
            for st in (kern, plain):
                st.update(data[pos:pos + n])
            pos += n
            assert kern.lanes.cpu().tolist() == plain.lanes.tolist()
            assert kern.digest() == plain.digest()
        assert kern.digest() == ref(data, 0, len(data), seed)
    assert xxhash_stream.XXH32_STREAM.launches >= 1
    assert xxhash_stream.XXH64_STREAM.launches >= 1


def test_stream_pipeline_on_the_card(cuda_device):
    rng = np.random.default_rng(12)
    data = rng.integers(0, 8, 3 * 65536 + 999, dtype=np.uint8).tobytes()
    build.reset_launch_counts()
    out = io.BytesIO()
    compress_stream(io.BytesIO(data), out, engine="cuda", batch_blocks=2)
    assert out.getvalue() == compress_frame_packed(data, device="cpu") == \
        compress_frame_packed(data, device=cuda_device)
    for engine in ("segment", "cuda"):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(out.getvalue()), back, engine=engine)
        assert back.getvalue() == data
    counts = build.launch_counts()
    for k in ("lz4_compress", "lz4_decode", "lz4_parse", "segment_decode",
              "xxh32_stream", "frame_pack"):
        assert counts[k] >= 1, k


def test_packed_entry_points_match_cpu(cuda_device):
    from lz4_tpu_torch.api import cuda_instances as ci
    rng = np.random.default_rng(13)
    data = (rng.integers(0, 4, 3 * 65536, dtype=np.uint8).tobytes()
            + rng.integers(0, 256, 70000, dtype=np.uint8).tobytes())
    got = ci.compress_fast_packed(data, 65536, device=cuda_device)
    want = ci.compress_fast_packed(data, 65536, device="cpu")
    assert got[0] == want[0] and got[1].tolist() == want[1].tolist()
    assert got[2].tolist() == want[2].tolist()
    dest, lens = ci.decompress_safe_packed(*got, 65536, device=cuda_device)
    assert (dest, lens.tolist()) == (
        ci.decompress_safe_packed(*got, 65536, device="cpu")[0],
        [65536] * 4 + [70000 - 65536])
    assert ci.compress_fast_packed(b"", 65536, device=cuda_device)[0] == b""


def _decode_outcome(frame, engine, batch_blocks, device):
    out = io.BytesIO()
    try:
        decompress_stream(io.BytesIO(frame), out, engine=engine,
                          batch_blocks=batch_blocks, device=device)
    except Exception as e:      # noqa: BLE001 - compared with the CPU's
        return out.getvalue(), f"{type(e).__name__}: {e}"
    return out.getvalue(), None


@pytest.mark.parametrize("batch_blocks", [1, 4])
def test_stream_buffer_reuse_and_ragged_frames(cuda_device, batch_blocks):
    """Small batches reuse the pinned and device buffers many times while
    the content hash runs on its own stream; a hand-built frame with block
    checksums and short blocks anywhere decodes with one K3 launch a
    batch, its content-hash remainders carried across batches."""
    rng = np.random.default_rng(14)
    data = sharded.make_blocks(24, 65536, 3).tobytes()[:24 * 65536 - 99]
    out = io.BytesIO()
    compress_stream(io.BytesIO(data), out, engine="cuda",
                    batch_blocks=batch_blocks)
    assert out.getvalue() == compress_frame_packed(data, device=cuda_device)
    sizes = testing.ragged_sizes(rng, 23)
    pos = np.cumsum([0] + sizes)
    raws = [data[a:b] for a, b in zip(pos[:-1], pos[1:])]
    comps = Lz4Factory.cuda_instance(cuda_device).fast_compressor() \
        .compress_batch(raws)
    frame = testing.build_frame(raws, comps)
    for engine in ("cuda", "segment"):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(out.getvalue()), back, engine=engine,
                          batch_blocks=batch_blocks)
        assert back.getvalue() == data
        build.reset_launch_counts()
        assert _decode_outcome(frame, engine, batch_blocks, cuda_device) == \
            (b"".join(raws), None)
        assert build.launch_counts()["xxh32"] == -(-len(raws) // batch_blocks)


@pytest.mark.parametrize("after", ["none", "oversized", "premature"])
def test_block_checksum_mismatch_matches_cpu(cuda_device, after):
    rng = np.random.default_rng(15)
    sizes = testing.ragged_sizes(rng, 13)
    data = sharded.make_blocks(13, 65536, 4).tobytes()
    pos = np.cumsum([0] + sizes)
    raws = [data[a:b] for a, b in zip(pos[:-1], pos[1:])]
    comps = Lz4Factory.cuda_instance("cpu").fast_compressor() \
        .compress_batch(raws)
    frame = bytearray(testing.build_frame(raws, comps))
    at, spans = 7, []
    while struct.unpack_from("<I", frame, at)[0]:
        size = struct.unpack_from("<I", frame, at)[0] & 0x7FFFFFFF
        spans.append((at, at + 4 + size))
        at += 8 + size
    frame[spans[5][1]] ^= 1
    if after == "oversized":
        struct.pack_into("<I", frame, spans[6][0], 65537)
    elif after == "premature":
        frame = frame[:spans[6][1] - 3]
    for engine in ("cuda", "segment"):
        got = _decode_outcome(bytes(frame), engine, 4, cuda_device)
        assert got == _decode_outcome(bytes(frame), engine, 4, "cpu")
        assert got == (b"".join(raws[:4]),
                       "Lz4FrameError: Block checksum mismatch")


@pytest.mark.parametrize("cls, ref", [
    (xxhash_stream.StreamState32, xxhash_ref.xxh32),
    (xxhash_stream.StreamState64, xxhash_ref.xxh64)])
def test_stream_state_absorbs_tensors_on_its_stream(cuda_device, cls, ref):
    """Updates from tensors on the card, of every length around a stripe,
    each freed at once and its memory handed to new tensors that are
    overwritten: the digest is the host hash of the bytes."""
    rng = np.random.default_rng(16)
    data = rng.integers(0, 256, 3 << 20, dtype=np.uint8).tobytes()
    st, host = cls(5, cuda_device), cls(5, "cpu")
    pos = 0
    for k in [1, 15, 16, 17, 31, 33, 1 << 20, 7, (1 << 20) + 5, 100, 3]:
        piece = data[pos:pos + k]
        pos += k
        t = torch.frombuffer(bytearray(piece), dtype=torch.uint8).to(
            cuda_device)
        st.update(t)
        host.update(piece)
        del t
        torch.full((k + 64,), 0xEE, dtype=torch.uint8, device=cuda_device)
    st.update(data[pos:pos + 1000])
    host.update(data[pos:pos + 1000])
    pos += 1000
    assert st.lanes.cpu().tolist() == host.lanes.tolist()
    assert st.digest() == host.digest() == ref(data[:pos], 0, pos, 5)


def test_staging_is_grow_only_and_keeps_empty_rows_readable(cuda_device):
    st = layout.staging(cuda_device, layout.UP)
    a = st.take(1000)
    st.upload(a, cuda_device)
    b = st.take(500)
    assert a.data_ptr() == b.data_ptr() and b.is_pinned()
    rows, lens = layout.to_device_layout([b"", b"abc", b""],
                                         device=cuda_device)
    assert rows[[0, 2], 0].tolist() == [0, 0]
    _, read, err = codec.decompress_fast_batch(rows, lens, 0)
    assert err[[0, 2]].tolist() == [0, 0]
    data = np.random.default_rng(17).integers(0, 256, (5, 37), np.uint8)
    lens_np = np.array([0, 1, 16, 36, 37], np.int32)
    h = XXHashFactory.cuda_instance(cuda_device).hash32().hash_batch(
        data, lens_np, 3)
    assert h.device.type == "cuda"
    assert h.cpu().tolist() == [xxhash_ref.as_u32(xxhash_ref.xxh32(
        r.tobytes(), 0, int(k), 3)) for r, k in zip(data, lens_np)]


def _hc_batch(device):
    rng = np.random.default_rng(43)
    blocks = testing.hc_edge_blocks(rng) + [
        testing.block_of(rng, k, n) for k in testing.HC_KINDS
        for n in (0, 13, 3000, 70000)]
    return layout.to_device_layout(blocks, device=device)


@pytest.mark.parametrize("level", [1, 9, 17])
def test_hc_kernel_matches_plain(cuda_device, level):
    """K6 against its plain version on the HC edge blocks and blocks of
    each kind up to 70,000 bytes: whole rows, one launch."""
    src, lens = _hc_batch(cuda_device)
    cap = max_compressed_length(70000)
    before = hc.HC.launches
    kern = hc.compress_hc_batch(src, lens, cap, level)
    assert hc.HC.launches == before + 1
    plain = hc.compress_hc_plain(src, lens, cap, level)
    _assert_codec_equal(kern, plain)
    assert torch.equal(kern[0], plain[0])


@pytest.mark.parametrize("level", [1, 5, 9, 17])
def test_hc_kernel_collision_blocks(cuda_device, level):
    """K6 against its plain version on ``testing.hc_collision_blocks``,
    where the speculated walk's links fail (levels 5 on) and a bucket's
    predecessor lies more than 65,535 positions back: whole rows."""
    src, lens = layout.to_device_layout(
        testing.hc_collision_blocks(np.random.default_rng(43)),
        device=cuda_device)
    cap = max_compressed_length(int(lens.max()))
    kern = hc.compress_hc_batch(src, lens, cap, level)
    plain = hc.compress_hc_plain(src, lens, cap, level)
    _assert_codec_equal(kern, plain)
    assert torch.equal(kern[0], plain[0])


@pytest.mark.parametrize("dest_cap", [0, 40, 300, 1000])
def test_hc_kernel_tight_dest_cap(cuda_device, dest_cap):
    """Caps that some rows do not fit: the same rows fail, with length 0."""
    src, lens = _hc_batch(cuda_device)
    for level in (1, 9):
        kern = hc.compress_hc_batch(src, lens, dest_cap, level)
        _assert_codec_equal(kern, hc.compress_hc_plain(src, lens, dest_cap,
                                                       level))
        assert bool(kern[2].any())


def test_hc_on_the_card_never_runs_k2(cuda_device):
    """The tier's HC and the stream at an HC level run K6 and not K2, and
    give the CPU's bytes."""
    rng = np.random.default_rng(44)
    data = rng.integers(0, 6, 2 * 65536 + 999, dtype=np.uint8).tobytes()
    blocks = [data[i:i + 65536] for i in range(0, len(data), 65536)]
    lz4 = Lz4Factory.cuda_instance()     # its self-test runs K2 and K6
    build.reset_launch_counts()
    got = lz4.high_compressor(9).compress_batch(blocks)
    out = io.BytesIO()
    compress_stream(io.BytesIO(data), out, level=9, batch_blocks=2)
    counts = build.launch_counts()
    assert counts["lz4_hc"] >= 3 and counts["lz4_compress"] == 0
    assert got == Lz4Factory.cuda_instance("cpu").high_compressor(
        9).compress_batch(blocks)
    cpu = io.BytesIO()
    compress_stream(io.BytesIO(data), cpu, level=9, batch_blocks=2,
                    device="cpu")
    assert out.getvalue() == cpu.getvalue()
    back = io.BytesIO()
    decompress_stream(io.BytesIO(out.getvalue()), back)
    assert back.getvalue() == data


# ---------------------------------------------------------------------------
# dist: ranks on the card
# ---------------------------------------------------------------------------

def test_cuda_stream_takes_cards_and_refuses_the_rest(cuda_device):
    t = torch.empty(1, device=cuda_device)
    assert layout.cuda_stream(t) == torch.cuda.current_stream().cuda_stream
    for bad in (torch.device("cuda", torch.cuda.device_count()),
                torch.empty(1).device):
        with pytest.raises(ValueError):
            layout.cuda_stream(bad)


def test_one_nccl_rank_matches_one_device(cuda_device, tmp_path):
    import torch.distributed as tdist
    from lz4_tpu_torch import dist

    rng = np.random.default_rng(21)
    data = rng.integers(0, 8, 5 * 65536 + 77, dtype=np.uint8).tobytes()
    blocks = [data[i:i + 65536] for i in range(0, len(data), 65536)]
    tdist.init_process_group("nccl", init_method=(tmp_path / "r").as_uri(),
                             world_size=1, rank=0)
    try:
        mesh = dist.block_mesh(cuda_device)
        assert (mesh.backend, mesh.world_size) == ("nccl", 1)
        assert dist.shard_compress_blocks(blocks, mesh) == \
            Lz4Factory.cuda_instance().fast_compressor().compress_batch(blocks)
        assert dist.compress_frame_sharded_packed(data, 65536, mesh) == \
            compress_frame_packed(data, device=cuda_device)
        assert dist.compress_frame_sharded(data, 65536, mesh) == \
            compress_frame_packed(data, device=cuda_device)
        build.reset_launch_counts()
        st = dist.sharded_roundtrip_step(mesh, 64, 65536, seed=5)
        counts = build.launch_counts()
        assert [counts[k] for k in ("lz4_compress", "lz4_decode", "xxh32",
                                    "frame_pack")] == [1, 1, 1, 1]
        one = roundtrip_step(64, 65536, seed=5, device=cuda_device)
        assert bool(st.ok.all()) and torch.equal(st.hashes, one.hashes)
        assert torch.equal(st.offsets, one.offsets)
        assert torch.equal(st.body, one.body[:one.body_total])
        assert set(st.phase_ms) == {"compress", "offsets", "checksum",
                                    "decode", "pack", "exchange"}
    finally:
        tdist.destroy_process_group()


def test_two_ranks_share_the_card(cuda_device, tmp_path):
    from lz4_tpu_torch import dryrun_multigpu
    from lz4_tpu_torch.dist import multihost

    n_bytes = 3 * 65536 + 1234
    out = dryrun_multigpu(2, share_card=True, data_bytes=n_bytes,
                          blocks_per_rank=4, block_len=65536,
                          timeout=240.0, workdir=tmp_path)
    data = multihost.dryrun_data(n_bytes)
    expect = compress_frame_packed(data, device=cuda_device)
    assert out["frame"] == expect and out["packed_frame"] == expect
    assert out["step"]["ok"] and out["step"]["blocks"] == 8
    if torch.cuda.device_count() < 2:
        with pytest.raises(RuntimeError, match="share_card"):
            dryrun_multigpu(2)


def test_scaling_modules_share_the_card(cuda_device, tmp_path):
    """Both scaling modules at 8 x 64 KiB, two ranks sharing ``cuda:0``:
    their digests equal K2's output in this process on the same rows."""
    from lz4_tpu_torch.dist import multihost_scaling, scaling

    src, lens = sharded.upload_blocks(
        multihost_scaling.scaling_blocks(8, 65536), cuda_device)
    comp, comp_lens, err = codec.compress_fast_batch(
        src, lens, max_compressed_length(65536))
    assert not bool(err.any())
    blocks = layout.from_device_layout(comp, comp_lens)
    whole = multihost_scaling.sha256_of(blocks)
    out = multihost_scaling.measure(8, 65536, 2, timeout=240.0, trials=1,
                                    share_card=True, workdir=tmp_path / "m")
    assert out["placement"] == "cuda:0 shared by 2 ranks, gloo"
    assert out["sha256"] == whole
    assert out["share_sha256"] == multihost_scaling.sha256_of(blocks[:4])
    assert min(out["t_multi_s"], out["t_os_s"], out["t_ref_s"]) > 0
    res = scaling.measure(8, 65536, (1, 2), trials=2, share_card=True,
                          timeout=240.0, workdir=tmp_path / "s")
    assert res["sha256"] == {"1": whole, "2": whole}
    assert res["physical_cores"] == 1 and res["headline_width"] == 1
    assert res["placement"]["2"] == "cuda:0 shared by 2 ranks, gloo"
    assert res["control_relative_ratio"]["2"] is None   # 2 ranks, 1 card


def test_ranks_need_a_card_each_unless_they_share(cuda_device, tmp_path):
    from lz4_tpu_torch.dist import multihost, multihost_scaling, scaling

    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match="share_card"):
        multihost._placement(n, "cuda", False)
    with pytest.raises(RuntimeError, match="share_card"):
        multihost_scaling.measure(8, 65536, n, trials=1, workdir=tmp_path)
    assert not any(tmp_path.iterdir())
    out = scaling.measure(8, 4096, (1, n), trials=1, workdir=tmp_path)
    assert set(out["times_s"]) == {"1"}     # the width past the cards left out
    assert out["placement"] == {"1": "cuda:0, one rank"}



@pytest.mark.parametrize("out_max", [70000, 1000, 64])
def test_decode_hist_kernel_matches_plain(cuda_device, out_max):
    """K1 with a history a row: matches at the history's start, straddling
    its end, periods 1-40 from its tail, sources in it within the ring and
    past it, null offsets, matches before it (MALFORMED) and fuzz, at
    ``testing.HIST_LENS``; tight caps; guards and histories untouched."""
    rng = np.random.default_rng(11)
    cases = testing.history_blocks(rng)
    comp = [testing.encode_block(s, t) for _, s, t in cases]
    want = [testing.expand_block(s, t, h) for h, s, t in cases]
    hists = [h for h, _, _ in cases]
    over = testing.overreach_blocks(rng)
    fuzz = testing.fuzz_blocks(rng, comp, 256)
    blocks = comp + [b for _, b in over] + fuzz
    hists += [h for h, _ in over] + [hists[i % len(cases)]
                                     for i in range(len(fuzz))]
    c, cl = layout.to_device_layout(blocks, device=cuda_device)
    win, wl = testing.windows(hists, cuda_device)
    before = win.clone()
    bufs = [torch.full((c.shape[0], out_max + 64), 0xA5, dtype=torch.uint8,
                       device=cuda_device) for _ in range(2)]
    launches = codec.DECODE_HIST.launches
    kern = codec.decompress_safe_hist_batch(c, cl, out_max, win, wl,
                                            out=bufs[0])
    assert codec.DECODE_HIST.launches == launches + 1
    plain = codec.decompress_safe_hist_plain(c, cl, out_max, win, wl,
                                             out=bufs[1])
    _assert_codec_equal(kern, plain, all_lens=False)
    for buf in bufs:
        assert bool((buf[:, out_max:] == 0xA5).all())
    assert torch.equal(win, before)
    if out_max == 70000:
        n = len(want)
        assert kern[2][:n + len(over)].tolist() == \
            [codec.OK] * n + [codec.ERR_MALFORMED] * len(over)
        assert layout.from_device_layout(kern[0][:n], kern[1][:n]) == want


def test_decode_hist_kernel_zero_is_k1(cuda_device):
    """History length 0: the window kernel equals K1 code for code and
    byte for byte."""
    rng = np.random.default_rng(3)
    src, lens = layout.to_device_layout(testing.mixed_blocks(rng, EDGE_SIZES),
                                        device=cuda_device)
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    blocks = layout.from_device_layout(comp, comp_lens)
    c, cl = layout.to_device_layout(
        blocks + testing.fuzz_blocks(rng, blocks, 256), device=cuda_device)
    win, wl = testing.windows([b""] * c.shape[0], cuda_device)
    for out_max in (1, 1000, 70000):
        a = codec.decompress_safe_hist_batch(c, cl, out_max, win, wl)
        b = codec.decompress_safe_batch(c, cl, out_max)
        assert torch.equal(a[2], b[2])
        ok = a[2] == 0
        assert torch.equal(a[1][ok], b[1][ok])
        assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("shared", [False, True])
def test_compress_dict_kernel_matches_plain(cuda_device, shared):
    """K2 with a dictionary a row (or one shared row, stride 0) against the
    plain version at ``testing.HIST_LENS``, full and tight caps; then the
    output decoded back by K1 with the same windows."""
    rng = np.random.default_rng(13)
    blocks, dicts = [], []
    one = testing.block_of(rng, "text", 65536)
    for hl in testing.HIST_LENS:
        d = one[-hl:] if shared and hl else (b"" if shared else
                                              testing.block_of(rng, "text", hl))
        if shared and hl != 65536:
            continue
        for size in (0, 5, 13, 1000, 65536, 70000):
            for kind in testing.KINDS:
                b = testing.block_of(rng, kind, size)
                blocks.append((d[-3000:] + b)[:size] if kind == "alphabet4"
                              else b)
                dicts.append(d)
    src, lens = layout.to_device_layout(blocks, device=cuda_device)
    win, wl = testing.windows(dicts[:1] if shared else dicts, cuda_device)
    if shared:
        wl = torch.full((len(blocks),), len(dicts[0]), dtype=torch.int32,
                        device=cuda_device)
    for cap in (600, max_compressed_length(70000)):
        launches = codec.COMPRESS_DICT.launches
        kern = codec.compress_dict_batch(src, lens, cap, win, wl)
        assert codec.COMPRESS_DICT.launches == launches + 1
        plain = codec.compress_dict_plain(src, lens, cap, win, wl)
        _assert_codec_equal(kern, plain)
    out, out_lens, err = codec.decompress_safe_hist_batch(   # the full cap's
        kern[0], kern[1], 70000, win, wl)
    assert not bool(err.any())
    assert layout.from_device_layout(out, out_lens) == blocks


def test_linked_blocks_on_the_card(cuda_device):
    """A linked frame's blocks: compressed in one K2-with-dictionary launch
    against the content before each (a strided view), then decoded a block
    at a time into one buffer whose earlier output is the history."""
    rng = np.random.default_rng(12)
    raw = testing.block_of(rng, "text", 40 * 4096 - 99)
    comps = testing.linked_blocks(raw, 4096, cuda_device)
    out = torch.zeros((len(raw) + 4096,), dtype=torch.uint8,
                      device=cuda_device)
    pos = 0
    for blk in comps:
        c, cl = layout.to_device_layout([blk], device=cuda_device)
        h0 = max(0, pos - 65536)
        hist = out[h0:max(pos, 1)].view(1, -1)
        hl = torch.tensor([pos - h0], dtype=torch.int32, device=cuda_device)
        _, n, e = codec.decompress_safe_hist_batch(
            c, cl, 4096, hist, hl, out=out[pos:pos + 4096].view(1, -1))
        assert int(e[0]) == 0
        pos += int(n[0])
    assert out[:pos].cpu().numpy().tobytes() == raw


@pytest.mark.parametrize("cap", [None, 40])
def test_parallel_kernel_matches_plain(cuda_device, cap):
    """K7 against its plain version on the edge blocks, the long ones and
    the window blocks, with every row tail 0xA5; one launch."""
    rng = np.random.default_rng(61)
    blocks = (testing.parallel_blocks(rng)
              + testing.parallel_blocks(rng, testing.PARALLEL_BIG_SIZES)[::5]
              + testing.window_clamp_blocks())
    src, lens = layout.to_device_layout(blocks, device=cuda_device)
    col = torch.arange(src.shape[1], device=cuda_device)
    src[col >= lens[:, None]] = 0xA5
    cap = max_compressed_length(src.shape[1]) if cap is None else cap
    before = parallel_compress.PARALLEL.launches
    out, out_lens = parallel_compress.compress_parallel_batch(src, lens, cap)
    assert parallel_compress.PARALLEL.launches == before + 1
    want = parallel_compress.compress_parallel_plain(src, lens, cap)
    assert torch.equal(out_lens, want[1])
    assert torch.equal(out, want[0])


@pytest.mark.parametrize("max_depth", [0, 1, 2, 3, 32])
def test_gather_kernel_matches_plain(cuda_device, max_depth):
    """K8 against its plain version on the parser's sentinel tables of K2's
    blocks and the chain blocks; one launch."""
    rng = np.random.default_rng(62)
    raws = testing.mixed_blocks(rng, EDGE_SIZES)
    src, lens = layout.to_device_layout(raws, device=cuda_device)
    comp, clens, _ = codec.compress_fast_batch(src, lens,
                                               max_compressed_length(70000))
    blocks = layout.from_device_layout(comp, clens)
    blocks += [c for c, _ in testing.chain_blocks(rng)]
    blocks.append(testing.boundary_blocks()[0])
    c, cl = layout.to_device_layout(blocks, device=cuda_device)
    tables, n_seq, _ = sequences.parse_sequences(c, cl, sentinel_tails=True)
    assert bool((n_seq > 0).all())
    before = gather_decode.GATHER.launches
    got = gather_decode.gather_decompress_batch(c, *tables, 70000, max_depth)
    assert gather_decode.GATHER.launches == before + 1
    want = gather_decode.gather_decompress_plain(c, *tables, 70000, max_depth)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["window rows", "one byte, 4 MiB + 1"])
def test_parallel_windows_match_plain(cuda_device, case):
    """K7 on rows cut into windows: three 64 KiB windows and 17 bytes
    (runs of period 1-4 across every window end, a literal run over
    windows, one repeated byte, rows about one and two windows), and one
    byte over 4 MiB + 1 (one match sequence); one launch."""
    rows = (testing.window_rows(np.random.default_rng(64))
            if case == "window rows" else [b"\x61" * ((4 << 20) + 1)])
    src, lens = layout.to_device_layout(rows, device=cuda_device)
    cap = max_compressed_length(src.shape[1])
    before = parallel_compress.PARALLEL.launches
    out, out_lens = parallel_compress.compress_parallel_batch(src, lens, cap)
    assert parallel_compress.PARALLEL.launches == before + 1
    want = parallel_compress.compress_parallel_plain(src, lens, cap)
    assert torch.equal(out_lens, want[1])
    assert torch.equal(out, want[0])
    back = codec.decompress_safe_batch(out, out_lens, src.shape[1])
    assert not bool(back[2].any())
    assert layout.from_device_layout(back[0], back[1]) == rows


@pytest.mark.parametrize("max_depth", [0, 1, 2, 3, 32])
def test_gather_link_tables_match_plain(cuda_device, max_depth):
    """K8 on ``testing.link_tables`` (chains of exactly 2^k - 1 and 2^k
    links, forward pointers, a cycle, a self-parent byte, a null offset) at
    out_len 40 (synchronous rounds below max_depth 6) and 8 (in place from
    max_depth 3)."""
    for out_len in (40, 8):
        tables, comp = testing.link_tables(out_len)
        t = torch.from_numpy(tables).to(cuda_device)
        c = torch.from_numpy(comp).to(cuda_device)
        got = gather_decode.gather_decompress_batch(c, *t, out_len, max_depth)
        want = gather_decode.gather_decompress_plain(c, *t, out_len,
                                                     max_depth)
        assert torch.equal(got, want), out_len


def test_parallel_engine_round_trip(cuda_device):
    """The ``parallel`` engine on the card: K7 compresses, never K2; the
    frame equals the one put together from ``compress_blocks``; both
    engines restore it."""
    rng = np.random.default_rng(63)
    data = b"".join(testing.block_of(rng, k, 100000)
                    for k in ("text", "alphabet4", "incompressible"))
    build.reset_launch_counts()
    sink = io.BytesIO()
    compress_stream(io.BytesIO(data), sink, engine="parallel")
    counts = build.launch_counts()
    assert counts["parallel_compress"] == 1 and counts["lz4_compress"] == 0
    blocks = [data[i:i + 65536] for i in range(0, len(data), 65536)]
    comps = parallel_compress.compress_blocks(blocks)
    assert sink.getvalue() == testing.build_frame(blocks, comps,
                                                  block_checksum=False)
    for engine in ("cuda", "segment"):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(sink.getvalue()), back, engine=engine)
        assert back.getvalue() == data


def _linked_rows(device, rng):
    """Payload rows of linked blocks on ``device``: the edge blocks of K2,
    boundary, chain, history, overreach and null-offset blocks, fuzz, some
    flagged raw."""
    raws = testing.mixed_blocks(rng, EDGE_SIZES)
    src, lens = layout.to_device_layout(raws, device=device)
    comp, clens, _ = codec.compress_fast_batch(src, lens,
                                               max_compressed_length(70000))
    blocks = layout.from_device_layout(comp, clens)
    blocks += testing.boundary_blocks()
    blocks += [c for c, _ in testing.chain_blocks(rng)]
    blocks += [testing.encode_block(s, t)
               for _, s, t in testing.history_blocks(rng)]
    blocks += [b for _, b in testing.overreach_blocks(rng)]
    blocks += testing.fuzz_blocks(rng, blocks, 60)
    c, cl = layout.to_device_layout(blocks, device=device)
    raw = torch.from_numpy(rng.random(len(blocks)) < 0.1).to(device)
    return c, cl, raw


@pytest.mark.parametrize("dest_cap, max_seq", [
    (65536, None), (100, None), (0, None), (65536, 5)])
def test_linked_walk_kernel_matches_plain(cuda_device, dest_cap, max_seq):
    """The linked walk against its plain version: codes, lengths, reach
    and each block's records; one launch."""
    rng = np.random.default_rng(64)
    c, cl, raw = _linked_rows(cuda_device, rng)
    width = max_seq or linked_decode.table_width(cl.tolist(), raw.tolist())
    before = linked_decode.WALK.launches
    got = linked_decode.walk_linked(c, cl, raw, dest_cap, width)
    assert linked_decode.WALK.launches == before + 1
    want = linked_decode.walk_linked_plain(c, cl, raw, dest_cap, width)
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x, y)
    for i, k in enumerate(got[1].tolist()):
        assert torch.equal(got[0][:, i, :k], want[0][:, i, :k]), i


def _long_run_blocks(rng) -> list[bytes]:
    """Literal runs over many chunks, 0xFF runs longer than a chunk (both
    lengths), the last literals in a late chunk, and those cut short."""
    def lits(k):
        return rng.integers(0, 256, k, dtype=np.uint8).tobytes()

    good = [testing.encode_block([(lits(5000), 1, 4)], lits(9)),
            testing.encode_block([(lits(300_000), 3, 40)], lits(700)),
            testing.encode_block([(lits(10), 1, 200_000)], lits(9)),
            testing.encode_block([(b"ab", 2, 9)] * 400, b"q" * 3000),
            testing.encode_block([(b"", 1, 10)] * 50 + [(bytes(40_000), 3, 300)]
                                 + [(b"z", 1, 5)] * 40, b"tail tail")]
    return good + [g[:len(g) - k] for g in good for k in (1, 9, 300)
                   if len(g) > k]


@pytest.mark.parametrize("chunk", [16, 64, 333, 4096])
@pytest.mark.parametrize("dest_cap, max_seq", [
    (400_000, None), (65536, None), (100, None), (65536, 5)])
def test_chunked_walk_matches_plain(cuda_device, chunk, dest_cap, max_seq):
    """The chunked walk at chunks down to 16 bytes, every block cut
    (seams inside tokens, offsets and 0xFF runs; 32 offsets a step of a
    chunk's tables, so pointer jumping over shuffles inside a step)
    against the plain walk, exact, on the edge blocks and blocks of long
    runs; one launch. The shipped layout (blocks of up to 64 KiB one
    chunk) and the first design (a warp a block) give the same."""
    rng = np.random.default_rng(66)
    c, cl, raw = _linked_rows(cuda_device, rng)
    extra = _long_run_blocks(rng)
    blocks = layout.from_device_layout(c, cl) + extra
    c, cl = layout.to_device_layout(blocks, device=cuda_device)
    raw = torch.cat([raw, torch.zeros(len(extra), dtype=torch.bool,
                                      device=cuda_device)])
    host = (cl.tolist(), raw.tolist())
    width = max_seq or linked_decode.table_width(*host)
    before = linked_decode.WALK.launches
    got = linked_decode._walk_cuda(c, cl, raw, dest_cap, width, host, chunk,
                                   0)
    assert linked_decode.WALK.launches == before + 1
    want = linked_decode.walk_linked_plain(c, cl, raw, dest_cap, width)
    _assert_walks_equal(got, want)
    _assert_walks_equal(linked_decode.walk_linked(c, cl, raw, dest_cap, width,
                                                  host), want)
    _assert_walks_equal(linked_decode._walk_cuda(
        c, cl, raw, dest_cap, width, host, chunk, WARP_ONLY), want)


# a threshold past every block: the first design alone, a warp a block
WARP_ONLY = 1 << 31


def _assert_walks_equal(got, want):
    for x, y in zip(got[1:], want[1:]):
        assert torch.equal(x, y)
    for i, k in enumerate(want[1].tolist()):
        assert torch.equal(got[0][:, i, :k], want[0][:, i, :k]), i


@pytest.mark.parametrize("bs", [65536, 4 << 20])
def test_chunked_walk_on_linked_frames(cuda_device, bs):
    """A linked frame's blocks (``testing.linked_blocks`` of a4, text and
    random content) walked in chunks: equal to the plain walk on its first
    block and to the warp walk on every block, exactly."""
    rng = np.random.default_rng(67)
    data = b"".join(testing.block_of(rng, k, 3 << 20)
                    for k in ("alphabet4", "text", "incompressible"))
    raws = [data[i:i + bs] for i in range(0, len(data), bs)]
    comps = testing.linked_blocks(data, bs, cuda_device)
    c, cl = layout.to_device_layout(testing.payloads(raws, comps),
                                    device=cuda_device)
    raw = torch.tensor([len(p) >= len(r) for r, p in zip(raws, comps)],
                       device=cuda_device)
    host = (cl.tolist(), raw.tolist())
    width = linked_decode.table_width(*host)
    got = linked_decode.walk_linked(c, cl, raw, bs, width, host)
    assert not bool(got[3].any())
    _assert_walks_equal(got, linked_decode._walk_cuda(
        c, cl, raw, bs, width, host, linked_decode.CHUNK, WARP_ONLY))
    want = linked_decode.walk_linked_plain(c[:1], cl[:1], raw[:1], bs, width)
    _assert_walks_equal(tuple(t[:, :1] if t.dim() == 3 else t[:1]
                              for t in got), want)


@pytest.mark.parametrize("case", ["literal_runs", "long_matches", "fault"])
def test_long_run_frames_on_the_card(cuda_device, case):
    """The linked frames of ``test_torch_linked_walk_chunks.py``'s
    ``test_frames_with_long_runs`` (``testing.long_run_frame``, which the
    CPU test holds against the JAX package's reader) decoded on the card
    (the ``literal_runs`` blocks compress to over 64 KiB, so the walk cuts
    them into chunks): bytes written and error equal the same decode on
    the CPU, exactly."""
    from lz4_tpu_torch.core.errors import Lz4Error
    from lz4_tpu_torch.streams.pipeline import decode_frames

    frame = testing.long_run_frame(case)

    def outcome(dev):
        out = io.BytesIO()
        try:
            decode_frames(io.BytesIO(frame), out, "cuda", 3, dev,
                          allow_dependent=True)
        except Lz4Error as e:
            return out.getvalue(), (type(e).__name__, str(e))
        return out.getvalue(), None

    build.reset_launch_counts()
    got = outcome(cuda_device)
    assert build.launch_counts()["linked_walk"] >= 1
    want = outcome("cpu")
    assert got == want
    assert (want[1] is None) == (case != "fault")


def test_dict_kernel_seeded_once_and_linked_rows(cuda_device):
    """K2 with a dictionary on its new paths against the plain version:
    one shared dictionary at one length (seeded once for the launch, each
    CTA's table a bulk copy), the same with a row of no dictionary (each
    CTA seeds its own), and linked rows whose dictionaries end where they
    start (a strided view of one buffer) and the same dictionaries
    copied."""
    rng = np.random.default_rng(68)
    d = testing.block_of(rng, "text", 65536)
    blocks = [(d[-3000:] + testing.block_of(rng, k, 65536))[:65536]
              if k == "alphabet4" else testing.block_of(rng, k, s)
              for s in (13, 1000, 65536, 70000) for k in testing.KINDS]
    src, lens = layout.to_device_layout(blocks, device=cuda_device)
    win = layout.upload_bytes(d, cuda_device).view(1, -1)
    cap = max_compressed_length(70000)
    for wl in (torch.full((len(blocks),), 65536, dtype=torch.int32),
               torch.tensor([0] + [4095] * (len(blocks) - 1),
                            dtype=torch.int32)):
        wl = wl.to(cuda_device)
        _assert_codec_equal(codec.compress_dict_batch(src, lens, cap, win, wl),
                            codec.compress_dict_plain(src, lens, cap, win, wl))
    bs, w = 4096, codec.WINDOW
    content = testing.block_of(rng, "text", 40 * bs - 99)
    n = -(-len(content) // bs)
    buf = torch.zeros((w + n * bs,), dtype=torch.uint8, device=cuda_device)
    buf[w:w + len(content)] = layout.upload_bytes(content, cuda_device)
    rows = buf[w:].view(n, bs)
    dicts = buf.as_strided((n, w), (bs, 1))
    ll = torch.tensor([min(bs, len(content) - i * bs) for i in range(n)],
                      dtype=torch.int32, device=cuda_device)
    dl = torch.tensor([min(i * bs, w) for i in range(n)], dtype=torch.int32,
                      device=cuda_device)
    cap = max_compressed_length(bs)
    kern = codec.compress_dict_batch(rows, ll, cap, dicts, dl)
    _assert_codec_equal(kern, codec.compress_dict_plain(rows, ll, cap, dicts,
                                                        dl))
    two = codec.compress_dict_batch(rows, ll, cap, dicts.contiguous(), dl)
    assert all(torch.equal(x, y) for x, y in zip(kern, two))


def _linked_resolve_batch(case, device):
    """A walked batch for the resolve: ``testing.linked_blocks`` of
    ``(block, w, kind)`` after a window of ``w`` bytes of the same content,
    or ``testing.resolve_case(case)``. Returns (comp, tables, n_seq,
    block_at, n_ok, n_nodes, window, node_cap, the batch's content)."""
    rng = np.random.default_rng(65)
    if isinstance(case, str):
        window, raws, comps, dest_cap, n_ok = testing.resolve_case(case, rng)
        start, content = len(window), window + b"".join(raws[:n_ok])
    else:
        block, w, kind = case
        data = testing.block_of(rng, kind, w + 40 * block + 77)
        comps = testing.linked_blocks(data, block, device)
        first = -(-w // block)       # the blocks that make the window
        raws = [data[i:i + block] for i in range(0, len(data), block)]
        start = first * block
        window = data[max(0, start - 65536):start]
        raws, comps, dest_cap, n_ok = (raws[first:], comps[first:], block,
                                       len(raws) - first)
        content = window + data[start:]
    pays = testing.payloads(raws, comps)
    raw = torch.tensor([len(c) >= len(r) for r, c in zip(raws, comps)],
                       device=device)
    c, cl = layout.to_device_layout(pays, device=device)
    win = layout.upload_bytes(window, device) if window else \
        torch.empty((0,), dtype=torch.uint8, device=device)
    tables, n_seq, out_total, code, reach = linked_decode.walk_linked(
        c, cl, raw, dest_cap)
    plan = linked_decode.frame_plan(out_total, code, reach, win.numel())
    assert int(plan[2]) == n_ok
    return (c, tables, n_seq, plan[0], plan[2], plan[3], win,
            win.numel() + len(pays) * dest_cap, content)


@pytest.mark.parametrize("case", [
    (65536, 0, "alphabet4"), (300, 5000, "alphabet4"), (65536, 65536, "text"),
    (1000, 65536, "zeros"), *testing.RESOLVE_CASES])
def test_linked_resolve_kernel_matches_plain(cuda_device, case):
    """The resolve against its plain version, one launch, on a walked
    batch of ``testing.linked_blocks`` after a window of the same content
    and on each of ``testing.resolve_case``'s (chains of distance 1-3 over
    seams, 256 short blocks reaching back, the window as the only source,
    null offsets over seams, records longer than a segment, a 4 MiB block
    cut mid-match, a failing fourth block): the batch's bytes are its
    content; the kernel's open nodes and list are as many as the records
    say (``testing.resolve_sets``), and it leaves no list entry open."""
    *args, content = _linked_resolve_batch(case, cuda_device)
    c, tables, n_seq, block_at, n_ok, n_nodes, window, cap = args
    before = linked_decode.RESOLVE.launches
    got, opened = linked_decode.resolve_linked(*args)
    assert linked_decode.RESOLVE.launches == before + 1
    want, _ = linked_decode.resolve_linked_plain(*args)
    n = int(n_nodes)
    assert int(opened[-1]) == 0
    assert torch.equal(got[:n], want[:n])
    assert got[:n].cpu().numpy().tobytes() == content
    leaves, listed = testing.resolve_sets(tables, n_seq, block_at, n_ok,
                                          window.numel(), n,
                                          linked_decode.SEGMENT)
    assert opened.tolist()[:2] == [int(leaves.sum()), int(listed.sum())]


def test_linked_resolve_in_chunks(cuda_device):
    """Room for fewer open exits than a batch has: the resolve takes them in
    chunks, in output order (of a third of them, and of one), and gives the
    same bytes and counts (4 MiB blocks: records longer than a segment, a
    4 MiB block cut mid-match); ``decode_linked_batch`` on 16 x 4 MiB of
    far matches (most bytes open exits: the list in chunks on the path)
    decodes the batch in one resolve launch."""
    for case, rooms in (("big_block", (3,)), ("long_record", (3, 1 << 30))):
        *args, content = _linked_resolve_batch(case, cuda_device)
        n = int(args[5])
        _, opened = linked_decode.resolve_linked(*args)
        need = int(opened[1])
        assert need > 3
        for k in rooms:
            got, chunked = linked_decode._resolve_cuda(
                *args, max(1, need // k))
            assert chunked.tolist()[:2] == opened.tolist()[:2]
            assert int(chunked[3]) == 0
            assert got[:n].cpu().numpy().tobytes() == content
    window, raws, comps, dest_cap, _ = testing.far_match_frame(
        np.random.default_rng(65), 16)
    pays = testing.payloads(raws, comps)
    c, cl = layout.to_device_layout(pays, device=cuda_device)
    raw = torch.tensor([len(p) >= len(r) for r, p in zip(raws, comps)],
                       device=cuda_device)
    before = linked_decode.RESOLVE.launches
    batch = linked_decode.decode_linked_batch(
        c, cl, raw, dest_cap, layout.upload_bytes(window, cuda_device))
    assert linked_decode.RESOLVE.launches == before + 1
    assert batch.out[:batch.n_nodes].cpu().numpy().tobytes() == \
        window + b"".join(raws)
    walk = linked_decode.walk_linked(c, cl, raw, dest_cap)
    plan = linked_decode.frame_plan(walk[2], walk[3], walk[4], len(window))
    cap = len(window) + len(raws) * dest_cap
    _, opened = linked_decode.resolve_linked(
        c, walk[0], walk[1], plan[0], plan[2], plan[3],
        layout.upload_bytes(window, cuda_device), cap)
    assert int(opened[1]) > 2 * -(-cap // linked_decode.LIST_SHARE)
    assert int(opened[3]) == 0


def _linked_frame(device, rng):
    data = testing.block_of(rng, "alphabet4", 5 * 65536 + 999)
    raws = [data[i:i + 65536] for i in range(0, len(data), 65536)]
    return data, raws, testing.linked_blocks(data, 65536, device)


@pytest.mark.parametrize("fault", ["none", "checksum", "reach", "oversized",
                                   "premature"])
def test_linked_frames_on_the_card(cuda_device, fault):
    """``decode_frames`` of linked frames on the card (one walk and one
    resolve a batch, no history decode) against the same on the CPU
    (the plain versions) and the serial reader: bytes written and error,
    at batches of 2 and 256 blocks."""
    from lz4_tpu_torch.core.errors import Lz4Error
    from lz4_tpu_torch.formats import Lz4FrameInputStream
    from lz4_tpu_torch.streams.pipeline import decode_frames

    rng = np.random.default_rng(66)
    data, raws, comps = _linked_frame(cuda_device, rng)
    if fault == "reach":       # block 0 reaches before the frame's start
        comps[0] = testing.encode_block([(b"ab", 100, 4)], b"x" * 9)
    elif fault == "oversized":
        comps[3] = testing.encode_block([(b"ab", 1, 65536)], b"x" * 9)
    frame = bytearray(testing.build_frame(raws, comps, independent=False))
    if fault == "checksum":
        frame[-40] ^= 1
    elif fault == "premature":
        frame = frame[:len(frame) // 2]

    def outcome(run):
        out = io.BytesIO()
        try:
            run(out)
        except Lz4Error as e:
            return out.getvalue(), (type(e).__name__, str(e))
        return out.getvalue(), None

    def serial(out):
        reader = Lz4FrameInputStream(io.BytesIO(frame),
                                     allow_dependent_blocks=True,
                                     device=cuda_device)
        while chunk := reader.read(1 << 20):
            out.write(chunk)

    want = outcome(serial)
    assert want[1] is not None or want[0] == data
    for batch in (2, 256):
        for dev in (cuda_device, "cpu"):
            build.reset_launch_counts()
            got = outcome(lambda out: decode_frames(
                io.BytesIO(frame), out, "cuda", batch, dev,
                allow_dependent=True))
            assert got == want, (batch, dev)
            if dev != "cpu":
                counts = build.launch_counts()
                assert counts["lz4_decode_hist"] == 0
                assert counts["linked_walk"] == counts["linked_resolve"] >= 1


def test_read_backs_are_counted_and_launches_lie_in_their_entry_spans(
        cuda_device):
    """The benchmark cells' four calls on the card: one read-back a
    compress call (``check_batch``) and one a frame body, counted by site,
    and none in the decode, as K1 checks each row's length; under
    ``torch.profiler`` every K1, K2, K6 and pack launch lies inside the
    entry span of the call that made it."""
    import chip_smoke
    from lz4_tpu_torch.utils import profiling

    rng = np.random.default_rng(21)
    src, lens = layout.to_device_layout(
        testing.mixed_blocks(rng, (1000, 65536)), device=cuda_device)
    cap = max_compressed_length(65536)

    def calls():
        comp, comp_lens, _ = codec.compress_fast_batch(src, lens, cap)
        hc.compress_hc_batch(src, lens, cap, 9)
        sharded.frame_body_packed(src, lens, comp, comp_lens)
        codec.decompress_safe_batch(comp, comp_lens, 65536)
        torch.cuda.synchronize()

    calls()
    profiling.reset_sync_counts()
    calls()
    assert profiling.sync_counts() == {"check_batch": 2, "frame_body": 1}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        calls()
    spans, launches = chip_smoke._port_events(prof)
    assert chip_smoke.launches_in_entries(launches, spans) == {
        k: [1, 1] for k in ("compress_kernel", "hc_kernel", "pack_kernel",
                            "decode_kernel")}
