"""The port's CUDA kernels on the card, held against their plain versions.

Every test here needs a CUDA card and ``nvcc``; without one it skips. The
file imports nothing from the JAX package, so on a machine without JAX it
runs alone, without ``tests/conftest.py``::

    python -m pytest --noconftest -m cuda tests/test_torch_card.py
"""

import io

import numpy as np
import pytest
import torch

from lz4_tpu_torch import (
    Lz4Factory, XXHashFactory, compress_frame_packed, roundtrip_step, testing)
from lz4_tpu_torch.core import xxhash_ref
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.kernels import (
    build, codec, layout, segment_decode, sequences, xxhash, xxhash_stream)
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
    assert [counts[k] for k in ("lz4_compress", "lz4_decode", "xxh32")] == \
        [1, 1, 1]
    assert sum(counts.values()) == 3
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


@pytest.mark.parametrize("out_max", [64, 4096, 70000])
def test_segment_kernel_matches_plain(cuda_device, out_max):
    rng = np.random.default_rng(out_max)
    blocks, (c, cl) = _comp_batch(cuda_device, rng, 64)
    tables, n_seq, _ = sequences.parse_sequences(c, cl)
    bad = tables.clone()
    rows = torch.nonzero(n_seq > 1).flatten()[:6]
    bad[1, rows, 0] = c.shape[1]
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
    cuts = [0, 1, 15, 16, 17, 31, 32, 33, 40, 1000, 65536]
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
    assert out.getvalue() == compress_frame_packed(data, device="cpu")
    for engine in ("segment", "cuda"):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(out.getvalue()), back, engine=engine)
        assert back.getvalue() == data
    counts = build.launch_counts()
    for k in ("lz4_compress", "lz4_decode", "lz4_parse", "segment_decode",
              "xxh32_stream"):
        assert counts[k] >= 1, k
