"""The port's ``cuda`` tier and its factories (``lz4_tpu_torch.api``) with
``device="cpu"``, against the JAX package's ``pallas`` tier and its ``safe``
tier on the same inputs, compared exactly. Mirrors ``test_factory.py`` and
the routing tests of ``test_jax_kernels.py``. On the CPU the tier's card
roles run the kernels' plain versions; ``test_torch_card.py`` and
``chip_smoke.py`` drive them on the card."""

import numpy as np
import pytest
import torch

from lz4_tpu.api import pallas_instances as pi
from lz4_tpu.api import safe_instances
from lz4_tpu.core.lz4_block_ref import compress_fast_alloc
from lz4_tpu.core.xxhash_ref import xxh32, xxh64
from lz4_tpu.kernels import jax_codec
from lz4_tpu_torch import Lz4Factory, XXHashFactory
from lz4_tpu_torch.api import cuda_instances as ci
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.kernels import codec

CPU = "cpu"


def _blocks(seed, spec):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, a, n, dtype=np.uint8).tobytes() for a, n in spec]


MIXED = [(4, 800), (256, 200), (8, 64), (1, 1000), (3, 0), (16, 13),
         (2, 5000)]


@pytest.fixture(scope="module")
def lz4():
    return Lz4Factory.cuda_instance(CPU)


@pytest.fixture(scope="module")
def xxh():
    return XXHashFactory.cuda_instance(CPU)


def test_instances_are_cached_singletons(lz4, xxh):
    assert Lz4Factory.cuda_instance(CPU) is lz4
    assert Lz4Factory.cuda_instance(torch.device("cpu")) is lz4
    assert Lz4Factory.fastest_instance(CPU) is lz4
    assert XXHashFactory.cuda_instance(CPU) is xxh
    assert XXHashFactory.fastest_instance(CPU) is xxh
    assert lz4.decompressor() is lz4.fast_decompressor()
    assert lz4.unknown_size_decompressor() is lz4.safe_decompressor()
    assert repr(lz4) == "Lz4Factory(impl='cuda', device='cpu')"


@pytest.mark.parametrize("build", [
    Lz4Factory.cuda_instance, Lz4Factory.fastest_instance,
    XXHashFactory.cuda_instance, XXHashFactory.fastest_instance,
    ci.FastCompressor, ci.SafeDecompressor, ci.XXH64])
def test_default_device_without_a_card_raises(build):
    """The tier defaults to the card and never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build()


def test_high_compressor_levels_and_clamping(lz4):
    assert len({id(lz4.high_compressor(lv)) for lv in range(1, 18)}) == 17
    assert lz4.high_compressor() is lz4.high_compressor(9)
    assert lz4.high_compressor(0) is lz4.high_compressor(1)
    assert lz4.high_compressor(-3) is lz4.high_compressor(1)
    assert lz4.high_compressor(99) is lz4.high_compressor(17)
    assert [lz4.high_compressor(lv).level for lv in (1, 9, 17)] == [1, 9, 17]
    data = b"abcabcabcabc" * 100
    for level in (1, 9, 17):
        c = lz4.high_compressor(level).compress_alloc(data)
        assert lz4.safe_decompressor().decompress_alloc(
            c, 0, len(c), len(data)) == data


def test_high_compressor_matches_safe_tier(lz4):
    blocks = _blocks(9, [(4, 1500), (256, 300)])
    port = lz4.high_compressor(9)
    ref = safe_instances.HighCompressor(9)
    for b in blocks:
        assert port.compress_alloc(b) == ref.compress_alloc(b)
    assert port.compress_batch(blocks) == [ref.compress_alloc(b)
                                           for b in blocks]


def test_lz4_self_test_rejects_a_broken_decompressor(monkeypatch):
    monkeypatch.setattr(ci.FastDecompressor, "decompress",
                        lambda self, *a: 0)
    with pytest.raises(Lz4Error, match="fast decompressor"):
        Lz4Factory(CPU)


def test_xxhash_self_test_rejects_a_broken_hash(monkeypatch):
    monkeypatch.setattr(ci.XXH64, "hash", lambda self, *a: 0)
    with pytest.raises(Lz4Error, match="xxhash64"):
        XXHashFactory(CPU)


def test_compress_and_decompress_batch_match_pallas_tier(lz4):
    """``compress_batch``/``decompress_batch`` against the JAX tier (its
    pure-JAX path on the CPU), byte for byte."""
    blocks = _blocks(1, MIXED)
    comp = lz4.fast_compressor().compress_batch(blocks)
    assert comp == pi.FastCompressor().compress_batch(blocks)
    assert comp == [compress_fast_alloc(b) for b in blocks]
    out = lz4.safe_decompressor().decompress_batch(comp, 5000)
    assert out == pi.SafeDecompressor().decompress_batch(comp, 5000)
    assert out == blocks
    assert lz4.fast_compressor().compress_batch([]) == []
    assert lz4.safe_decompressor().decompress_batch([], 10) == []


def test_batch_apis_route_to_the_kernel_wrappers(lz4, xxh, monkeypatch):
    """Every batch goes through the codec and hash wrappers (the kernels
    on the card), ragged or not: there is no uniform-batch branch."""
    calls = []
    for mod, name in ((codec, "compress_fast_batch"),
                      (codec, "decompress_safe_batch"),
                      (codec, "decompress_fast_batch"),
                      (ci, "xxh32_batch"), (ci, "xxh64_batch")):
        real = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _r=real, _n=name, **k: (
            calls.append(_n), _r(*a, **k))[1])
    blocks = _blocks(2, [(4, 100), (8, 64)])
    comp = lz4.fast_compressor().compress_batch(blocks)
    lz4.safe_decompressor().decompress_batch(comp, 100)
    lz4.fast_decompressor().decompress_batch(comp[:1], 100)
    data = np.zeros((3, 64), np.uint8)
    for lens in ([64, 64, 64], [64, 1, 0]):
        xxh.hash32().hash_batch(data, np.array(lens, np.int32))
        xxh.hash64().hash_batch(data, np.array(lens, np.int32))
    assert calls == ["compress_fast_batch", "decompress_safe_batch",
                     "decompress_fast_batch"] + ["xxh32_batch",
                                                 "xxh64_batch"] * 2


def test_decompress_batch_names_the_bad_block(lz4):
    comp = lz4.fast_compressor().compress_batch(_blocks(3, MIXED[:3]))
    comp[1] = comp[1][:-3]
    with pytest.raises(Lz4Error, match="Malformed input in block 1"):
        lz4.safe_decompressor().decompress_batch(comp, 1000)
    with pytest.raises(Exception, match="Malformed input in block 1"):
        pi.SafeDecompressor().decompress_batch(comp, 1000)   # its own class


@pytest.mark.parametrize("interpret", [False, True])
@pytest.mark.parametrize("ragged", [False, True])
def test_hash_batch_matches_pallas_tier(xxh, monkeypatch, interpret, ragged):
    """Mirrors test_jax_kernels.py:211 and :238. With ``interpret`` the JAX
    tier sends uniform batches to its Mosaic kernels in interpret mode;
    the port sends every batch to its kernel wrappers."""
    if interpret:
        monkeypatch.setenv("TPULZ4_PALLAS_INTERPRET", "1")
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, (4, 128), dtype=np.uint8)
    lens = np.array([128, 127, 64, 1] if ragged else [128] * 4, np.int32)
    seed64 = 0xCAFEBABE12345678
    h32 = xxh.hash32().hash_batch(data, lens, 3)
    assert h32.dtype == torch.uint32
    assert h32.tolist() == np.asarray(pi.XXH32().hash_batch(data, lens, 3)
                                      ).tolist()
    assert h32.tolist() == [xxh32(data[i].tobytes(), 0, int(n), 3)
                            for i, n in enumerate(lens)]
    hi, lo = xxh.hash64().hash_batch(data, lens, seed64)
    assert hi.dtype == lo.dtype == torch.uint32
    rhi, rlo = pi.XXH64().hash_batch(data, lens, seed64)
    assert hi.tolist() == np.asarray(rhi).tolist()
    assert lo.tolist() == np.asarray(rlo).tolist()
    assert [(h << 32) | low for h, low in zip(hi.tolist(), lo.tolist())] == \
        [xxh64(data[i].tobytes(), 0, int(n), seed64)
         for i, n in enumerate(lens)]


def test_hash_batch_takes_tensors_and_odd_widths(xxh):
    """Rows the kernels could not take as they lie (a width that is no
    multiple of 16) are copied into the port's layout first."""
    rng = np.random.default_rng(12)
    data = rng.integers(0, 256, (5, 37), dtype=np.uint8)
    lens = np.array([37, 0, 5, 36, 20], np.int32)
    want = [xxh64(data[i].tobytes(), 0, int(n), 7) for i, n in enumerate(lens)]
    hi, lo = xxh.hash64().hash_batch(torch.from_numpy(data),
                                     torch.from_numpy(lens), 7)
    assert [(h << 32) | low for h, low in zip(hi.tolist(), lo.tolist())] == want
    with pytest.raises(ValueError):
        xxh.hash64().hash_batch(data, np.array([38, 0, 0, 0, 0], np.int32))


@pytest.mark.parametrize("seed", [-1, 0x9747B28C])
def test_scalar_hashes_match_pallas_tier(xxh, seed):
    buf = _blocks(5, [(256, 300)])[0]
    for off, n in ((0, 300), (299, 1), (10, 0)):
        assert xxh.hash32().hash(buf, off, n, seed) == \
            pi.XXH32().hash(buf, off, n, seed)
        assert xxh.hash64().hash(buf, off, n, seed) == \
            pi.XXH64().hash(buf, off, n, seed)


def test_scalar_codec_matches_pallas_tier(lz4):
    for data in _blocks(6, [(4, 700), (256, 64), (1, 20), (3, 0)]):
        comp = lz4.fast_compressor().compress_alloc(data)
        assert comp == pi.FastCompressor().compress_alloc(data)
        assert lz4.safe_decompressor().decompress_alloc(
            comp, 0, len(comp), len(data) + 5) == data
        assert lz4.fast_decompressor().decompress_alloc(
            comp, 0, len(data)) == data


def test_scalar_codec_errors_match_pallas_tier(lz4):
    data = bytes(range(200)) * 5
    comp = compress_fast_alloc(data)
    with pytest.raises(Lz4Error, match="Output buffer too small"):
        lz4.safe_decompressor().decompress_alloc(comp, 0, len(comp), 999)
    with pytest.raises(Exception, match="Output buffer too small"):
        pi.SafeDecompressor().decompress_alloc(comp, 0, len(comp), 999)
    with pytest.raises(Lz4Error, match="Malformed input"):
        lz4.safe_decompressor().decompress_alloc(comp[:-2], 0, len(comp) - 2,
                                                 1000)
    with pytest.raises(Lz4Error, match="maxDestLen is too small"):
        lz4.fast_compressor().compress(data, 0, len(data), bytearray(50), 0,
                                       50)


def _fast_cases():
    """(compressed bytes at offset 2, dest_len) pairs of the JAX tier's
    error cases and good blocks: exact, with trailing bytes, malformed,
    dest too small, dest too large."""
    data = _blocks(7, [(4, 1000)])[0]
    comp = compress_fast_alloc(data)
    pre = b"\xEE\xEE"
    return [(pre + comp, 1000), (pre + comp + b"\x12" * 11, 1000),
            (pre + comp[:-4], 1000), (pre + comp, 999), (pre + comp, 1001),
            (pre + b"\x00", 0), (pre + b"\x10\x41", 0), (pre + b"\x10\x41", 1)]


@pytest.mark.parametrize("case", range(8))
def test_fast_decompressor_matches_jax_codec(lz4, case):
    """``FastDecompressor.decompress``: bytes read, the output and the
    error, against the JAX tier and ``jax_codec.decompress_fast_batch``."""
    src, dest_len = _fast_cases()[case]
    port_dest = bytearray(dest_len + 4)
    ref_dest = bytearray(dest_len + 4)
    try:
        got = lz4.fast_decompressor().decompress(src, 2, port_dest, 2,
                                                 dest_len)
    except Lz4Error as e:
        got = e
    try:
        want = pi.FastDecompressor().decompress(src, 2, ref_dest, 2, dest_len)
    except Exception as e:     # the JAX package's own Lz4Error class
        want = e
    if isinstance(want, Exception):
        assert isinstance(got, Lz4Error) and str(got) == str(want)
        return
    assert got == want and port_dest == ref_dest
    arr, avail = jax_codec.to_device_layout([src[2:]], len(src))
    _, src_read, err = jax_codec.decompress_fast_batch(arr, avail, dest_len)
    assert int(np.asarray(err)[0]) == codec.OK
    assert got == int(np.asarray(src_read)[0])


def test_fast_decompressor_batch(lz4):
    blocks = _blocks(8, [(4, 500), (256, 500), (1, 500)])
    comp = [compress_fast_alloc(b) for b in blocks]
    out, src_read = lz4.fast_decompressor().decompress_batch(
        [c + b"\x99" * 3 for c in comp], 500)
    assert out == blocks and src_read == [len(c) for c in comp]
    with pytest.raises(Lz4Error, match="Malformed input in block 2"):
        lz4.fast_decompressor().decompress_batch(comp[:2] + [comp[2][:-1]],
                                                 500)
    assert lz4.fast_decompressor().decompress_batch([], 5) == ([], [])


@pytest.mark.parametrize("seed", [0, 0x9747B28C])
def test_streaming_in_odd_chunks_equals_one_shot(xxh, seed):
    data = _blocks(10, [(256, 3001)])[0]
    s32 = xxh.new_streaming_hash32(seed)
    s64 = xxh.new_streaming_hash64(seed)
    for off in range(0, len(data), 37):
        n = min(37, len(data) - off)
        s32.update(data, off, n)
        s64.update(data, off, n)
    assert s32.get_value() == xxh.hash32().hash(data, 0, len(data), seed)
    assert s64.get_value() == xxh.hash64().hash(data, 0, len(data), seed)
    ref32 = pi.StreamingXXH32(seed)
    ref32.update(data)
    assert s32.get_value() == ref32.get_value()
    s64.reset()
    s64.update(data[:10])
    assert s64.get_value() == xxh.hash64().hash(data, 0, 10, seed)


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("off, length", [(5, 0), (0, -1), (-1, 0), (1, None),
                                         (0, 3), (2, 2)])
def test_streaming_update_range_matches_pallas_tier(xxh, bits, off, length):
    """``update(buf, off, length)`` raises what the ``pallas`` tier raises
    (or nothing), and the digest after it is the same."""
    ours = (xxh.new_streaming_hash32 if bits == 32
            else xxh.new_streaming_hash64)(7)
    ref = (pi.StreamingXXH32 if bits == 32 else pi.StreamingXXH64)(7)
    results = []
    for s in (ours, ref):
        try:
            s.update(b"abc", off, length)
            results.append(None)
        except Exception as e:     # the type is what is compared
            results.append(type(e))
    assert results[0] is results[1]
    assert ours.get_value() == ref.get_value()
