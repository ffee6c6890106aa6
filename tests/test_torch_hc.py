"""The port's LZ4 HC (``lz4_tpu_torch.kernels.hc``, the ``cuda`` tier's
``HighCompressor`` and the stream engines at an HC level) against the JAX
package: ``jax_hc.compress_hc_batch``, the ``pallas`` tier's
``HighCompressor`` and the frame writer, on the same inputs, compared
exactly (bytes, lengths, error codes, exceptions). On the CPU the port runs
K6's plain version; ``test_torch_host_kernels.py`` holds K6's body (built
with g++) against it and ``test_torch_card.py`` the kernel on the card.

Only levels 1 and 9 go through JAX: its CPU jit takes tens of seconds a
level, and ``dest_cap`` is a static argument, so every cap compiles
again."""

import functools
import io
import random

import numpy as np
import pytest
import torch

from lz4_tpu.api import pallas_instances as pi
from lz4_tpu.api import safe_instances
from lz4_tpu.api.factory import Lz4Factory as JaxLz4Factory
from lz4_tpu.core.constants import max_compressed_length
from lz4_tpu.formats import frame as jax_frame
from lz4_tpu.kernels import jax_codec
from lz4_tpu.kernels.jax_hc import compress_hc_batch as jax_hc_batch
from lz4_tpu_torch import Lz4Factory, testing
from lz4_tpu_torch.api import cuda_instances as ci
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.kernels import codec, hc, layout
from lz4_tpu_torch.streams import compress_stream, get_engine, pipeline

CPU = torch.device("cpu")
L_CAP = 1000


@pytest.fixture(scope="module")
def hc_blocks():
    """The nine blocks of ``test_jax_hc.py::hc_blocks``."""
    rng = random.Random(77)
    out = []
    for alpha, size in [(4, 400), (16, 800), (256, 200), (2, 300),
                        (8, 64), (1, 500), (6, 1000), (3, 13), (5, 0)]:
        out.append(bytes(rng.randrange(alpha) for _ in range(size)))
    return out


def _jax(blocks, dest_cap, level):
    arr, lens = jax_codec.to_device_layout(blocks, L_CAP)
    return jax_hc_batch(arr, lens, dest_cap, level)


def _assert_same(port, ref):
    """Codes on every row; lengths and bytes on OK rows (the port reports
    a length of 0 on an error row, ``jax_hc`` the output so far)."""
    data, lens, err = port
    rdata, rlens, rerr = (np.asarray(x) for x in ref)
    assert err.tolist() == rerr.tolist()
    for i, (e, n) in enumerate(zip(err.tolist(), lens.tolist())):
        if e == codec.OK:
            assert n == int(rlens[i]), i
            assert data[i, :n].numpy().tobytes() == \
                rdata[i, :n].astype(np.uint8).tobytes(), i
        else:
            assert n == 0, i


@pytest.mark.parametrize("level", [1, 9])
def test_plain_matches_jax_hc(hc_blocks, level):
    cap = max_compressed_length(L_CAP)
    src, lens = layout.to_device_layout(hc_blocks, device=CPU)
    port = hc.compress_hc_batch(src, lens, cap, level)
    _assert_same(port, _jax(hc_blocks, cap, level))
    assert port[2].tolist() == [codec.OK] * len(hc_blocks)


@pytest.mark.parametrize("level", [1, 9])
def test_plain_matches_jax_hc_on_collision_blocks(hc_blocks, level):
    """The plain version against ``jax_hc`` on the 1,000-byte blocks of
    ``testing.hc_collision_blocks`` (runs whose chains leave their hash
    buckets' order, where K6's speculated walk must follow the chain),
    batched with six of the blocks above so that JAX compiles no new
    shape."""
    coll = [b for b in testing.hc_collision_blocks(np.random.default_rng(43))
            if len(b) <= L_CAP]
    blocks = coll + hc_blocks[:9 - len(coll)]
    cap = max_compressed_length(L_CAP)
    src, lens = layout.to_device_layout(blocks, device=CPU)
    port = hc.compress_hc_batch(src, lens, cap, level)
    _assert_same(port, _jax(blocks, cap, level))
    assert port[2].tolist() == [codec.OK] * len(blocks)


def test_tight_dest_cap_matches_jax_hc(hc_blocks):
    """A cap that some rows do not fit: the same rows fail."""
    src, lens = layout.to_device_layout(hc_blocks, device=CPU)
    port = hc.compress_hc_batch(src, lens, 256, 1)
    _assert_same(port, _jax(hc_blocks, 256, 1))
    codes = port[2].tolist()
    assert codes.count(codec.ERR_DEST_TOO_SMALL) == 3
    assert codes.count(codec.OK) == 6


@pytest.mark.parametrize("level", [0, 18, -1])
def test_level_out_of_range_raises(hc_blocks, level):
    src, lens = layout.to_device_layout(hc_blocks, device=CPU)
    for fn in (hc.compress_hc_batch, hc.compress_hc_plain):
        with pytest.raises(ValueError, match="level must be 1..17"):
            fn(src, lens, 64, level)
    with pytest.raises(ValueError, match="level must be 1..17"):
        _jax(hc_blocks, 64, level)


@functools.cache
def _tier_block():
    rng = np.random.default_rng(19)
    return rng.integers(0, 6, 700, dtype=np.uint8).tobytes()


def _compress_into(compressor, data, max_dest_len):
    """(returned length or the exception's message, dest bytes after)."""
    dest = bytearray(b"\xa5" * (max_dest_len + 8))
    try:
        out = compressor.compress(data, 0, len(data), dest, 4, max_dest_len)
    except Exception as e:  # noqa: BLE001 - the exception is the result
        out = (type(e).__name__, str(e))
    return out, bytes(dest)


@pytest.mark.parametrize("level", [1, 9])
def test_tier_matches_pallas_tier(level):
    """``high_compressor(level)``'s ``compress_batch`` and ``compress`` at
    ``max_dest_len`` of n - 1, n and n + 1 against the ``pallas`` tier:
    the same bytes, the same raise (``maxDestLen is too small``), and dest
    left as it was when it raises (the batch of one is compressed in full
    first; the host HC would have written part of it)."""
    data = _tier_block()
    port = Lz4Factory.cuda_instance(CPU).high_compressor(level)
    ref = pi.HighCompressor(level)
    assert isinstance(port, ci.HighCompressor) and port.device == CPU
    want = ref.compress_batch([data])
    assert port.compress_batch([data]) == want
    n = len(want[0])
    for cap in (n - 1, n, n + 1):
        got, ref_got = (_compress_into(c, data, cap) for c in (port, ref))
        assert got == ref_got, cap
        assert (got[0] == ("Lz4Error", "maxDestLen is too small")) == \
            (cap < n)
    assert _compress_into(port, data, n)[1][4:4 + n] == want[0]


def test_tier_batch_failure_raises(monkeypatch):
    """A failed block raises the ``pallas`` tier's message."""
    def failing(src, lens, dest_cap, level):
        out = hc.compress_hc_plain(src, lens, dest_cap, level)
        return out[0], out[1], torch.full_like(out[2],
                                               codec.ERR_DEST_TOO_SMALL)
    monkeypatch.setattr(hc, "compress_hc_batch", failing)
    with pytest.raises(Lz4Error, match="device HC compression failed"):
        Lz4Factory.cuda_instance(CPU).high_compressor(3).compress_batch(
            [b"abc" * 50])


def test_compress_rows_runs_hc_at_a_level():
    data = np.random.default_rng(4).integers(0, 5, 5000, dtype=np.uint8)
    t = torch.from_numpy(data)
    src, lens, comp, comp_lens, err = ci.compress_rows(t, 2048, level=9)
    assert lens.tolist() == [2048, 2048, 904] and not err.any()
    ref = safe_instances.HighCompressor(9)
    blocks = [data[i:i + 2048].tobytes() for i in range(0, 5000, 2048)]
    assert layout.from_device_layout(comp, comp_lens) == \
        [ref.compress_alloc(b) for b in blocks]


def test_stream_takes_the_packed_hc_path(monkeypatch):
    """``compress_stream(level=9)`` goes through the packed compress (K6
    on the card) with a named and with a prebuilt engine, and its frame
    equals the JAX pipeline's (the frame of
    ``test_torch_streams.py::test_hc_level_9_byte_identical``)."""
    def listed(*a):
        raise AssertionError("the listed path was taken")
    monkeypatch.setattr(pipeline, "_compress_listed", listed)
    data = np.random.default_rng(8).integers(0, 5, 3000,
                                             dtype=np.uint8).tobytes()
    want = jax_frame.compress_frame(
        data, block_size=jax_frame.BlockSize.SIZE_64KB,
        features=(jax_frame.FrameFlag.BLOCK_INDEPENDENCE,
                  jax_frame.FrameFlag.CONTENT_CHECKSUM),
        compressor=JaxLz4Factory.safe_instance().high_compressor(9))
    prebuilt = get_engine("cuda", device="cpu")
    for engine in ("cuda", "segment", prebuilt):
        out = io.BytesIO()
        compress_stream(io.BytesIO(data), out, engine=engine, level=9,
                        device="cpu")
        assert out.getvalue() == want, engine
    eng = get_engine("segment", 99, "cpu")
    assert eng.compress_packed.func is ci.compress_rows
    assert eng.compress_packed.keywords == {"level": 17}


@pytest.mark.parametrize("level", range(1, 18))
def test_wide_path_rule_by_level(level):
    """K6's wide kernel takes a batch that fits the card in one round only
    at the levels whose walks speculate (5-17; levels 1-4 walk serially),
    and only when every row fits the bucket index (65,536 bytes)."""
    cap = 1056
    speculates = level >= 5
    assert hc.speculates(level) == speculates
    assert hc.takes_wide_path(512, level, 1 << 16, cap) == speculates
    assert not hc.takes_wide_path(512, level, (1 << 16) + 1, cap)


@pytest.mark.parametrize("n,wide", [(0, False), (1, True), (527, True),
                                    (528, True), (529, False), (4096, False)])
def test_wide_path_rule_by_rows(n, wide):
    """At a capacity of 528 CTAs: no rows take no kernel's path, a batch
    of at most the capacity the wide kernel's, one row more the warp
    kernel's."""
    assert hc.takes_wide_path(n, 9, 1 << 16, 528) == wide

