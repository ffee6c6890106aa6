"""The port's streaming XXH32/64 (``lz4_tpu_torch.kernels.xxhash_stream``,
the plain versions of the stream entry points of K3 and K4, and the tier's
streaming classes) against ``lz4_tpu.kernels.xxhash_stream`` and
``lz4_tpu.core.xxhash_ref`` on random update splits. Mirrors
``tests/test_xxhash_stream.py``."""

import numpy as np
import pytest
import torch

from lz4_tpu.core.xxhash_ref import StreamingXXH32, StreamingXXH64
from lz4_tpu.kernels import xxhash_stream as jxs
from lz4_tpu_torch.api import cuda_instances
from lz4_tpu_torch.api.factory import XXHashFactory
from lz4_tpu_torch.core import xxhash_ref as port_ref
from lz4_tpu_torch.kernels import xxhash_stream as xs

SIZES32 = (0, 1, 3, 4, 15, 16, 17, 31, 32, 100, 1000, 65536, 70000)
SIZES64 = (0, 1, 7, 8, 9, 31, 32, 33, 100, 1000, 65536, 70001)


def _data(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("seed", [0, 0x9747B28C, 0xFFFFFFFF])
def test_stream32_matches_jax_and_reference(seed):
    rng = np.random.default_rng(seed & 0xFF)
    st, jst, ref = xs.StreamState32(seed, "cpu"), jxs.stream32_init(seed), \
        StreamingXXH32(seed)
    for n in SIZES32:
        data = _data(rng, n)
        st.update(data)
        jst = jxs.absorb_bytes32(jst, data)
        ref.update(data)
        assert st.digest() == jxs.digest32(jst) == ref.get_value(), n


@pytest.mark.parametrize("seed", [0, 0x9747B28C, -(1 << 40)])
def test_stream64_matches_jax_and_reference(seed):
    rng = np.random.default_rng(seed & 0xFF)
    st, jst, ref = xs.StreamState64(seed, "cpu"), jxs.stream64_init(seed), \
        StreamingXXH64(seed)
    for n in SIZES64:
        data = _data(rng, n)
        st.update(data)
        jst = jxs.absorb_bytes64(jst, data)
        ref.update(data)
        assert st.digest() == jxs.digest64(jst) == ref.get_value(), n


@pytest.mark.parametrize("bits", [32, 64])
@pytest.mark.parametrize("split_seed", [1, 2, 3])
def test_random_update_splits(bits, split_seed):
    """Random cuts of one buffer, lengths 0..40 and some long ones, give the
    one-shot hash of the buffer."""
    rng = np.random.default_rng(split_seed)
    data = _data(rng, 200_000)
    cuts, pos = [], 0
    while pos < len(data):
        n = int(rng.choice([rng.integers(0, 41), 1000, 65536]))
        cuts.append(data[pos:pos + n])
        pos += n
    seed = int(rng.integers(0, 1 << 32))
    st = (xs.StreamState32 if bits == 32 else xs.StreamState64)(seed, "cpu")
    for c in cuts:
        st.update(c)
    one_shot = port_ref.xxh32 if bits == 32 else port_ref.xxh64
    assert st.digest() == one_shot(data, 0, len(data), seed)


@pytest.mark.parametrize("total", [15, 16, 17, 31, 32, 33])
def test_digest_at_stripe_boundaries(total):
    """Totals around one stripe of each width, in one update and in two."""
    data = _data(np.random.default_rng(total), total)
    for cls, ref in ((xs.StreamState32, port_ref.xxh32),
                     (xs.StreamState64, port_ref.xxh64)):
        one, two = cls(9, "cpu"), cls(9, "cpu")
        one.update(data)
        two.update(data[:7])
        two.update(data[7:])
        assert one.digest() == two.digest() == ref(data, 0, total, 9)


def test_bulk_equals_incremental():
    rng = np.random.default_rng(3)
    data = _data(rng, 5 * 65536 + 123)
    bulk = xs.StreamState32(11, "cpu")
    bulk.update(data)
    ref = StreamingXXH32(11)
    for i in range(0, len(data), 997):
        ref.update(data[i:i + 997])
    assert bulk.digest() == ref.get_value()


def test_digest_is_non_destructive():
    st = xs.StreamState32(0, "cpu")
    st.update(b"hello world, this is a stream")
    first = st.digest()
    assert st.digest() == first
    st.update(b"more")
    ref = StreamingXXH32(0)
    ref.update(b"hello world, this is a streammore")
    assert st.digest() == ref.get_value()


@pytest.mark.parametrize("bits", [32, 64])
def test_total_length_past_4_gib(bits):
    """The total length folds into the digest as the reference folds it
    past 2^32 bytes; the state of each implementation is injected. With 10
    bytes held, only the total decides that the lanes are merged."""
    rng = np.random.default_rng(bits)
    data = _data(rng, 10)
    if bits == 32:
        st, jst, ref = xs.StreamState32(7, "cpu"), jxs.stream32_init(7), \
            StreamingXXH32(7)
        jst = jxs.absorb_bytes32(jst, data)
        jst = jst._replace(total_hi=jst.total_hi + 1)
        jdigest = jxs.digest32(jst)
    else:
        st, jst, ref = xs.StreamState64(7, "cpu"), jxs.stream64_init(7), \
            StreamingXXH64(7)
        jst = jxs.absorb_bytes64(jst, data)
        jst = jst._replace(total_hi=jst.total_hi + 1)
        jdigest = jxs.digest64(jst)
    st.update(data)
    ref.update(data)
    st.total_len += 1 << 32
    ref._total_len += 1 << 32
    assert st.digest() == jdigest == ref.get_value()
    small = (xs.StreamState32 if bits == 32 else xs.StreamState64)(7, "cpu")
    small.update(data)
    assert small.digest() != st.digest()


def test_absorb_plain_equals_reference_lanes():
    """One absorb of whole stripes moves the lanes as the reference's
    stripe loop does, and refuses a partial stripe."""
    rng = np.random.default_rng(5)
    stripes = torch.from_numpy(rng.integers(0, 256, 64 * 9, dtype=np.uint8))
    st = xs.StreamState64(3, "cpu")
    xs.absorb64(st.lanes, stripes)
    ref = StreamingXXH64(3)
    ref.update(stripes.numpy().tobytes())
    assert [v & ((1 << 64) - 1) for v in st.lanes.tolist()] == \
        [ref._v1, ref._v2, ref._v3, ref._v4]
    with pytest.raises(ValueError):
        xs.absorb32(xs.StreamState32(0, "cpu").lanes, stripes[:17])


def test_tier_streaming_routes_to_device_state():
    s = cuda_instances.StreamingXXH32(42, device="cpu")
    assert isinstance(s._state, xs.StreamState32)
    assert s._state.lanes.device.type == "cpu"
    s.update(b"abc" * 100)
    ref = StreamingXXH32(42)
    ref.update(b"abc" * 100)
    assert s.get_value() == port_ref.as_s32(ref.get_value())
    s.reset()
    s.update(b"xyz", 1, 2)
    ref2 = StreamingXXH32(42)
    ref2.update(b"yz")
    assert s.get_value() == port_ref.as_s32(ref2.get_value())
    with pytest.raises(IndexError):
        s.update(b"xyz", 2, 5)
    f = XXHashFactory.cuda_instance("cpu")
    s64 = f.new_streaming_hash64(-1)
    s64.update(b"q" * 1000)
    assert s64.get_value() == port_ref.as_s64(
        port_ref.xxh64(b"q" * 1000, 0, 1000, -1))
