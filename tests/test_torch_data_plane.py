"""The host data plane of the port's stream pipeline and tier on
``device="cpu"``: the packed entry points against
``lz4_tpu.api.native_instances``, and ``decompress_stream`` on hand-built
frames (short blocks anywhere, raw blocks, block checksums) against
``lz4_tpu.streams``, exceptions and the bytes written before them
included; the streaming hash from tensors against the one from bytes."""

import io
import struct

import numpy as np
import pytest
import torch

from lz4_tpu import streams as jax_streams
from lz4_tpu.core.errors import Lz4Error as JaxLz4Error
from lz4_tpu.core.lz4_block_ref import compress_fast_alloc
from lz4_tpu_torch import testing
from lz4_tpu_torch.api import cuda_instances as ci
from lz4_tpu_torch.core.errors import Lz4Error, Lz4FrameError
from lz4_tpu_torch.kernels import xxhash_stream
from lz4_tpu_torch.streams import (
    BatchEngine, compress_stream, decompress_stream, get_engine)

ni = pytest.importorskip("lz4_tpu.api.native_instances")

ENGINES = ["cuda", "segment"]
BS = 1 << 16


def _data(n, alphabet=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, alphabet, n, dtype=np.uint8).tobytes()


def _blocks(comp, offs, lens):
    mv = memoryview(comp)
    return [bytes(mv[int(o):int(o) + int(k)]) for o, k in zip(offs, lens)]


@pytest.mark.parametrize("size, block_size", [
    (0, BS), (1, BS), (BS, BS), (3 * BS + 777, BS), (5000, 1000),
    (40000, 4096)])
def test_compress_fast_packed_matches_native(size, block_size):
    data = _data(size, alphabet=5, seed=size) if size % 2 else \
        np.random.default_rng(size).integers(0, 256, size, np.uint8).tobytes()
    comp, offs, lens = ci.compress_fast_packed(data, block_size, device="cpu")
    want = ni.compress_fast_packed(data, block_size)
    assert lens.dtype == np.int32 and offs.dtype == np.int64
    assert lens.tolist() == want[2].tolist()
    assert _blocks(comp, offs, lens) == _blocks(*want)
    assert isinstance(comp, bytearray)


@pytest.mark.parametrize("size", [0, 1, 70000, 3 * BS + 777])
def test_decompress_safe_packed_matches_native(size):
    rng = np.random.default_rng(size)
    data = _data(size, alphabet=4, seed=size)
    if size > 1000:         # an incompressible block in the middle
        data = data[:BS] + rng.integers(0, 256, BS, np.uint8).tobytes() + \
            data[2 * BS:]
    comp, offs, lens = ni.compress_fast_packed(data, BS)
    dest, out_lens = ci.decompress_safe_packed(comp, offs, lens, BS,
                                               device="cpu")
    want, want_lens = ni.decompress_safe_packed(comp, offs, lens, BS)
    assert out_lens.tolist() == want_lens.tolist()
    assert len(dest) == len(want) == len(lens) * BS
    for i, k in enumerate(out_lens.tolist()):
        assert dest[i * BS:i * BS + k] == want[i * BS:i * BS + k]
        assert not any(dest[i * BS + k:(i + 1) * BS])
    assert bytes(b"".join(dest[i * BS:i * BS + k]
                          for i, k in enumerate(out_lens.tolist()))) == data


def test_decompress_safe_packed_bad_block_raises():
    good = compress_fast_alloc(_data(1000))
    bad = bytes([0x1F, 65, 1, 0]) + b"\xff" * 3
    comp = good + bad
    with pytest.raises(Lz4Error, match="Malformed input in block 1"):
        ci.decompress_safe_packed(comp, [0, len(good)], [len(good), len(bad)],
                                  1000, device="cpu")
    with pytest.raises(JaxLz4Error, match="Malformed input"):
        ni.decompress_safe_packed(comp, [0, len(good)],
                                  [len(good), len(bad)], 1000)


@pytest.mark.parametrize("name", ["fastest", "cuda", "segment"])
def test_engines_carry_the_packed_forms(name):
    eng = get_engine(name, device="cpu")
    assert eng.compress_packed is ci.compress_rows
    assert eng.decompress_packed in (ci.decode_rows,
                                     get_engine("segment", device="cpu")
                                     .decompress_packed)
    hc = get_engine(name, 9, "cpu")
    assert hc.compress_packed is None
    assert hc.decompress_packed is eng.decompress_packed


def _jax_decode(frame, batch_blocks):
    """(bytes written, exception) of the JAX pipeline on ``frame``."""
    out = io.BytesIO()
    try:
        jax_streams.decompress_stream(io.BytesIO(frame), out, engine="safe",
                                      batch_blocks=batch_blocks)
    except Exception as e:      # noqa: BLE001 - compared with the port's
        return out.getvalue(), e
    return out.getvalue(), None


def _port_decode(frame, engine, batch_blocks):
    out = io.BytesIO()
    try:
        decompress_stream(io.BytesIO(frame), out, engine=engine,
                          batch_blocks=batch_blocks, device="cpu")
    except Lz4Error as e:
        return out.getvalue(), e
    return out.getvalue(), None


def _assert_same_outcome(frame, engine, batch_blocks):
    got, err = _port_decode(frame, engine, batch_blocks)
    want, want_err = _jax_decode(frame, batch_blocks)
    assert got == want
    assert (type(err).__name__, str(err)) == \
        (type(want_err).__name__, str(want_err))
    return err


def _ragged(seed, n, raw_every=0):
    """``n`` blocks of ``testing.ragged_sizes``, compressed by the JAX
    block compressor; with ``raw_every``, every such block incompressible
    (stored raw)."""
    rng = np.random.default_rng(seed)
    sizes = testing.ragged_sizes(rng, n)
    raws = []
    for i, k in enumerate(sizes):
        if raw_every and i % raw_every == 0:
            raws.append(rng.integers(0, 256, k, np.uint8).tobytes())
        else:
            raws.append(rng.integers(0, 6, k, np.uint8).tobytes())
    return raws, [compress_fast_alloc(r) for r in raws]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("batch_blocks", [1, 3, 256])
def test_short_blocks_anywhere_in_the_frame(engine, batch_blocks):
    raws, comps = _ragged(1, 14, raw_every=4)
    for checksums in (True, False):
        frame = testing.build_frame(raws, comps, block_checksum=checksums)
        assert _assert_same_outcome(frame, engine, batch_blocks) is None
        assert _port_decode(frame, engine, batch_blocks)[0] == b"".join(raws)


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("batch_blocks", [1, 3, 256])
def test_batches_across_frame_ends(engine, batch_blocks):
    """Concatenated frames: the port's, a hand-built one whose batches end
    off a stripe (the content hash carries a remainder), an all-raw one
    and an empty one, with a skippable frame between them."""
    a = _data(3 * BS + 5, seed=2)
    raws, comps = _ragged(3, 7)
    rand = np.random.default_rng(4).integers(0, 256, 2 * BS + 3, np.uint8)
    parts = [io.BytesIO() for _ in range(3)]
    compress_stream(io.BytesIO(a), parts[0], batch_blocks=2, device="cpu")
    compress_stream(io.BytesIO(rand.tobytes()), parts[1], device="cpu")
    compress_stream(io.BytesIO(b""), parts[2], device="cpu")
    blob = (parts[0].getvalue() + testing.build_frame(raws, comps)
            + struct.pack("<II", 0x184D2A50, 3) + b"xyz"
            + parts[1].getvalue() + parts[2].getvalue())
    assert _assert_same_outcome(blob, engine, batch_blocks) is None
    assert _port_decode(blob, engine, batch_blocks)[0] == \
        a + b"".join(raws) + rand.tobytes()


def test_all_raw_and_empty_frames_equal_the_jax_pipeline():
    rand = np.random.default_rng(5).integers(0, 256, 3 * BS + 9, np.uint8)
    for data in (rand.tobytes(), b""):
        want = io.BytesIO()
        jax_streams.compress_stream(io.BytesIO(data), want, engine="safe",
                                    batch_blocks=2)
        got = io.BytesIO()
        compress_stream(io.BytesIO(data), got, batch_blocks=2, device="cpu")
        assert got.getvalue() == want.getvalue()
        for engine in ENGINES:
            assert _port_decode(got.getvalue(), engine, 2) == (data, None)


def _block_spans(frame):
    """(start of the size word, start of the checksum word) of each block
    of a one-frame ``frame`` with block checksums and no content size."""
    pos, spans = 7, []
    while True:
        word = struct.unpack_from("<I", frame, pos)[0]
        if word == 0:
            return spans
        size = word & 0x7FFFFFFF
        spans.append((pos, pos + 4 + size))
        pos += 8 + size


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("after", ["none", "oversized", "premature",
                                   "bad_payload"])
def test_block_checksum_mismatch_mid_batch(engine, after):
    """Block 5 of 13 (batch 2 of 4 blocks, its second) has a wrong
    checksum; then nothing else, a later block of that batch oversized,
    the stream cut inside that batch, or a later block that does not
    decode. The JAX walk checks each block as it reads it, so it raises
    the mismatch and has written batch 1 only; so does the port."""
    raws, comps = _ragged(6, 13, raw_every=5)
    frame = bytearray(testing.build_frame(raws, comps))
    spans = _block_spans(bytes(frame))
    frame[spans[5][1]] ^= 0x01
    if after == "oversized":
        struct.pack_into("<I", frame, spans[6][0], BS + 1)
    elif after == "premature":
        frame = frame[:spans[6][1] - 3]
    elif after == "bad_payload":
        assert comps[7] and len(comps[7]) < len(raws[7])
        frame[spans[7][0] + 4] = 0xF0         # a literal run past the block
    err = _assert_same_outcome(bytes(frame), engine, 4)
    assert isinstance(err, Lz4FrameError) and "Block checksum" in str(err)
    assert _port_decode(bytes(frame), engine, 4)[0] == b"".join(raws[:4])


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("fault", ["oversized", "premature", "premature_sum"])
def test_walk_faults_mid_batch(engine, fault):
    """No checksum mismatch: the walk's own fault, after the batches
    before it were written."""
    raws, comps = _ragged(7, 13)
    frame = bytearray(testing.build_frame(raws, comps))
    spans = _block_spans(bytes(frame))
    if fault == "oversized":
        struct.pack_into("<I", frame, spans[9][0], BS + 1)
    elif fault == "premature":
        frame = frame[:spans[9][0] + 7]
    else:
        frame = frame[:spans[9][1] + 2]
    err = _assert_same_outcome(bytes(frame), engine, 4)
    assert isinstance(err, Lz4FrameError)
    assert _port_decode(bytes(frame), engine, 4)[0] == b"".join(raws[:8])


@pytest.mark.parametrize("bits, cls", [(32, xxhash_stream.StreamState32),
                                       (64, xxhash_stream.StreamState64)])
def test_stream_update_from_tensors_equals_bytes(bits, cls):
    rng = np.random.default_rng(bits)
    data = rng.integers(0, 256, 200000, np.uint8).tobytes()
    cuts = np.cumsum(rng.choice([0, 1, 7, 15, 16, 17, 33, 1000, 65537], 400))
    cuts = [0] + [int(c) for c in cuts if c < len(data)] + [len(data)]
    by_bytes, by_tensor, mixed = cls(9, "cpu"), cls(9, "cpu"), cls(9, "cpu")
    for i, (a, b) in enumerate(zip(cuts, cuts[1:])):
        piece = data[a:b]
        t = torch.frombuffer(bytearray(piece), dtype=torch.uint8) if piece \
            else torch.empty((0,), dtype=torch.uint8)
        by_bytes.update(piece)
        by_tensor.update(t)
        mixed.update(t if i % 2 else piece)
        assert by_tensor.mem == by_bytes.mem
        assert by_tensor.lanes.tolist() == by_bytes.lanes.tolist()
    assert by_tensor.digest() == by_bytes.digest() == mixed.digest()
    with pytest.raises(ValueError):
        by_tensor.update(torch.zeros((2, 8), dtype=torch.uint8))


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("later", ["oversized", "premature"])
def test_decode_error_wins_over_a_later_batch(engine, later):
    """A block of batch 2 that does not decode, then a fault of the walk in
    batch 3: the JAX pipeline decodes batch 2 before it reads batch 3, so
    it raises the decode error with batch 1 written; so does the port,
    which walks batch 3 while the card decodes batch 2."""
    raws, comps = _ragged(8, 13)
    frame = bytearray(testing.build_frame(raws, comps, block_checksum=False))
    pos, starts = 7, []
    while struct.unpack_from("<I", frame, pos)[0]:
        starts.append(pos)
        pos += 4 + (struct.unpack_from("<I", frame, pos)[0] & 0x7FFFFFFF)
    assert len(comps[6]) < len(raws[6])
    # a literal length that runs past the block
    frame[starts[6] + 4:starts[6] + 4 + len(comps[6])] = b"\xff" * len(comps[6])
    if later == "oversized":
        struct.pack_into("<I", frame, starts[9], BS + 1)
    else:
        frame = frame[:starts[9] + 9]
    got, err = _port_decode(bytes(frame), engine, 4)
    want, want_err = _jax_decode(bytes(frame), 4)
    assert got == want == b"".join(raws[:4])
    assert type(err).__name__ == type(want_err).__name__ == "Lz4Error"
    assert str(err).startswith("Malformed input in block 2")


@pytest.mark.parametrize("batch_blocks", [1, 3])
def test_engine_without_packed_forms_takes_the_list_path(batch_blocks):
    """An engine built with the list forms only, as the JAX pipeline
    allows: the same frames and the same decoded bytes."""
    packed = get_engine("cuda", device="cpu")
    listed = BatchEngine("listed", packed.compress_batch,
                         packed.decompress_batch, packed.device)
    raws, comps = _ragged(9, 9, raw_every=3)
    frame = testing.build_frame(raws, comps)
    out = io.BytesIO()
    decompress_stream(io.BytesIO(frame), out, engine=listed,
                      batch_blocks=batch_blocks)
    assert out.getvalue() == b"".join(raws)
    data = b"".join(raws)
    frames = []
    for eng in (listed, packed):
        sink = io.BytesIO()
        compress_stream(io.BytesIO(data), sink, engine=eng,
                        batch_blocks=batch_blocks)
        frames.append(sink.getvalue())
    assert frames[0] == frames[1]
