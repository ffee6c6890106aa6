"""The port's stream pipeline and command line (``lz4_tpu_torch.streams``,
``python -m lz4_tpu_torch``) with the ``cuda`` and ``segment`` engines on
``device="cpu"``, against the JAX package's ``lz4_tpu.streams``, its frame
module and its host hashes. Mirrors ``tests/test_streams.py``,
``tests/test_segment_decode.py::test_segment_stream_engine`` and
``tests/test_cli.py``."""

import io
import struct

import numpy as np
import pytest

from lz4_tpu import streams as jax_streams
from lz4_tpu.api.factory import Lz4Factory as JaxLz4Factory
from lz4_tpu.core.xxhash_ref import xxh32, xxh64
from lz4_tpu.formats import frame as jax_frame
from lz4_tpu_torch.__main__ import main
from lz4_tpu_torch.core.errors import Lz4Error, Lz4FrameError
from lz4_tpu_torch.formats.frame import (
    BlockSize, make_skippable_frame, xxh32_bytes)
from lz4_tpu_torch.streams import compress_stream, decompress_stream, get_engine

ENGINES = ["cuda", "segment"]


def _data(n, alphabet=8, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, alphabet, n, dtype=np.uint8).tobytes()


def _compress(data, **kw):
    out = io.BytesIO()
    n = compress_stream(io.BytesIO(data), out, device="cpu", **kw)
    assert n == len(out.getvalue())
    return out.getvalue()


def _decompress(frame, **kw):
    out = io.BytesIO()
    n = decompress_stream(io.BytesIO(frame), out, device="cpu", **kw)
    assert n == len(out.getvalue())
    return out.getvalue()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("size", [0, 1, 1000, 65536, 300000])
def test_stream_roundtrip(engine, size):
    data = _data(size, seed=size)
    assert _decompress(_compress(data, engine=engine), engine=engine) == data


@pytest.mark.parametrize("size", [0, 1000, 150000])
@pytest.mark.parametrize("checksum", [True, False])
def test_frames_equal_the_jax_pipeline(size, checksum):
    data = _data(size, seed=1)
    want = io.BytesIO()
    jax_streams.compress_stream(io.BytesIO(data), want, engine="safe",
                                content_checksum=checksum)
    assert _compress(data, engine="cuda", content_checksum=checksum) == \
        want.getvalue()


def test_interop_with_the_jax_frame_module():
    data = _data(150000, seed=2)
    assert jax_frame.decompress_frame(_compress(data)) == data
    for bs in (jax_frame.BlockSize.SIZE_64KB, jax_frame.BlockSize.SIZE_256KB):
        framed = jax_frame.compress_frame(data, block_size=bs)
        assert _decompress(framed, engine="segment") == data
    sized = jax_frame.compress_frame(
        data, block_size=jax_frame.BlockSize.SIZE_64KB, known_size=True,
        features=(jax_frame.FrameFlag.BLOCK_INDEPENDENCE,
                  jax_frame.FrameFlag.CONTENT_CHECKSUM))
    assert _decompress(sized) == data


@pytest.mark.parametrize("engine", ENGINES)
def test_block_checksum_frames_decode(engine):
    data = _data(200000, seed=3)
    framed = jax_frame.compress_frame(
        data, block_size=jax_frame.BlockSize.SIZE_64KB,
        features=(jax_frame.FrameFlag.BLOCK_INDEPENDENCE,
                  jax_frame.FrameFlag.BLOCK_CHECKSUM,
                  jax_frame.FrameFlag.CONTENT_CHECKSUM))
    assert _decompress(framed, engine=engine) == data
    bad = bytearray(framed)
    bad[-12] ^= 1                   # the last block's checksum word
    with pytest.raises(Lz4FrameError, match="Block checksum"):
        _decompress(bytes(bad), engine=engine)


def test_concatenated_and_skippable_frames():
    a, b = _data(5000, seed=4), _data(7000, seed=5)
    blob = _compress(a) + make_skippable_frame(b"meta" * 5) + \
        _compress(b, engine="segment")
    assert blob.count(jax_frame.make_skippable_frame(b"meta" * 5)) == 1
    assert _decompress(blob) == a + b
    restored = io.BytesIO()
    jax_streams.decompress_stream(io.BytesIO(blob), restored)
    assert restored.getvalue() == a + b


@pytest.mark.parametrize("engine", ENGINES)
def test_corruption_detected(engine):
    framed = _compress(_data(50000, alphabet=4, seed=6))
    blob = bytearray(framed)
    blob[500] ^= 0xFF
    with pytest.raises(Lz4Error):   # a malformed block or the checksum
        _decompress(bytes(blob), engine=engine)
    with pytest.raises(Lz4FrameError, match="ended prematurely"):
        _decompress(framed[:-3], engine=engine)


@pytest.mark.parametrize("engine", ENGINES)
def test_small_batches(engine):
    data = _data(64 * 1024 * 5 + 77, seed=7)
    framed = _compress(data, engine=engine, batch_blocks=3)
    assert framed == _compress(data)
    assert _decompress(framed, engine=engine, batch_blocks=2) == data


def test_hc_level_9_byte_identical():
    data = _data(3000, alphabet=5, seed=8)
    eng = get_engine("cuda", level=9, device="cpu")
    assert eng.name == "cuda-hc9"
    hc = JaxLz4Factory.safe_instance().high_compressor(9)
    want = jax_frame.compress_frame(
        data, block_size=jax_frame.BlockSize.SIZE_64KB,
        features=(jax_frame.FrameFlag.BLOCK_INDEPENDENCE,
                  jax_frame.FrameFlag.CONTENT_CHECKSUM), compressor=hc)
    assert _compress(data, engine="segment", level=9) == want
    assert _compress(data, engine=get_engine("cuda", device="cpu"),
                     level=9) == want
    assert _decompress(want, engine="segment") == data


def _with_flg(frame: bytes, flg: int) -> bytes:
    desc = bytes([flg, frame[5]])
    return frame[:4] + desc + bytes([(xxh32_bytes(desc) >> 8) & 0xFF]) + \
        frame[7:]


def test_dependent_and_dictionary_frames_refused():
    """Without the opt-ins, the JAX package's messages."""
    framed = _compress(_data(1000, seed=9))
    with pytest.raises(Lz4FrameError, match="Dependent block stream is "
                       "unsupported"):
        _decompress(_with_flg(framed, framed[4] & ~0x20))
    with pytest.raises(Lz4FrameError, match="bit 0 is DictID .* pass "
                       "dictionary="):
        _decompress(_with_flg(framed, framed[4] | 0x01))
    with pytest.raises(Lz4FrameError, match="Frame header checksum"):
        _decompress(framed[:6] + bytes([framed[6] ^ 1]) + framed[7:])


@pytest.mark.parametrize("engine", ENGINES)
def test_block_decoding_past_the_block_size_is_refused(engine):
    """A 64 KiB frame whose one block decodes to 65542 bytes
    (``test_dependent_frames.py::_oversized_block_frame``)."""
    ml = 65536 - 4 - 15
    block = (bytes([0x1F, ord("A"), 0x01, 0x00]) + b"\xff" * (ml // 255)
             + bytes([ml % 255]) + bytes([0x50]) + b"BBBBB")
    framed = _with_flg(_compress(b""), 0x60)[:7] + \
        struct.pack("<I", len(block)) + block + struct.pack("<I", 0)
    with pytest.raises(Lz4Error, match="Malformed input in block 0"):
        _decompress(framed, engine=engine)


def test_get_engine_names_and_refusals():
    assert get_engine(device="cpu").name == "cuda"
    assert get_engine("segment", 17, "cpu").name == "segment-hc17"
    assert get_engine("sharded", 17, "cpu").name == "sharded-hc17"
    assert get_engine("parallel", device="cpu").name == "parallel"
    with pytest.raises(Lz4FrameError, match="no HC mode"):
        get_engine("parallel", 9, "cpu")
    for name in ("native", "safe", "pallas"):
        with pytest.raises(ValueError, match="not ported"):
            get_engine(name, device="cpu")


def test_segment_stream_engine():
    data = _data(32768, alphabet=16, seed=10)
    framed = _compress(data, engine="segment",
                       block_size=BlockSize.SIZE_64KB)
    assert _decompress(framed, engine="segment") == data


def test_cli_roundtrip_and_hashes(tmp_path, capsys):
    data = _data(150000, alphabet=16, seed=11)
    src, dst, back = (tmp_path / n for n in ("in.bin", "out.lz4", "back.bin"))
    src.write_bytes(data)
    assert main(["compress", str(src), str(dst), "--engine", "cuda",
                 "-B", "64KB"], device="cpu") == 0
    assert "->" in capsys.readouterr().out
    assert jax_frame.decompress_frame(dst.read_bytes()) == data
    assert main(["decompress", str(dst), str(back), "--engine", "segment"],
                device="cpu") == 0
    assert back.read_bytes() == data
    capsys.readouterr()
    main(["xxh32", str(src)], device="cpu")
    assert capsys.readouterr().out.split()[0] == \
        f"{xxh32(data, 0, len(data), 0) & 0xFFFFFFFF:08x}"
    main(["xxh64", str(src), "--seed", "0x123"], device="cpu")
    assert capsys.readouterr().out.split()[0] == \
        f"{xxh64(data, 0, len(data), 0x123):016x}"


def test_cli_levels_checksums_and_errors(tmp_path, capsys):
    data = _data(20000, alphabet=5, seed=12)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    fast, hc = tmp_path / "fast.lz4", tmp_path / "hc.lz4"
    main(["compress", str(src), str(fast), "--no-frame-crc"], device="cpu")
    main(["compress", str(src), str(hc), "-l", "9"], device="cpu")
    assert not fast.read_bytes()[4] & 0x04
    assert jax_frame.decompress_frame(hc.read_bytes()) == data
    assert hc.stat().st_size < fast.stat().st_size
    with pytest.raises(SystemExit):
        main(["compress", str(src), str(tmp_path / "x"), "-B", "13KB"],
             device="cpu")
    capsys.readouterr()
    assert main(["decompress", str(src), str(tmp_path / "y")],
                device="cpu") == 1
    assert "not an LZ4 frame" in capsys.readouterr().err
    main(["info"], device="cpu")
    assert "segment" in capsys.readouterr().out
