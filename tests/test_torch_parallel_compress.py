"""The port's parallel compressor (K7's plain version, ``compress_blocks``
on the CPU), the ``parallel`` engine and its command line, against
``lz4_tpu.kernels.parallel_compress`` and the JAX ``parallel`` engine, byte
for byte. The JAX function compiles once a shape, so the module shares its
calls: one batch of edge blocks at BL = 2052 (at a full and a tight cap),
the two window blocks past 64 KiB, and one stream."""

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu.core.lz4_block_ref import decompress_safe_alloc
from lz4_tpu.formats import frame as jax_frame
from lz4_tpu.kernels import parallel_compress as jpc
from lz4_tpu.streams import compress_stream as jax_compress_stream
from lz4_tpu_torch import testing
from lz4_tpu_torch.__main__ import main
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.core.errors import Lz4FrameError
from lz4_tpu_torch.kernels import layout, parallel_compress as pc
from lz4_tpu_torch.streams import compress_stream, decompress_stream, get_engine

BL = 2052          # the longest edge block (2049 bytes) rounded to 4
TIGHT = 40


@pytest.fixture(scope="module")
def edge():
    """The edge blocks, their JAX layout, and the JAX function's rows and
    lengths at the full cap and at TIGHT."""
    blocks = testing.parallel_blocks(np.random.default_rng(41))
    arr, lens = jpc.to_layout(blocks, BL)
    full = max_compressed_length(BL)
    jax_out = {cap: tuple(np.asarray(a) for a in jpc.compress_parallel_batch(
        jnp.asarray(arr), jnp.asarray(lens), cap)) for cap in (full, TIGHT)}
    return blocks, arr, lens, jax_out


@pytest.mark.parametrize("cap", ["full", "tight"])
def test_plain_matches_jax_rows(edge, cap):
    """Every row and length of the plain version equal the JAX function's,
    on the JAX layout's rows: at a tight cap the rows that do not fit are
    -1 and hold the first ``cap`` bytes of their encoding, as JAX's do."""
    blocks, arr, lens, jax_out = edge
    cap = max_compressed_length(BL) if cap == "full" else TIGHT
    src, src_lens = layout.from_jax_layout(arr, lens)
    out, out_lens = pc.compress_parallel_plain(src, src_lens, cap)
    want_out, want_lens = jax_out[cap]
    assert out_lens.tolist() == want_lens.tolist()
    np.testing.assert_array_equal(out[:, :cap].numpy(), want_out)
    assert not bool(out[:, cap:].any())
    if cap == TIGHT:
        assert (want_lens == -1).any() and (want_lens > 0).any()


def test_compress_blocks_matches_jax(edge):
    """``compress_blocks`` on the CPU equals the JAX function's (same
    rounding of ``block_len`` and cap), and every block decodes back."""
    blocks = edge[0]
    got = pc.compress_blocks(blocks, BL, device="cpu")
    assert got == jpc.compress_blocks(blocks, BL)
    for b, c in zip(blocks, got):
        assert bytes(decompress_safe_alloc(c, len(b))) == b


def test_output_does_not_depend_on_the_batch_width(edge):
    """A block comes out the same alone at its own width, in the batch of
    BL, and in a wider batch whose row tails are 0xA5."""
    blocks = edge[0]
    want = pc.compress_blocks(blocks, BL, device="cpu")
    pick = [0, 5, 16, 40, 77, 101, len(blocks) - 1]
    for i in pick:
        assert pc.compress_blocks([blocks[i]], device="cpu") == [want[i]]
    src, lens = layout.to_device_layout(blocks, 3 * BL, device="cpu")
    col = torch.arange(src.shape[1])
    src[col >= lens[:, None]] = 0xA5
    out, out_lens = pc.compress_parallel_batch(src, lens,
                                               max_compressed_length(BL))
    assert layout.from_device_layout(out, out_lens) == want


def test_window_clamp_beyond_64k():
    """``test_parallel_compress.py::test_offset_window_clamp_beyond_64k``:
    a repeat just outside the window is not a match, one just inside is;
    both blocks equal the JAX function's bytes."""
    blocks = testing.window_clamp_blocks()
    got = pc.compress_blocks(blocks, device="cpu")
    assert got == jpc.compress_blocks(blocks)
    for b, c in zip(blocks, got):
        assert bytes(decompress_safe_alloc(c, len(b))) == b
    assert len(got[1]) < len(got[0]) - 20


def test_tight_cap_is_minus_one_through_the_wrapper(edge):
    """The wrapper on a CPU tensor is the plain version: -1 at a tight
    cap."""
    src, lens = layout.to_device_layout(edge[0], device="cpu")
    out, out_lens = pc.compress_parallel_batch(src, lens, TIGHT)
    assert out_lens.tolist() == edge[3][TIGHT][1].tolist()


def _stream_data() -> bytes:
    rng = np.random.default_rng(42)
    return b"".join(testing.block_of(rng, kind, 50000) for kind in
                    ("text", "alphabet4", "incompressible"))


@pytest.fixture(scope="module")
def jax_parallel_frame():
    data = _stream_data()
    sink = io.BytesIO()
    jax_compress_stream(io.BytesIO(data), sink, engine="parallel")
    return data, sink.getvalue()


@pytest.mark.parametrize("batch_blocks", [256, 1])
def test_parallel_engine_frame_equals_jax(jax_parallel_frame, batch_blocks):
    """The ``parallel`` engine's frame equals the JAX engine's byte for
    byte, in batches of 256 blocks (the packed path) and of one block (a
    short last block alone); the ``cuda`` and ``segment`` engines and the
    JAX frame reader restore it."""
    data, want = jax_parallel_frame
    sink = io.BytesIO()
    compress_stream(io.BytesIO(data), sink, engine="parallel",
                    batch_blocks=batch_blocks, device="cpu")
    assert sink.getvalue() == want
    for engine in ("cuda", "segment", "parallel"):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(want), back, engine=engine, device="cpu")
        assert back.getvalue() == data
    assert jax_frame.decompress_frame(want) == data


def test_parallel_engine_listed_form_equals_packed(jax_parallel_frame):
    """The engine's listed compress (``compress_blocks`` a batch) gives
    the packed path's blocks."""
    data, _ = jax_parallel_frame
    engine = get_engine("parallel", device="cpu")
    blocks = [data[i:i + 65536] for i in range(0, len(data), 65536)]
    src, lens, comp, comp_lens, err = engine.compress_packed(
        torch.frombuffer(bytearray(data), dtype=torch.uint8), 65536)
    assert not bool(err.any())
    assert engine.compress_batch(blocks) == layout.from_device_layout(
        comp, comp_lens)


def test_parallel_engine_refuses_hc_levels():
    assert get_engine("parallel", device="cpu").name == "parallel"
    for level in (1, 9, 17):
        with pytest.raises(Lz4FrameError, match="engine 'parallel' has no HC"):
            get_engine("parallel", level, "cpu")
    with pytest.raises(Lz4FrameError, match="no HC mode"):
        compress_stream(io.BytesIO(b"x" * 100), io.BytesIO(),
                        engine="parallel", level=9, device="cpu")


def test_cli_parallel_round_trip(tmp_path, capsys, jax_parallel_frame):
    """``compress --engine parallel`` writes the engine's frame at 64 KiB
    blocks, ``decompress`` restores it; ``decompress`` has no
    ``parallel``, as the JAX command line has none; ``info`` names it."""
    data, want = jax_parallel_frame
    src, dst, back = (tmp_path / n for n in ("in.bin", "out.lz4", "back.bin"))
    src.write_bytes(data)
    assert main(["compress", str(src), str(dst), "--engine", "parallel",
                 "-B", "64KB"], device="cpu") == 0
    assert "[parallel]" in capsys.readouterr().out
    assert dst.read_bytes() == want
    assert main(["decompress", str(dst), str(back)], device="cpu") == 0
    assert back.read_bytes() == data
    with pytest.raises(SystemExit):
        main(["decompress", str(dst), str(back), "--engine", "parallel"],
             device="cpu")
    assert main(["compress", str(src), str(dst), "--engine", "parallel",
                 "-l", "9"], device="cpu") == 1
    assert "no HC mode" in capsys.readouterr().err
    main(["info"], device="cpu")
    assert "parallel (K7)" in capsys.readouterr().out
