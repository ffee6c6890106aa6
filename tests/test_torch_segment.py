"""The port's sequence parser and segment decode (``lz4_tpu_torch.kernels.
sequences`` and ``segment_decode``, the plain versions of the parse kernel
and K5) against the JAX package: ``gather_decode.parse_packed`` (its native
parser, zeroed tails), ``segment_decode.decompress_segments_pallas`` in
interpret mode and ``segment_decode.decompress_blocks``. Inputs are seeded
numpy data; every comparison is exact."""

import re

import numpy as np
import pytest
import torch

from lz4_tpu.core.errors import Lz4Error as JaxLz4Error
from lz4_tpu.core.lz4_block_ref import compress_fast_alloc
from lz4_tpu.kernels import gather_decode
from lz4_tpu.kernels import segment_decode as jax_segment
from lz4_tpu.kernels.lz4_pallas import PAD as JAX_PAD
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.kernels import codec, layout, segment_decode, sequences


def _periods(rng, size):
    return [(rng.integers(0, 256, p, dtype=np.uint8).tobytes()
             * (size // p + 1))[:size] for p in range(1, 16)]


_SEEDS = {"mixed": 1, "ragged": 2, "periods": 3, "big": 4}


def _block_set(kind):
    rng = np.random.default_rng(_SEEDS[kind])
    if kind == "mixed":
        return testing.mixed_blocks(rng, (0, 5, 13, 1000, 4096))
    if kind == "ragged":
        return [rng.integers(0, 8, n, dtype=np.uint8).tobytes()
                for n in (13, 64, 100, 501, 777)]
    if kind == "periods":
        return _periods(rng, 1024)
    if kind == "big":       # one block over 64 KiB: the 12-bit table
        return [rng.integers(0, 4, 70000, dtype=np.uint8).tobytes(),
                bytes(66000)]
    raise ValueError(kind)


def _jax_parse(comp_blocks, max_seq):
    """The JAX package's tables of each block, or its parse code."""
    offs = np.cumsum([0] + [len(c) for c in comp_blocks[:-1]]).astype(np.int64)
    lens = np.array([len(c) for c in comp_blocks], np.int32)
    return gather_decode.parse_packed(b"".join(comp_blocks), offs, lens,
                                      max_seq, sentinel_tails=False)


def _port_parse(comp_blocks, max_seq=None):
    comp, comp_lens = layout.to_device_layout(comp_blocks, device="cpu")
    return sequences.parse_sequences(comp, comp_lens, max_seq)


@pytest.mark.parametrize("kind", ["mixed", "ragged", "periods", "big"])
def test_parse_matches_native_parser(kind):
    comp_blocks = [compress_fast_alloc(b) for b in _block_set(kind)]
    tables, n_seq, out_total = _port_parse(comp_blocks)
    s = sequences.max_seq_for(max(len(c) for c in comp_blocks))
    assert tables.shape == (6, len(comp_blocks), s)
    arrs, want_n, want_total = _jax_parse(comp_blocks, s)
    assert n_seq.tolist() == want_n.tolist()
    assert out_total.tolist() == want_total.tolist()
    for name, t in zip(sequences.TABLES, tables):
        np.testing.assert_array_equal(t.numpy(), arrs[name], err_msg=name)


def _jax_code(comp_block, max_seq):
    """The native parser's code for one block: its sequence count, or the
    negative code its error message names."""
    try:
        return int(_jax_parse([comp_block], max_seq)[1][0])
    except JaxLz4Error as e:
        return int(re.search(r"parse code (-\d+)", str(e)).group(1))


@pytest.mark.parametrize("max_seq", [None, 24])
def test_parse_codes_on_malformed_blocks(max_seq):
    """Fuzzed blocks: the port's code of every block equals the native
    parser's, and the tables of the blocks it accepts are the same."""
    rng = np.random.default_rng(7)
    good = [compress_fast_alloc(b) for b in _block_set("mixed")]
    fuzz = testing.fuzz_blocks(rng, good, 160)
    tables, n_seq, _ = _port_parse(fuzz, max_seq)
    s = tables.shape[2]
    codes = [_jax_code(c, s) for c in fuzz]
    assert n_seq.tolist() == codes
    assert sequences.PARSE_MALFORMED in codes
    assert (sequences.PARSE_TOO_MANY in codes) == (max_seq == 24)
    ok = [i for i, c in enumerate(codes) if c >= 0]
    arrs, _, _ = _jax_parse([fuzz[i] for i in ok], s)
    for name, t in zip(sequences.TABLES, tables):
        np.testing.assert_array_equal(t[ok].numpy(), arrs[name], err_msg=name)


def test_parse_boundary_blocks_and_length_cap():
    """The boundary blocks, and match length extensions one 0xFF byte
    below and at the 0x7E000000 cap (about 8.3 MB of 0xFF), against the
    native parser."""
    below, at = (bytes([0x1F, 65, 1, 0]) + b"\xff" * k + bytes([0, 0])
                 for k in (8_289_918, 8_289_919))
    blocks = testing.boundary_blocks() + [below, at]
    _, n_seq, total = _port_parse(blocks)
    s = sequences.max_seq_for(len(at))
    assert n_seq.tolist() == [_jax_code(c, s) for c in blocks]
    assert n_seq.tolist() == [2, 2, -2, -2, 2, -2]
    assert total.tolist() == [13, 10, 0, 0, 1 + 15 + 255 * 8_289_918 + 4, 0]


def test_parse_blocks_raises_like_the_native_parser():
    good = compress_fast_alloc(bytes(range(200)) * 4)
    bad = b"\xf0\x01"                       # literal run extension cut off
    with pytest.raises(JaxLz4Error) as want:
        gather_decode.parse_blocks([good, bad])
    with pytest.raises(Lz4Error) as got:
        sequences.parse_blocks([good, bad], device="cpu")
    assert str(got.value) == str(want.value)
    tables, n_seq, out_total = sequences.parse_blocks([good], device="cpu")
    assert set(tables) == set(sequences.TABLES)
    assert out_total.tolist() == [800]


def _jax_segments(comp_blocks, arrs, n_seq, out_max):
    cmax = max(len(c) for c in comp_blocks)
    comp = np.zeros((len(comp_blocks), cmax + JAX_PAD), np.int32)
    for i, c in enumerate(comp_blocks):
        comp[i, :len(c)] = np.frombuffer(c, np.uint8)
    out = jax_segment.decompress_segments_pallas(
        comp, n_seq, *(arrs[k] for k in sequences.TABLES), out_max=out_max,
        interpret=True)
    return np.asarray(out)[:, :out_max]


@pytest.mark.parametrize("kind", ["mixed", "ragged", "periods"])
def test_segments_match_pallas_kernel(kind):
    """The same tables through the Pallas kernel (interpret mode) and the
    port's plain K5; the batch crosses with ``layout.from_jax_layout``."""
    blocks = _block_set(kind)
    comp_blocks = [compress_fast_alloc(b) for b in blocks]
    out_max = max(len(b) for b in blocks)
    s = sequences.max_seq_for(max(len(c) for c in comp_blocks))
    arrs, n_seq, _ = _jax_parse(comp_blocks, s)
    want = _jax_segments(comp_blocks, arrs, n_seq, out_max)

    jax_comp, jax_lens = layout.to_jax_layout(
        *layout.to_device_layout(comp_blocks, device="cpu"), JAX_PAD)
    comp, comp_lens = layout.from_jax_layout(jax_comp, jax_lens)
    tables = torch.from_numpy(np.stack([arrs[k] for k in sequences.TABLES]))
    out, err = segment_decode.decompress_segments(
        comp, comp_lens, torch.from_numpy(n_seq), tables, out_max)
    assert err.tolist() == [codec.OK] * len(blocks)
    np.testing.assert_array_equal(out[:, :out_max].numpy(), want)
    for i, b in enumerate(blocks):
        assert out[i, :len(b)].numpy().tobytes() == b


def test_null_offset_holes_are_zeros():
    """A null match offset writes nothing: its bytes stay zeros, in the
    Pallas kernel and in the port (``test_gather_decode.py``'s block)."""
    comp_blocks = [bytes([16, 42, 0, 0, 128] + [42] * 8)]
    arrs, n_seq, total = _jax_parse(comp_blocks, 8)
    want = _jax_segments(comp_blocks, arrs, n_seq, 13)
    out = segment_decode.decompress_blocks(comp_blocks, 13, device="cpu")
    assert out == [bytes(want[0].astype(np.uint8))]
    assert out[0] == b"*" + bytes(4) + b"*" * 8
    assert int(total[0]) == 13


@pytest.mark.parametrize("kind", ["mixed", "ragged", "periods"])
def test_decompress_blocks_matches_jax(kind):
    blocks = _block_set(kind)
    comp_blocks = [compress_fast_alloc(b) for b in blocks]
    out_len = max(len(b) for b in blocks)
    got = segment_decode.decompress_blocks(comp_blocks, out_len, device="cpu")
    assert got == blocks
    assert got == jax_segment.decompress_blocks(comp_blocks, out_len,
                                                interpret=True)


def test_block_decoding_past_out_len_raises():
    """The port raises where the JAX package returns a truncated row: a
    4000-byte block asked to fit 64 bytes."""
    comp = [compress_fast_alloc(bytes(range(16)) * 250)]
    with pytest.raises(Lz4Error, match="past 64"):
        segment_decode.decompress_blocks(comp, 64, device="cpu")
    jax_out = jax_segment.decompress_blocks(comp, 64, interpret=True)
    assert len(jax_out[0]) == 64 + JAX_PAD      # the fault the port avoids
    assert jax_out[0] != (bytes(range(16)) * 250)


def corrupt(tables, row, kind, comp_len, out_max):
    """Move one sequence of ``row`` just out of bounds: the smallest change
    that must make the block MALFORMED."""
    t = tables[:, row]
    k = int(torch.nonzero((t[2] > 0) & (t[5] > 0)).flatten()[0])
    lit_len, m_out, m_len = int(t[2, k]), int(t[3, k]), int(t[5, k])
    field, value = {
        "lit_src": (1, comp_len - lit_len + 1),   # reads one byte past
        "lit_out": (0, out_max - lit_len + 1),    # writes one byte past
        "m_dist": (4, m_out + 1),                 # one byte before the start
        "m_out": (3, out_max - m_len + 1),        # writes one byte past
        "zero_dist": (4, 0),
        "negative": (2, -1),
    }[kind]
    t[field, k] = value


CORRUPTIONS = ["lit_src", "lit_out", "m_dist", "m_out", "zero_dist",
               "negative"]


@pytest.mark.parametrize("kind", CORRUPTIONS)
def test_corrupted_table_is_malformed(kind):
    blocks = _block_set("mixed")
    comp, comp_lens = layout.to_device_layout(
        [compress_fast_alloc(b) for b in blocks], device="cpu")
    tables, n_seq, _ = sequences.parse_sequences(comp, comp_lens)
    row = int(torch.argmax(n_seq))           # the block with most sequences
    corrupt(tables, row, kind, int(comp_lens[row]), 4096)
    guard = torch.full((len(blocks), 4096 + 64), 0xA5, dtype=torch.uint8)
    out, err = segment_decode.decompress_segments(comp, comp_lens, n_seq,
                                                  tables, 4096, out=guard)
    assert int(err[row]) == codec.ERR_MALFORMED
    assert not out[row, :4096].any()
    assert bool((guard[:, 4096:] == 0xA5).all())
    ok = [i for i in range(len(blocks)) if i != row]
    assert err[ok].tolist() == [codec.OK] * len(ok)
    n_seq[0] = tables.shape[2] + 1               # a count past the tables
    assert int(segment_decode.decompress_segments(
        comp, comp_lens, n_seq, tables, 4096)[1][0]) == codec.ERR_MALFORMED
