"""The port's batched LZ4 block codec (``lz4_tpu_torch.kernels.codec``)
against the JAX package: ``jax_codec`` and the Pallas kernels in interpret
mode, on the same inputs, compared exactly (bytes, lengths, error codes).
On the CPU the port runs its plain versions (``test_torch_card.py`` holds
the CUDA kernels against them)."""

import numpy as np
import pytest
import torch

from lz4_tpu.core.constants import LZ4_64K_LIMIT, max_compressed_length
from lz4_tpu.core.lz4_block_ref import compress_fast_alloc
from lz4_tpu.kernels import jax_codec
from lz4_tpu.kernels.lz4_pallas import (
    PAD as KPAD, compress_fast_pallas, decompress_safe_pallas)
from lz4_tpu_torch import testing
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.kernels import codec, layout


def _alphabet_blocks(rng, spec):
    return [rng.integers(0, a, n, dtype=np.uint8).tobytes() for a, n in spec]


# (alphabet, size) of test_jax_kernels.py's fixture (:19) and of :189
FIXTURE_SPEC = [(1, 100), (4, 1000), (16, 3000), (256, 500), (2, 0), (8, 13),
                (3, 64)]
PALLAS_SPEC = [(4, 1000), (256, 300), (1, 500), (8, 13), (3, 0)]

# test_jax_kernels.py:42 and :128 (ends with a match; null matchDec) and
# :144 (4 literals, a null-offset match of 7, 14 literals)
ENDS_WITH_MATCH = bytes([96, 42, 43, 44, 45, 46, 47, 5, 0])
NULL_MATCH_DEC = bytes([16, 42, 0, 0, 128] + [42] * 8)
NULL_MATCH_ZEROS = (bytes([0x43]) + bytes(range(65, 69)) + bytes([0, 0, 0xE0])
                    + bytes(range(80, 94)))


def _jax(t, lens, pad=jax_codec.PAD):
    return layout.to_jax_layout(t, lens, pad)


def _assert_same(port, ref, ok_rows_only_lens=False):
    """port: (uint8 tensor, lens, err); ref: JAX (int32 rows, lens, err)."""
    data, lens, err = port
    rdata, rlens, rerr = (np.asarray(x) for x in ref)
    assert err.tolist() == rerr.tolist()
    for i, (e, n) in enumerate(zip(err.tolist(), lens.tolist())):
        if ok_rows_only_lens and e != codec.OK:
            continue
        assert n == int(rlens[i]), i
        if e == codec.OK:
            assert data[i, :n].numpy().tobytes() == \
                rdata[i, :n].astype(np.uint8).tobytes(), i


def _decode_batch(rng):
    blocks = _alphabet_blocks(rng, FIXTURE_SPEC)
    comp = [compress_fast_alloc(b) for b in blocks]
    fuzz = testing.fuzz_blocks(rng, comp, 64)
    batch = comp + fuzz + [ENDS_WITH_MATCH, NULL_MATCH_DEC, NULL_MATCH_ZEROS,
                           b"", b"\x00", b"\x10\x41"]
    return layout.to_device_layout(batch, device="cpu"), blocks


@pytest.mark.parametrize("out_max", [0, 20, 3000])
def test_decode_matches_jax_codec(out_max):
    (comp, comp_lens), blocks = _decode_batch(np.random.default_rng(out_max))
    port = codec.decompress_safe_batch(comp, comp_lens, out_max)
    ref = jax_codec.decompress_safe_batch(*_jax(comp, comp_lens), out_max)
    # on an error the JAX codec may count the literals it refused
    _assert_same(port, ref, ok_rows_only_lens=True)
    err = port[2].tolist()
    if out_max == 3000:
        assert err[:len(blocks)] == [codec.OK] * len(blocks)
        assert layout.from_device_layout(port[0], port[1])[:len(blocks)] == \
            blocks
    if out_max == 20:
        assert err[-6] == codec.ERR_MALFORMED     # ends with a match
        assert err[-5] == codec.OK                # null matchDec
    assert codec.ERR_MALFORMED in err or out_max == 0


def test_decode_matches_pallas_interpret():
    (comp, comp_lens), _ = _decode_batch(np.random.default_rng(7))
    for out_max in (20, 3000):
        port = codec.decompress_safe_batch(comp, comp_lens, out_max)
        ref = decompress_safe_pallas(*_jax(comp, comp_lens, KPAD), out_max,
                                     interpret=True)
        _assert_same(port, ref, ok_rows_only_lens=True)


def test_null_match_bytes_are_zeros():
    comp, lens = layout.to_device_layout([NULL_MATCH_ZEROS], device="cpu")
    out = torch.full((1, 64), 0xA5, dtype=torch.uint8)
    out, out_lens, err = codec.decompress_safe_batch(comp, lens, 25, out=out)
    assert err.tolist() == [codec.OK] and out_lens.tolist() == [25]
    assert out[0, :25].numpy().tobytes() == (
        bytes(range(65, 69)) + bytes(7) + bytes(range(80, 94)))
    assert bool((out[0, 25:] == 0xA5).all())     # nothing past out_max


@pytest.mark.parametrize("bad", list(testing.BAD_LENGTHS))
@pytest.mark.parametrize("name", testing.DECODERS)
def test_decode_lengths_outside_the_row_are_malformed(name, bad):
    """The decode wrappers read no length back: a row whose length lies
    outside ``[0, S]`` is that row's ``ERR_MALFORMED``, with out length
    (bytes read) 0 and its output row untouched, and every other row
    decodes as it does in the batch without it. A batch of the wrong
    structure still raises."""
    comp, lens, cap = testing.length_batch(np.random.default_rng(5), "cpu")
    n, stride, k = comp.shape[0], comp.shape[1], 2
    bad_lens = lens.clone()
    bad_lens[k] = testing.BAD_LENGTHS[bad](stride)
    out = torch.full((n, cap + 16), 0xA5, dtype=torch.uint8)
    got = testing.decode_with(name, comp, bad_lens, cap, out=out)
    assert (int(got[2][k]), int(got[1][k])) == (codec.ERR_MALFORMED, 0)
    assert bool((out[k] == 0xA5).all())
    keep = [i for i in range(n) if i != k]
    want = testing.decode_with(name, comp[keep], lens[keep], cap)
    assert got[2][keep].tolist() == want[2].tolist() == [codec.OK] * (n - 1)
    assert got[1][keep].tolist() == want[1].tolist()
    assert torch.equal(out[keep, :cap], want[0][:, :cap])
    with pytest.raises(ValueError):
        testing.decode_with(name, comp, lens.to(torch.int64), cap)
    with pytest.raises(ValueError):
        testing.decode_with(name, comp[:, :stride - 16], lens, cap)


def _compress_batch(rng):
    blocks = (_alphabet_blocks(rng, FIXTURE_SPEC + PALLAS_SPEC)
              + testing.mixed_blocks(rng, (5, 12, 13, 777)))
    return layout.to_device_layout(blocks, device="cpu"), blocks


@pytest.mark.parametrize("dest_cap", [max_compressed_length(3000), 120])
def test_compress_matches_jax_codec(dest_cap):
    (src, lens), blocks = _compress_batch(np.random.default_rng(dest_cap))
    port = codec.compress_fast_batch(src, lens, dest_cap)
    ref = jax_codec.compress_fast_batch(*_jax(src, lens), dest_cap)
    _assert_same(port, ref)
    err = port[2].tolist()
    if dest_cap == 120:
        assert codec.ERR_DEST_TOO_SMALL in err
    else:
        assert err == [codec.OK] * len(blocks)
        assert layout.from_device_layout(port[0], port[1]) == \
            [compress_fast_alloc(b) for b in blocks]


def test_compress_matches_pallas_interpret():
    (src, lens), blocks = _compress_batch(np.random.default_rng(3))
    dest_cap = max_compressed_length(3000)
    port = codec.compress_fast_batch(src, lens, dest_cap)
    ref = compress_fast_pallas(*_jax(src, lens, KPAD), dest_cap,
                               interpret=True)
    _assert_same(port, ref)
    assert not port[2].any()


def test_compress_per_block_variant_above_64k_limit():
    """A block from LZ4_64K_LIMIT on takes the 12-bit windowed variant and
    a short block in the same batch the 13-bit one, as the reference does."""
    rng = np.random.default_rng(11)
    big = rng.integers(0, 4, LZ4_64K_LIMIT + 4453, dtype=np.uint8).tobytes()
    period = (bytes(range(7)) * 20000)[:LZ4_64K_LIMIT + 100]
    small = rng.integers(0, 4, 3000, dtype=np.uint8).tobytes()
    blocks = [big, small, period]
    src, lens = layout.to_device_layout(blocks, device="cpu")
    comp, comp_lens, err = codec.compress_fast_batch(
        src, lens, max_compressed_length(len(big)))
    assert err.tolist() == [codec.OK] * 3
    assert layout.from_device_layout(comp, comp_lens) == \
        [compress_fast_alloc(b) for b in blocks]
    out, out_lens, derr = codec.decompress_safe_batch(comp, comp_lens,
                                                      len(big))
    assert derr.tolist() == [codec.OK] * 3
    assert layout.from_device_layout(out, out_lens) == blocks


@pytest.mark.parametrize("size", [65535, 65536, 65546, 65547])
def test_compress_table_edges_match_jax_codec(size):
    """Block lengths at the edge of the 13-bit table (65,546 B, the largest
    block of the 64K variant) and the first of the 12-bit one (65,547 B),
    on the main path's three kinds of data (``make_blocks``: random, a4,
    text, a4), against ``jax_codec`` a block at a time (its batched loop
    is far slower on the CPU at this size); the blocks decode back."""
    rows = sharded.make_blocks(4, LZ4_64K_LIMIT, 5)[:, :size]
    blocks = [r.tobytes() for r in rows]
    src, lens = layout.to_device_layout(blocks, device="cpu")
    cap = max_compressed_length(size)
    port = codec.compress_fast_batch(src, lens, cap)
    for i in range(len(blocks)):
        ref = jax_codec.compress_fast_batch(*_jax(src[i:i + 1], lens[i:i + 1]),
                                            cap)
        _assert_same(tuple(t[i:i + 1] for t in port), ref)
    assert port[2].tolist() == [codec.OK] * 4
    out, out_lens, err = codec.decompress_safe_batch(port[0], port[1], size)
    assert err.tolist() == [codec.OK] * 4
    assert layout.from_device_layout(out, out_lens) == blocks


def _fast_batch(rng, size=1000):
    """Blocks that all decode to ``size`` bytes, the same blocks with
    trailing bytes (more available than the block needs, the fast
    contract's point), fuzz, and the hand-made edge streams."""
    blocks = _alphabet_blocks(rng, [(1, size), (4, size), (256, size),
                                    (16, size)])
    comp = [compress_fast_alloc(b) for b in blocks]
    trailing = [c + rng.integers(0, 256, 9, dtype=np.uint8).tobytes()
                for c in comp]
    fuzz = testing.fuzz_blocks(rng, comp, 96)
    batch = comp + trailing + fuzz + [
        ENDS_WITH_MATCH, NULL_MATCH_DEC, NULL_MATCH_ZEROS, b"", b"\x00",
        b"\x00\x00", b"\x10\x41", b"\x10"]
    return layout.to_device_layout(batch, device="cpu"), blocks, comp


@pytest.mark.parametrize("dest_len", [0, 1, 13, 25, 1000])
def test_decode_fast_matches_jax_codec(dest_len):
    """``decompress_fast_plain`` against ``jax_codec.decompress_fast_batch``:
    error codes on every row, bytes read and the ``dest_len`` bytes on OK
    rows."""
    (comp, avail), blocks, exact = _fast_batch(
        np.random.default_rng(dest_len))
    port = codec.decompress_fast_batch(comp, avail, dest_len)
    assert [t.dtype for t in port] == [torch.uint8, torch.int32, torch.int32]
    ref = jax_codec.decompress_fast_batch(*_jax(comp, avail), dest_len)
    out, src_read, err = port
    rout, rread, rerr = (np.asarray(x) for x in ref)
    assert err.tolist() == rerr.tolist()
    for i, e in enumerate(err.tolist()):
        if e == codec.OK:
            assert int(src_read[i]) == int(rread[i]), i
            assert out[i, :dest_len].numpy().tobytes() == \
                rout[i, :dest_len].astype(np.uint8).tobytes(), i
    n = len(blocks)
    if dest_len == 1000:       # exact blocks and the same with trailing bytes
        assert err[:2 * n].tolist() == [codec.OK] * (2 * n)
        assert src_read[:2 * n].tolist() == [len(c) for c in exact] * 2
        assert [out[i, :1000].numpy().tobytes() for i in range(n)] == blocks
    if dest_len == 25:
        assert err[-6].tolist() == codec.OK           # NULL_MATCH_ZEROS
        assert out[-6, :25].numpy().tobytes() == (
            bytes(range(65, 69)) + bytes(7) + bytes(range(80, 94)))
    if dest_len == 0:          # b"", b"\x00": comp[0] is 0, one byte read
        assert err[-5:-3].tolist() == [codec.OK, codec.OK]
        assert src_read[-5:-3].tolist() == [1, 1]
    assert codec.ERR_MALFORMED in err.tolist()


def test_decode_fast_never_writes_past_dest_len():
    (comp, avail), _, _ = _fast_batch(np.random.default_rng(4), size=300)
    for dest_len in (0, 7, 300):
        out = torch.full((comp.shape[0], dest_len + 32), 0xA5,
                         dtype=torch.uint8)
        codec.decompress_fast_batch(comp, avail, dest_len, out=out)
        assert bool((out[:, dest_len:] == 0xA5).all())


def test_decode_fast_rejects_literals_past_the_input():
    """A fast-mode literal run that would read past the bytes available is
    malformed (``jax_codec.py:173``), also when it ends the block."""
    stream = bytes([0x50]) + b"ABCDE"           # 5 literals, the whole block
    comp, _ = layout.to_device_layout([stream], device="cpu")
    for avail, want in ((6, codec.OK), (5, codec.ERR_MALFORMED)):
        _, src_read, err = codec.decompress_fast_batch(
            comp, torch.tensor([avail], dtype=torch.int32), 5)
        assert err.tolist() == [want]
        if want == codec.OK:
            assert src_read.tolist() == [6]


def test_decode_reports_dest_too_small_and_empty_dest():
    data = bytes(range(200)) * 5
    comp, lens = layout.to_device_layout([compress_fast_alloc(data)],
                                         device="cpu")
    assert codec.decompress_safe_batch(comp, lens, 999)[2].tolist() == \
        [codec.ERR_DEST_TOO_SMALL]
    assert codec.decompress_safe_batch(comp, lens, 1000)[2].tolist() == \
        [codec.OK]
    empty, elen = layout.to_device_layout([b"\x00", b"\x00\x00", b""],
                                          device="cpu")
    assert codec.decompress_safe_batch(empty, elen, 0)[2].tolist() == \
        [codec.OK, codec.ERR_DEST_TOO_SMALL, codec.ERR_DEST_TOO_SMALL]



# (rows, out_max, the card's resident CTAs of the CTA-a-row decode) -> it
# runs; H100: 3 CTAs an SM x 132 SMs = 396
@pytest.mark.parametrize("n, out_max, capacity, smem", [
    (1, 65536, 396, True), (256, 65536, 396, True), (384, 65536, 396, True),
    (396, 65536, 396, True), (397, 65536, 396, False),
    (3072, 65536, 396, False), (1, 0, 396, True), (1, 1, 396, True),
    (384, 65537, 396, False), (256, 4 << 20, 396, False),
    (0, 65536, 396, False), (1, 65536, 0, False), (264, 65536, 264, True)])
def test_safe_decode_path_rule(n, out_max, capacity, smem):
    """``decompress_safe_batch`` takes the CTA-a-row kernel exactly when its
    rows fit the shared memory (at most 64 KiB out) and the batch fits the
    card in one round; from the batch's shape and the card's occupancy
    alone."""
    assert codec.takes_smem_path(n, out_max, capacity) is smem
