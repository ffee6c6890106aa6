"""The port's gather decode (K8's plain version, the parser's sentinel
tails, ``decompress_blocks`` on the CPU) against
``lz4_tpu.kernels.gather_decode``: the cases of ``test_gather_decode.py``,
the tables of the JAX module's native parser, and chains that a small
``max_depth`` cuts short."""

import random

import numpy as np
import pytest
import torch

from lz4_tpu.core.lz4_block_ref import compress_fast_alloc
from lz4_tpu.kernels import gather_decode as jgd
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.kernels import gather_decode as gd, sequences

from conftest import random_bytes

NULL_OFFSET = bytes([16, 42, 0, 0, 128] + [42] * 8)


@pytest.fixture(scope="module")
def cases():
    """The reference cases of ``test_gather_decode.py`` and the chain
    blocks, with their compressed forms and the JAX parser's tables."""
    rng = random.Random(51)
    raws = [random_bytes(rng, n, a) for a, n in
            [(4, 1000), (16, 3000), (256, 200), (2, 500), (1, 2000),
             (8, 64), (3, 13)]]
    raws += [b"abc" * 700, bytes(1500), b"x" + b"ab" * 400]
    comp = [compress_fast_alloc(b) for b in raws]
    for c, r in testing.chain_blocks(np.random.default_rng(51)):
        comp.append(c)
        raws.append(r)
    comp.append(NULL_OFFSET)
    raws.append(b"*" + bytes(4) + b"*" * 8)
    arrs, n_seq, out_total = jgd.parse_blocks(comp)
    width = max(len(c) for c in comp)
    rows = np.zeros((len(comp), width), np.uint8)
    for i, c in enumerate(comp):
        rows[i, :len(c)] = np.frombuffer(c, np.uint8)
    return raws, comp, rows, arrs, n_seq, out_total


def test_decompress_blocks_matches_reference(cases):
    raws, comp = cases[:2]
    assert gd.decompress_blocks(comp, max(len(r) for r in raws),
                                device="cpu") == raws


def test_null_match_offset_decodes_as_zeros():
    out = gd.decompress_blocks([NULL_OFFSET], 13, device="cpu")[0]
    assert out == jgd.decompress_blocks([NULL_OFFSET], 13)[0]
    assert out[0] == 42 and out[1:5] == bytes(4) and out[5:] == b"*" * 8


def test_parse_rejects_malformed():
    bad = bytes([96, 42, 43, 44, 45, 46, 47, 5])  # truncated
    with pytest.raises(Lz4Error):
        gd.parse_blocks([bad], device="cpu")


def test_sentinel_tables_equal_the_native_parsers(cases):
    """``parse_blocks`` gives the JAX module's tables, entry for entry: its
    sentinel tails (1 << 30 in lit_out and m_out) included, and its
    coverage of [0, len) in order."""
    comp, arrs, n_seq, out_total = cases[1], cases[3], cases[4], cases[5]
    tables, got_n, got_total = gd.parse_blocks(comp, device="cpu")
    assert got_n.tolist() == n_seq.tolist()
    assert got_total.tolist() == out_total.tolist()
    for name in sequences.TABLES:
        np.testing.assert_array_equal(tables[name].numpy(), arrs[name], name)
    assert int(tables["m_out"][0, -1]) == sequences.SENTINEL
    packed = gd.parse_packed(b"".join(comp), np.cumsum(
        [0] + [len(c) for c in comp[:-1]]), [len(c) for c in comp],
        tables["lit_out"].shape[1], sentinel_tails=False, device="cpu")[0]
    assert not bool(packed["m_out"][0, int(n_seq[0]):].any())


@pytest.mark.parametrize("max_depth", [0, 1, 2, 3, 32])
def test_plain_matches_jax_at_every_depth(cases, max_depth):
    """The plain version on the JAX parser's tables equals
    ``gather_decompress_batch`` byte for byte; below 32 rounds the chains
    stop short (zeros where unresolved), and at 32 every block decodes."""
    raws, _, rows, arrs = cases[:4]
    out_len = max(len(r) for r in raws)
    tabs = [arrs[k] for k in sequences.TABLES]
    want = np.asarray(jgd.gather_decompress_batch(rows, *tabs, out_len,
                                                  max_depth))
    got = gd.gather_decompress_batch(torch.from_numpy(rows),
                                     *(torch.from_numpy(t) for t in tabs),
                                     out_len, max_depth)
    np.testing.assert_array_equal(got.numpy(), want)
    done = [got[i, :len(r)].numpy().tobytes() == r for i, r in enumerate(raws)]
    assert all(done) == (max_depth == 32)


def test_block_past_out_len_truncates_as_jax(cases):
    """A block that decodes past ``out_len`` comes back cut to ``out_len``
    bytes, as the JAX function returns it; the others whole."""
    raws, comp = cases[:2]
    want = jgd.decompress_blocks(comp[:2], 64)
    assert want[0] == raws[0][:64] and want[1] == raws[1][:64]
    assert gd.decompress_blocks(comp[:2], 64, device="cpu") == want
    short = [c for c, r in zip(comp, raws) if 0 < len(r) <= 64][:1]
    assert short and gd.decompress_blocks(short + comp[:1], 64,
                                          device="cpu") == \
        jgd.decompress_blocks(short + comp[:1], 64)
