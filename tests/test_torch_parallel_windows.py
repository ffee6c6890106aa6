"""K7's window split and K8's rounds, in the g++ build of their bodies
(``tests/test_torch_host_kernels.py``'s harness), against the JAX
functions and the plain versions.

K7 cuts a row into windows (65,536 positions on the card): each window
finds its candidates in itself and the 65,535 positions before it, and a
pass over each row carries the run stops, the group chains, the literal
runs and the output offsets across the windows. Here each window runs as a
team of its own, with windows of 512 to 2,048 positions on rows of a few
windows (against the JAX function) and of the card's 65,536 on rows of
three windows and 17 bytes and a row of one repeated byte of 4 MiB + 1
(against the plain version). K8 runs its rounds in place when
``2 ** max_depth >= out_len`` and synchronous below that: chains of
exactly ``2 ** k - 1`` and ``2 ** k`` links, cycles and forward pointers
against the JAX function at every depth.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lz4_tpu.kernels import gather_decode as jgd
from lz4_tpu.kernels import parallel_compress as jpc
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.kernels import gather_decode, layout, parallel_compress
from test_torch_host_kernels import _host_gather, _host_parallel, lib  # noqa: F401

WL = 1024          # the windows the JAX comparison's rows are cut for
TIGHT = 600


@pytest.fixture(scope="module")
def small_rows():
    """Rows of three windows of WL and 17 bytes (and about one and two
    windows), the JAX function's rows at a full and a tight cap."""
    rows = testing.window_rows(np.random.default_rng(71), WL)
    bl = (max(len(r) for r in rows) + 3) & ~3
    arr, lens = jpc.to_layout(rows, bl)
    full = max_compressed_length(bl)
    want = {cap: tuple(np.asarray(a) for a in jpc.compress_parallel_batch(
        jnp.asarray(arr), jnp.asarray(lens), cap)) for cap in (full, TIGHT)}
    src, src_lens = layout.to_device_layout(rows, device="cpu")
    return src, src_lens, full, want


@pytest.mark.parametrize("wl, walk_limit, lanes, tight", [
    (1024, 64, 1, False), (1024, 0, 1, False), (512, 64, 1, False),
    (2048, 64, 1, False), (512, 1, 8, False), (1024, 64, 8, True),
    (512, 0, 1, True), (65536, 64, 1, False)])
def test_host_windows_match_jax(lib, small_rows, wl, walk_limit, lanes,  # noqa: F811
                                tight):
    """K7's bodies with windows of ``wl`` positions (each a team of its
    own; 8 host threads or one), hash walks of at most ``walk_limit``
    steps (0 and 1: the exact sort in nearly every window), against the
    JAX function byte for byte: runs of period 1-4 across every window end,
    a literal run over several windows, one byte repeated over the row
    (one sequence), rows about the window size; at a tight cap the rows
    past it are -1 with their first cap bytes."""
    src, lens, full, want = small_rows
    cap = TIGHT if tight else full
    out, out_lens = _host_parallel(lib, src, lens, cap, lanes, wl, walk_limit)
    assert out_lens.tolist() == want[cap][1].tolist()
    np.testing.assert_array_equal(out[:, :cap].numpy(), want[cap][0])
    assert not bool(out[:, cap:].any())
    if tight:
        assert (want[cap][1] == -1).any() and (want[cap][1] > 0).any()
    else:   # the repeated byte: one literal, one match, the last literals
        k = 6
        n = int(lens[k])
        run = n - 1 - 5 - 4
        assert int(out_lens[k]) == 1 + 1 + 2 + 1 + (run - 15) // 255 + 1 + 5


@pytest.fixture(scope="module")
def big_rows():
    rows = testing.window_rows(np.random.default_rng(72))
    return layout.to_device_layout(rows, device="cpu")


@pytest.mark.parametrize("pick", [slice(0, 4), slice(4, 7), slice(7, None)])
def test_host_card_windows_match_plain(lib, big_rows, pick):  # noqa: F811
    """The card's windows of 65,536 positions on rows of three windows and
    17 bytes (runs of period 1-4 across each window end; mixed runs; a
    literal run over windows; one repeated byte) and rows a byte around
    one and two windows, against the plain version."""
    src, lens = big_rows
    src, lens = src[pick].contiguous(), lens[pick].contiguous()
    cap = max_compressed_length(src.shape[1])
    host = _host_parallel(lib, src, lens, cap)
    plain = parallel_compress.compress_parallel_plain(src, lens, cap)
    assert host[1].tolist() == plain[1].tolist()
    assert torch.equal(host[0], plain[0])


def test_host_repeated_byte_4mib(lib):  # noqa: F811
    """One byte repeated over 4 MiB + 1 (65 windows): one match sequence
    with its full extension bytes, then the last literals, as the plain
    version writes it."""
    n = (4 << 20) + 1
    src, lens = layout.to_device_layout([b"\x61" * n], device="cpu")
    cap = max_compressed_length(src.shape[1])
    host = _host_parallel(lib, src, lens, cap)
    plain = parallel_compress.compress_parallel_plain(src, lens, cap)
    assert host[1].tolist() == plain[1].tolist()
    assert torch.equal(host[0], plain[0])
    run = n - 1 - 5 - 4
    ext = 1 + (run - 15) // 255
    assert int(host[1][0]) == 1 + 1 + 2 + ext + 1 + 5
    assert host[0][0, 0].item() == 0x1F and host[0][0, 2:4].tolist() == [1, 0]


@pytest.mark.parametrize("out_len, max_depth, lanes", [
    (40, 0, 1), (40, 1, 1), (40, 2, 1), (40, 3, 1), (40, 32, 1),
    (8, 0, 1), (8, 1, 1), (8, 2, 1), (8, 3, 1), (8, 32, 1),
    (40, 2, 8), (40, 32, 8), (8, 3, 8)])
def test_host_gather_links_match_jax(lib, out_len, max_depth, lanes):  # noqa: F811
    """K8's body on ``testing.link_tables``: chains of exactly 2^k - 1 and
    2^k links (k = 0-3), forward pointers, a cycle, a self-parent byte and
    a null offset, against the JAX function at max_depth 0-3 and 32; at
    out_len 8 and max_depth 3 the rounds run in place."""
    tables, comp = testing.link_tables(out_len)
    want = np.asarray(jgd.gather_decompress_batch(comp, *tables, out_len,
                                                  max_depth))
    got = _host_gather(lib, torch.from_numpy(comp), torch.from_numpy(tables),
                       out_len, max_depth, lanes)
    np.testing.assert_array_equal(got.numpy(), want)
    if max_depth < 31:   # row 0: byte j is j links from its literal
        done = min(out_len, 1 << max_depth)
        assert bool(got[0, :done].all()) and not bool(got[0, done:].any())


@pytest.mark.parametrize("out_len, max_depth, in_place, rounds", [
    (1, 0, True, 1), (8, 3, True, 4), (9, 3, False, 3), (65536, 16, True, 17),
    (65536, 15, False, 15), (70000, 32, True, 18), (40, 0, False, 0)])
def test_gather_rounds_split(lib, out_len, max_depth, in_place, rounds):  # noqa: F811
    """K8 runs in place exactly when 2^max_depth >= out_len, then at most
    ceil(log2(out_len)) + 1 rounds; else max_depth synchronous rounds."""
    got = lib.host_gd_rounds(out_len, max_depth)
    assert got == (rounds if in_place else -rounds)
    assert (got > 0 or (got == 0 and in_place)) == in_place


@pytest.mark.parametrize("max_depth", [0, 1, 2, 3, 32])
def test_plain_gather_links_match_jax(max_depth):
    """The plain version on the link tables equals the JAX function."""
    for out_len in (40, 8):
        tables, comp = testing.link_tables(out_len)
        want = np.asarray(jgd.gather_decompress_batch(comp, *tables, out_len,
                                                      max_depth))
        got = gather_decode.gather_decompress_plain(
            torch.from_numpy(comp), *(torch.from_numpy(t) for t in tables),
            out_len, max_depth)
        np.testing.assert_array_equal(got.numpy(), want)
