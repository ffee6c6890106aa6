"""The per-block bodies of the port's CUDA kernels (``lz4_tpu_torch/csrc/
*.cuh``), built for the host with g++ as one-lane teams, against the plain
versions on the same seeded inputs. This catches logic faults in the
kernels' code without a card; the package never uses this build."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.kernels import (
    build, codec, layout, segment_decode, sequences, xxhash, xxhash_stream)
from test_torch_segment import CORRUPTIONS, corrupt

HARNESS = r"""
#include "lz4_compress.cuh"
#include "lz4_decode.cuh"
#include "lz4_parse.cuh"
#include "segment_decode.cuh"
#include "xxh32.cuh"
#include "xxh64.cuh"
#include <vector>

extern "C" {
void host_decode(const uint8_t* comp, long long comp_stride,
                 const int32_t* comp_lens, uint8_t* out, long long out_stride,
                 int out_max, int32_t* out_lens, int32_t* err, int n) {
  HostTeam t;
  int32_t read;
  for (int b = 0; b < n; b++)
    lz4tt_decode_block<false>(t, comp + b * comp_stride, comp_lens[b],
                              out + b * out_stride, out_max, &out_lens[b],
                              &read, &err[b]);
}
void host_decode_fast(const uint8_t* comp, long long comp_stride,
                      const int32_t* comp_avail, uint8_t* out,
                      long long out_stride, int dest_len, int32_t* src_read,
                      int32_t* err, int n) {
  HostTeam t;
  int32_t len;
  for (int b = 0; b < n; b++)
    lz4tt_decode_block<true>(t, comp + b * comp_stride, comp_avail[b],
                             out + b * out_stride, dest_len, &len,
                             &src_read[b], &err[b]);
}
void host_compress(const uint8_t* src, long long src_stride,
                   const int32_t* src_lens, uint8_t* dst, long long dst_stride,
                   int dest_cap, int32_t* out_lens, int32_t* err, int n) {
  HostTeam t;
  std::vector<int32_t> table(1 << LZ4TT_HASH_LOG_64K);
  for (int b = 0; b < n; b++)
    lz4tt_compress_block(t, src + b * src_stride, src_lens[b],
                         dst + b * dst_stride, dest_cap, dst_stride,
                         table.data(), &out_lens[b], &err[b]);
}
void host_xxh32(const uint8_t* data, long long stride, const int32_t* lens,
                unsigned seed, uint32_t* out, int n) {
  for (int b = 0; b < n; b++)
    out[b] = lz4tt_xxh32(data + b * stride, lens[b], seed);
}
void host_xxh64(const uint8_t* data, long long stride, const int32_t* lens,
                unsigned long long seed, uint64_t* out, int n) {
  for (int b = 0; b < n; b++)
    out[b] = lz4tt_xxh64(data + b * stride, lens[b], seed);
}
// the parse kernel's body, one block after the other; tables zeroed
void host_parse(const uint8_t* comp, long long comp_stride,
                const int32_t* comp_lens, int max_seq, int32_t* tables,
                int32_t* n_seq, int32_t* out_total, int n) {
  const int64_t f = (int64_t)n * max_seq;
  for (int b = 0; b < n; b++) {
    int32_t* r = tables + (int64_t)b * max_seq;
    const Lz4ttSeqRow row = {r, r + f, r + 2 * f, r + 3 * f, r + 4 * f,
                             r + 5 * f};
    int32_t written;
    n_seq[b] = lz4tt_parse_block(comp + b * comp_stride, comp_lens[b], max_seq,
                                 row, &written, &out_total[b]);
  }
}
// K5's phases in the kernel's order, by a one-lane team
void host_segment(const uint8_t* comp, long long comp_stride,
                  const int32_t* comp_lens, const int32_t* n_seq,
                  const int32_t* tables, int max_seq, uint8_t* out,
                  long long out_stride, int out_max, int32_t* err, int n) {
  HostTeam t;
  for (int b = 0; b < n; b++) {
    const Lz4ttSeqTables s = lz4tt_seq_tables(tables, n, max_seq, b);
    uint8_t* row = out + b * out_stride;
    const int32_t ns = n_seq[b];
    lz4tt_segment_zero(t, row, out_max);
    bool bad = ns < 0 || ns > max_seq;
    for (int32_t k = 0; !bad && k < ns; k++)
      bad = !lz4tt_segment_ok(s, k, comp_lens[b], out_max);
    err[b] = bad ? LZ4TT_ERR_MALFORMED : LZ4TT_OK;
    if (bad) continue;
    for (int32_t k = 0; k < ns; k++)
      lz4tt_segment_literal(t, comp + b * comp_stride, row, s, k);
    lz4tt_segment_matches(t, row, s, ns);
  }
}
void host_xxh32_stripes(const uint8_t* data, long long n_stripes,
                        uint32_t* lanes) {
  lz4tt_xxh32_stripes(data, n_stripes, lanes);
}
void host_xxh64_stripes(const uint8_t* data, long long n_stripes,
                        uint64_t* lanes) {
  lz4tt_xxh64_stripes(data, n_stripes, lanes);
}
}
"""

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "harness.cpp").write_text(HARNESS)
    res = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-Wall", "-Werror",
         "-Wno-unknown-pragmas", "-I", str(build.CSRC), "-o",
         str(out / "libhost.so"), str(out / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libhost.so"))
    lib.host_decode.argtypes = [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32]
    lib.host_decode_fast.argtypes = lib.host_decode.argtypes
    lib.host_compress.argtypes = [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32]
    lib.host_xxh32.argtypes = [_P, _I64, _P, ctypes.c_uint, _P, _I32]
    lib.host_xxh64.argtypes = [_P, _I64, _P, ctypes.c_ulonglong, _P, _I32]
    lib.host_parse.argtypes = [_P, _I64, _P, _I32, _P, _P, _P, _I32]
    lib.host_segment.argtypes = [_P, _I64, _P, _P, _P, _I32, _P, _I64, _I32,
                                 _P, _I32]
    lib.host_xxh32_stripes.argtypes = [_P, _I64, _P]
    lib.host_xxh64_stripes.argtypes = [_P, _I64, _P]
    return lib


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _host_codec(fn, data, lens, out_width, out_cap, out=None):
    n = data.shape[0]
    if out is None:
        out = torch.zeros((n, out_width), dtype=torch.uint8)
    out_lens = torch.zeros((n,), dtype=torch.int32)
    err = torch.zeros((n,), dtype=torch.int32)
    fn(_ptr(data), data.stride(0), _ptr(lens), _ptr(out), out.stride(0),
       out_cap, _ptr(out_lens), _ptr(err), n)
    return out, out_lens, err


def _assert_same(host, plain, all_lens=True, out_len=None):
    """Codes on every row, lengths (all rows or OK rows) and bytes of OK
    rows: ``[0, len)``, or ``[0, out_len)`` where the length is the bytes
    read (the fast decode)."""
    assert host[2].tolist() == plain[2].tolist()
    for i, (e, n, m) in enumerate(zip(host[2].tolist(), host[1].tolist(),
                                      plain[1].tolist())):
        if all_lens or e == codec.OK:
            assert n == m, i
        if e == codec.OK:
            w = n if out_len is None else out_len
            assert torch.equal(host[0][i, :w], plain[0][i, :w]), i


@pytest.fixture(scope="module")
def edge_batch():
    rng = np.random.default_rng(21)
    blocks = testing.mixed_blocks(rng, (0, 5, 12, 13, 1000, 65536, 70000))
    return blocks, layout.to_device_layout(blocks, device="cpu")


@pytest.mark.parametrize("dest_cap", [max_compressed_length(70000), 600])
def test_host_compress_matches_plain(lib, edge_batch, dest_cap):
    _, (src, lens) = edge_batch
    width = layout.row_stride(dest_cap)
    host = _host_codec(lib.host_compress, src, lens, width, dest_cap)
    plain = codec.compress_fast_batch(src, lens, dest_cap)
    _assert_same(host, plain)
    assert torch.equal(host[0], plain[0])   # writes past the lengths too
    if dest_cap == 600:
        assert codec.ERR_DEST_TOO_SMALL in host[2].tolist()


@pytest.mark.parametrize("out_max", [0, 1, 64, 1000, 70000])
def test_host_decode_matches_plain(lib, edge_batch, out_max):
    blocks, (src, lens) = edge_batch
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    batch = comp_blocks + testing.fuzz_blocks(
        np.random.default_rng(out_max), comp_blocks, 128)
    c, cl = layout.to_device_layout(batch, device="cpu")
    guard = torch.full((len(batch), out_max + 64), 0xA5, dtype=torch.uint8)
    host = _host_codec(lib.host_decode, c, cl, None, out_max, out=guard)
    plain = codec.decompress_safe_batch(c, cl, out_max)
    _assert_same(host, plain, all_lens=False)
    assert bool((guard[:, out_max:] == 0xA5).all())
    if out_max == 70000:
        assert host[2][:len(blocks)].tolist() == [codec.OK] * len(blocks)


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF])
def test_host_xxh32_matches_plain(lib, seed):
    rng = np.random.default_rng(seed & 0xFF)
    sizes = list(range(101)) + [1000, 65536]
    data, lens = layout.to_device_layout(
        [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes],
        device="cpu")
    out = torch.zeros((len(sizes),), dtype=torch.int32)
    lib.host_xxh32(_ptr(data), data.stride(0), _ptr(lens), seed, _ptr(out),
                   len(sizes))
    want = xxhash.xxh32_plain(data, lens, seed)
    assert out.view(torch.uint32).tolist() == want.tolist()


@pytest.mark.parametrize("dest_len", [0, 1, 64, 1000, 70000])
def test_host_decode_fast_matches_plain(lib, edge_batch, dest_len):
    """The fast variant of the decode body on the K2 output of the edge
    blocks and on fuzz, with a guard region behind every row."""
    _, (src, lens) = edge_batch
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    batch = comp_blocks + testing.fuzz_blocks(
        np.random.default_rng(dest_len + 1), comp_blocks, 128)
    c, cl = layout.to_device_layout(batch, device="cpu")
    guard = torch.full((len(batch), dest_len + 64), 0xA5, dtype=torch.uint8)
    host = _host_codec(lib.host_decode_fast, c, cl, None, dest_len, out=guard)
    plain = codec.decompress_fast_plain(c, cl, dest_len)
    _assert_same(host, plain, all_lens=False, out_len=dest_len)
    assert bool((guard[:, dest_len:] == 0xA5).all())
    ok_sizes = [i for i, n in enumerate(lens.tolist()) if n == dest_len]
    assert host[2][ok_sizes].tolist() == [codec.OK] * len(ok_sizes)
    assert host[1][ok_sizes].tolist() == comp_lens[ok_sizes].tolist()


@pytest.mark.parametrize("seed", [0, (1 << 64) - 1, 0xCAFEBABE12345678])
def test_host_xxh64_matches_plain(lib, seed):
    rng = np.random.default_rng(seed & 0xFF)
    sizes = list(range(101)) + [1000, 65536]
    data, lens = layout.to_device_layout(
        [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes],
        device="cpu")
    out = torch.zeros((len(sizes),), dtype=torch.int64)
    lib.host_xxh64(_ptr(data), data.stride(0), _ptr(lens), seed, _ptr(out),
                   len(sizes))
    assert torch.equal(out, xxhash.xxh64_plain(data, lens, seed))


def _comp_batch(seed, n_fuzz):
    """K2's plain output of the edge blocks and periods 1-15, the
    boundary blocks, then ``n_fuzz`` malformed variants."""
    rng = np.random.default_rng(seed)
    blocks = testing.mixed_blocks(rng, (0, 5, 13, 1000, 65536, 70000))
    blocks += [bytes(rng.integers(0, 256, p, dtype=np.uint8)) * (1024 // p)
               for p in range(1, 16)]
    src, lens = layout.to_device_layout(blocks, device="cpu")
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    comp_blocks += testing.boundary_blocks()
    comp_blocks += testing.fuzz_blocks(rng, comp_blocks, n_fuzz)
    return layout.to_device_layout(comp_blocks, device="cpu")


def _host_parse(lib, c, cl, max_seq):
    n = c.shape[0]
    tables = torch.zeros((6, n, max_seq), dtype=torch.int32)
    n_seq = torch.zeros((n,), dtype=torch.int32)
    total = torch.zeros((n,), dtype=torch.int32)
    lib.host_parse(_ptr(c), c.stride(0), _ptr(cl), max_seq, _ptr(tables),
                   _ptr(n_seq), _ptr(total), n)
    return tables, n_seq, total


@pytest.mark.parametrize("max_seq", [None, 40])
def test_host_parse_matches_plain(lib, max_seq):
    """The parser body on K2 output and fuzz, tables entry for entry, with
    the default width and one narrow enough to give ``-3``."""
    c, cl = _comp_batch(5, 256)
    want = sequences.parse_plain(c, cl, max_seq)
    got = _host_parse(lib, c, cl, want[0].shape[2])
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    codes = set(got[1].tolist())
    assert sequences.PARSE_MALFORMED in codes
    assert (sequences.PARSE_TOO_MANY in codes) == (max_seq == 40)


@pytest.mark.parametrize("out_max", [64, 1000, 70000])
def test_host_segment_matches_plain(lib, out_max):
    """K5's phases on parsed tables and on corrupted ones, against the plain
    version, with a guard region behind every row."""
    c, cl = _comp_batch(6, 64)
    tables, n_seq, _ = sequences.parse_plain(c, cl)
    bad = tables.clone()
    rows = torch.nonzero((n_seq > 1) & (cl < out_max)).flatten()[:6]
    for row, kind in zip(rows.tolist(), CORRUPTIONS):
        corrupt(bad, row, kind, int(cl[row]), out_max)
    guard = torch.full((c.shape[0], out_max + 64), 0xA5, dtype=torch.uint8)
    for t in (tables, bad):
        err = torch.zeros((c.shape[0],), dtype=torch.int32)
        guard[:, :out_max] = 0x5A
        lib.host_segment(_ptr(c), c.stride(0), _ptr(cl), _ptr(n_seq), _ptr(t),
                         t.shape[2], _ptr(guard), guard.stride(0), out_max,
                         _ptr(err), c.shape[0])
        out, want_err = segment_decode.decompress_segments_plain(
            c, cl, n_seq, t, out_max)
        assert torch.equal(err, want_err)
        assert torch.equal(guard[:, :out_max], out[:, :out_max])
        assert bool((guard[:, out_max:] == 0xA5).all())
    assert bool((want_err[rows] == codec.ERR_MALFORMED).all())


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, (1 << 64) - 1])
def test_host_stream_stripes_match_plain(lib, seed):
    """The stripe loops the streaming updates launch, from a carried state,
    against the plain absorbs."""
    rng = np.random.default_rng(seed & 0xFF)
    data = torch.from_numpy(rng.integers(0, 256, 32 * 77, dtype=np.uint8))
    s32 = xxhash_stream.StreamState32(seed, "cpu")
    s64 = xxhash_stream.StreamState64(seed, "cpu")
    lanes32 = s32.lanes.view(torch.int32).clone()
    lanes64 = s64.lanes.clone()
    for n in (1, 7, 8, 9, 77):
        lib.host_xxh32_stripes(_ptr(data), 2 * n, _ptr(lanes32))
        lib.host_xxh64_stripes(_ptr(data), n, _ptr(lanes64))
        xxhash_stream.absorb32_plain(s32.lanes, data[:32 * n])
        xxhash_stream.absorb64_plain(s64.lanes, data[:32 * n])
        assert lanes32.view(torch.uint32).tolist() == s32.lanes.tolist()
        assert torch.equal(lanes64, s64.lanes)


def test_build_digest_covers_every_header(tmp_path, monkeypatch):
    """Editing any ``csrc`` file, a ``.cuh`` header included, gives a new
    build directory, so a stale library is never loaded."""
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert {p.name for p in build.sources()} >= {
        "xxh64.cu", "lz4_decode.cu", "lz4_parse.cu", "segment_decode.cu"}
    digests = {build.source_digest()}
    headers = ("xxh64.cuh", "lz4_decode.cuh", "lz4tt_common.cuh",
               "lz4_parse.cuh", "segment_decode.cuh")
    for name in headers:
        with open(tmp_path / name, "a") as f:
            f.write("\n")
        digests.add(build.source_digest())
    assert len(digests) == len(headers) + 1
