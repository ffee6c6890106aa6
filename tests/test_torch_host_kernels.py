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
from lz4_tpu_torch.kernels import build, codec, layout, xxhash

HARNESS = r"""
#include "lz4_compress.cuh"
#include "lz4_decode.cuh"
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


def test_build_digest_covers_every_header(tmp_path, monkeypatch):
    """Editing any ``csrc`` file, a ``.cuh`` header included, gives a new
    build directory, so a stale library is never loaded."""
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert {p.name for p in build.sources()} >= {"xxh64.cu", "lz4_decode.cu"}
    digests = {build.source_digest()}
    for name in ("xxh64.cuh", "lz4_decode.cuh", "lz4tt_common.cuh"):
        with open(tmp_path / name, "a") as f:
            f.write("\n")
        digests.add(build.source_digest())
    assert len(digests) == 4
