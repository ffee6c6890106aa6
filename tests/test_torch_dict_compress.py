"""The dictionary compress's paths (``csrc/lz4_compress.cuh``,
``lz4tt_compress_dict_block``) on the CPU, built with g++: the table
seeded once for every row (what ``lz4_compress.cu``'s seed kernel and
each CTA's bulk copy do for a shared dictionary), by one thread and by a
team of host threads, and linked rows, each row's dictionary the content
that ends where it starts (a linked frame's blocks) or a copy of it
elsewhere. Each is held against the port's plain version
(``codec.compress_dict_plain``) and the native
``compress_block_with_dict`` of the JAX package, byte for byte and code
for code (tolerance 0), with shared and per-row dictionaries of
``testing.HIST_LENS`` bytes."""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.kernels import build, codec, layout

ni = pytest.importorskip("lz4_tpu.api.native_instances")

HARNESS = r"""
#include <pthread.h>

#include <vector>

#include "lz4_compress.cuh"

struct SeedShared {
  pthread_barrier_t bar;
};
// a team of host threads for the seed: only its loops and barriers
struct SeedTeam {
  SeedShared* sh;
  int id, n;
  int lane() const { return id; }
  int size() const { return n; }
  void sync() const { pthread_barrier_wait(&sh->bar); }
};
struct SeedArg {
  SeedShared* sh;
  int id, n;
  const uint8_t* dict_end;
  int dict_len;
  int32_t* t32;
};
static void* seed_lane(void* p) {
  const SeedArg* a = (const SeedArg*)p;
  lz4tt_dict_seed(SeedTeam{a->sh, a->id, a->n}, a->dict_end, a->dict_len,
                  a->t32);
  return nullptr;
}

extern "C" {

// The seeded table of the dict_len bytes that end at dict_end
// (int32[1 << 12]), by `lanes` host threads.
int host_dict_seed(const uint8_t* dict_end, int dict_len, int32_t* t32,
                   int lanes) {
  if (lanes == 1) {
    lz4tt_dict_seed(HostTeam(), dict_end, dict_len, t32);
    return 0;
  }
  SeedShared sh;
  pthread_barrier_init(&sh.bar, nullptr, lanes);
  std::vector<pthread_t> th(lanes);
  std::vector<SeedArg> args(lanes);
  for (int i = 0; i < lanes; i++) {
    args[i] = {&sh, i, lanes, dict_end, dict_len, t32};
    if (pthread_create(&th[i], nullptr, seed_lane, &args[i])) return 1;
  }
  for (int i = 0; i < lanes; i++) pthread_join(th[i], nullptr);
  pthread_barrier_destroy(&sh.bar);
  return 0;
}

// K2's body with a dictionary a row, as the card runs it: with `seed`
// (not null: every row's dictionary is the seed's), each row's table is a
// copy of it (the CTA's bulk copy) and the team does not seed; rows with
// no dictionary zero their own.
void host_compress_dict_rows(const uint8_t* src, long long src_stride,
                             const int32_t* src_lens, const uint8_t* dict_end,
                             long long dict_stride, const int32_t* dict_lens,
                             uint8_t* dst, long long dst_stride, int dest_cap,
                             int32_t* out_lens, int32_t* err, int n,
                             const int32_t* seed) {
  std::vector<uint32_t> table(LZ4TT_TABLE_BYTES / 4, 0x5A5A5A5Au);
  for (int b = 0; b < n; b++) {
    const bool seeded = seed != nullptr && dict_lens[b] > 0;
    if (seeded) memcpy(table.data(), seed, LZ4TT_TABLE_BYTES);
    lz4tt_compress_dict_block(HostTeam(), src + b * src_stride, src_lens[b],
                              dict_end + b * dict_stride, dict_lens[b],
                              dst + b * dst_stride, dest_cap, dst_stride,
                              table.data(), &out_lens[b], &err[b], seeded);
  }
}
}
"""

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("dict_compress")
    (out / "harness.cpp").write_text(HARNESS)
    res = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-Wall",
         "-Werror", "-Wno-unknown-pragmas", "-I", str(build.CSRC), "-o",
         str(out / "libdict.so"), str(out / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libdict.so"))
    lib.host_dict_seed.argtypes = [_P, _I32, _P, _I32]
    lib.host_dict_seed.restype = ctypes.c_int
    lib.host_compress_dict_rows.argtypes = [_P, _I64, _P, _P, _I64, _P, _P,
                                            _I64, _I32, _P, _P, _I32, _P]
    return lib


def _seed(lib, dictionary: bytes, lanes: int = 1) -> torch.Tensor:
    buf = torch.frombuffer(bytearray(dictionary or b"\0"), dtype=torch.uint8)
    t32 = torch.full((codec.SEED_WORDS,), -7, dtype=torch.int32)
    assert lib.host_dict_seed(buf.data_ptr() + len(dictionary),
                              len(dictionary), t32.data_ptr(), lanes) == 0
    return t32


def _host(lib, src, lens, dict_end, dict_stride, dict_lens, cap, seed=None):
    n = src.shape[0]
    dst = torch.zeros((n, layout.row_stride(cap)), dtype=torch.uint8)
    out_lens = torch.zeros((n,), dtype=torch.int32)
    err = torch.zeros((n,), dtype=torch.int32)
    lib.host_compress_dict_rows(
        src.data_ptr(), src.stride(0), lens.data_ptr(), dict_end, dict_stride,
        dict_lens.data_ptr(), dst.data_ptr(), dst.stride(0), cap,
        out_lens.data_ptr(), err.data_ptr(), n,
        seed.data_ptr() if seed is not None else None)
    return dst, out_lens, err


def _assert_equal(host, plain, natives=None):
    """Codes, lengths and bytes equal the plain version's, and on OK rows
    the native compressor's."""
    assert host[2].tolist() == plain[2].tolist()
    assert host[1].tolist() == plain[1].tolist()
    assert torch.equal(host[0], plain[0])
    for i, want in enumerate(natives or []):
        if int(host[2][i]) == codec.OK:
            assert host[0][i, :int(host[1][i])].numpy().tobytes() == want, i


def _blocks(rng, d: bytes, sizes) -> list[bytes]:
    out = []
    for size in sizes:
        for kind in testing.KINDS:
            b = testing.block_of(rng, kind, size)
            out.append((d[-3000:] + b)[:size] if kind == "alphabet4" else b)
    return out


def test_seed_is_the_same_on_a_team(lib):
    """The seeded table is the same by one thread and by 8 or 32 host
    threads (the largest position of a bucket wins by atomics), at every
    dictionary length of ``testing.HIST_LENS``."""
    rng = np.random.default_rng(170)
    for hl in testing.HIST_LENS:
        d = testing.block_of(rng, "text", hl)
        one = _seed(lib, d)
        assert torch.equal(one, _seed(lib, d, 8))
        assert torch.equal(one, _seed(lib, d, 32))
        assert bool((one == 0).all()) == (hl < 7)   # position 0 seeds 0


@pytest.mark.parametrize("hl", testing.HIST_LENS)
@pytest.mark.parametrize("cap_kind", ["full", "tight"])
def test_shared_dictionary_seeded_once(lib, hl, cap_kind):
    """Every row against one shared dictionary (stride 0), each row's table
    a copy of one seed: equal to the plain version and the native
    ``compress_block_with_dict``, and to the team seeding its own table;
    rows with no dictionary among them take K2's path."""
    rng = np.random.default_rng(171 + hl)
    d = testing.block_of(rng, "text", hl)
    blocks = _blocks(rng, d, (0, 5, 13, 1000, 65536, 70000))
    src, lens = layout.to_device_layout(blocks, device="cpu")
    n = len(blocks)
    win = torch.frombuffer(bytearray(d or b"\0"), dtype=torch.uint8).view(1, -1)
    dl = torch.full((n,), hl, dtype=torch.int32)
    dl[::7] = 0
    cap = max_compressed_length(70000) if cap_kind == "full" else 600
    plain = codec.compress_dict_plain(src, lens, cap, win, dl)
    end = win.data_ptr() + win.shape[1] if hl else win.data_ptr()
    seeded = _host(lib, src, lens, end, 0, dl, cap, _seed(lib, d))
    own = _host(lib, src, lens, end, 0, dl, cap)
    natives = [ni.compress_block_with_dict(b, d if int(dl[i]) else b"")
               for i, b in enumerate(blocks)] if cap_kind == "full" else None
    _assert_equal(seeded, plain, natives)
    _assert_equal(own, plain)


@pytest.mark.parametrize("bs", [4096, 65536])
def test_linked_rows_through_one_pointer(lib, bs):
    """Each row's dictionary the content just before it, up to 64 KiB (a
    linked frame's blocks: ``testing.linked_blocks``' strided view, so
    every dictionary ends where its row starts, one buffer for rows and
    dictionaries): equal to the plain version and the native compressor
    row by row, exactly; the same rows against copies of those
    dictionaries elsewhere give the same bytes."""
    rng = np.random.default_rng(172)
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(8, 64, 40)]
    content = b"".join(words[int(i)] + bytes([int(i)])
                       for i in rng.integers(0, 40, 6 * bs // 20))
    content = (content + testing.block_of(rng, "alphabet4", 3 * bs))[:8 * bs - 77]
    n = -(-len(content) // bs)
    win = codec.WINDOW
    buf = torch.zeros((win + n * bs,), dtype=torch.uint8)
    buf[win:win + len(content)] = torch.frombuffer(bytearray(content),
                                                   dtype=torch.uint8)
    src = buf[win:].view(n, bs)
    dicts = buf.as_strided((n, win), (bs, 1))
    starts = [i * bs for i in range(n)]
    lens = torch.tensor([min(bs, len(content) - s) for s in starts],
                        dtype=torch.int32)
    dl = torch.tensor([min(s, win) for s in starts], dtype=torch.int32)
    cap = max_compressed_length(bs)
    plain = codec.compress_dict_plain(src, lens, cap, dicts, dl)
    view = _host(lib, src, lens, dicts.data_ptr() + win, bs, dl, cap)
    natives = [ni.compress_block_with_dict(content[s:s + bs],
                                           content[max(0, s - win):s])
               for s in starts]
    _assert_equal(view, plain, natives)
    copies = dicts.contiguous()
    two = _host(lib, src, lens, copies.data_ptr() + win, win, dl, cap)
    _assert_equal(two, plain)
    assert sum(view[1].tolist()) < len(content) // 2
