"""The chunked linked walk (``csrc/linked_decode.cuh``: exit tables, hops,
each chunk's walk from its entry, the finish) on the CPU: its bodies built
with g++ and run as the card's four kernels run them, the tables by one
host thread or by a team of host threads in lock step (a warp's ballots
and shuffles, so that the pointer jumping inside a step runs), against
the plain walk (``walk_linked_plain``). Chunk sizes down to 16 bytes put
the seams inside tokens, offsets and runs of 0xFF length bytes. Every
comparison is exact (tolerance 0): each record field, ``n_seq``,
``out_total``, ``code`` and ``reach``. Linked frames whose blocks hold
such runs are decoded through the port on the CPU (the plain walk there)
and held against the JAX package's reader."""

import ctypes
import io
import shutil
import subprocess

import numpy as np
import pytest
import torch

from lz4_tpu.formats import frame as jframe
from lz4_tpu_torch import testing
from lz4_tpu_torch.kernels import build, codec, layout, linked_decode as ld
from lz4_tpu_torch.streams.pipeline import decode_frames
from test_torch_linked_decode import _walk_blocks

CPU = "cpu"
BS = 1 << 16

HARNESS = r"""
#include <pthread.h>

#include <vector>

#include "linked_decode.cuh"

// A warp of host threads in lock step: a barrier a collective.
struct LaneShared {
  pthread_barrier_t bar;
  int32_t slot[32];
};
struct LaneTeam {
  LaneShared* sh;
  int id, n;
  int lane() const { return id; }
  int size() const { return n; }
  bool leader() const { return id == 0; }
  void sync() const { pthread_barrier_wait(&sh->bar); }
  unsigned ballot(bool p) const {
    sh->slot[id] = p;
    sync();
    unsigned m = 0;
    for (int i = 0; i < n; i++) m |= sh->slot[i] ? 1u << i : 0u;
    sync();
    return m;
  }
  int32_t shfl(int32_t v, int src) const {
    sh->slot[id] = v;
    sync();
    const int32_t r = sh->slot[src];
    sync();
    return r;
  }
};

struct Batch {
  const uint8_t* comp;
  long long stride;
  const int32_t* lens;
  const int32_t* layout;
  int n, chunk, n_tab;
  int32_t* tab;
  Lz4ttLwScratch sc;  // the team's, as in shared memory
  LaneShared* sh;
};

static int32_t block_of(const int32_t* base, int n, int32_t g) {
  int32_t b = 0;
  while (b + 1 < n && base[b + 1] <= g) b++;
  return b;
}

// every table chunk, by one team
template <class Team>
static void tables_all(const Batch& j, const Team& t) {
  const int32_t* tbase = j.layout + j.n + 1;
  for (int32_t g = 0; g < j.n_tab; g++) {
    const int32_t b = block_of(tbase, j.n, g), c = g - tbase[b];
    int32_t* tb = j.tab + (int64_t)g * 3 * j.chunk;
    lz4tt_lw_tables(t, j.comp + b * j.stride, j.lens[b], c * j.chunk,
                    (c + 1) * j.chunk, tb, j.sc);
  }
}

struct LaneArg {
  const Batch* j;
  int id, n;
};
static void* lane_main(void* arg) {
  const LaneArg* a = (const LaneArg*)arg;
  tables_all(*a->j, LaneTeam{a->j->sh, a->id, a->n});
  return nullptr;
}

extern "C" {

// The chunked walk as lz4tt_linked_walk's four kernels run it: the tables
// (one thread, or `lanes` host threads as a warp; with a ring of the last
// tables when `ringed`, as the card's tables_kernel, without as the
// look-back variant of design_variants.py), the hops a block, each chunk's walk (from the last
// chunk to the first, as any order must do), the finish a block. res: int32[4][n] of n_seq, out_total,
// code, reach; scratch: int32[n_tab * 3 * chunk + 5 * n_chunks], poisoned
// by the caller.
int host_chunked_walk(const uint8_t* comp, long long stride,
                      const int32_t* lens, const uint8_t* raw, int n,
                      int dest_cap, int32_t* tables, int max_seq,
                      int32_t* res, const int32_t* layout, int n_chunks,
                      int n_tab, int chunk, int lanes, int ringed,
                      int32_t* scratch) {
  LaneShared sh;
  std::vector<uint16_t> ff(chunk);
  std::vector<uint8_t> stage(chunk + LZ4TT_LW_MARGIN, 0xA5);
  std::vector<int32_t> ring(3 * LZ4TT_LW_RING, 0x5A5A5A5A);
  const Lz4ttLwScratch sc = {ff.data(), stage.data(),
                             ringed ? ring.data() : nullptr};
  const Batch j = {comp, stride, lens, layout, n, chunk, n_tab, scratch, sc,
                   &sh};
  if (lanes == 1) {
    tables_all(j, HostTeam());
  } else {
    pthread_barrier_init(&sh.bar, nullptr, lanes);
    std::vector<pthread_t> th(lanes);
    std::vector<LaneArg> args(lanes);
    for (int i = 0; i < lanes; i++) {
      args[i] = {&j, i, lanes};
      if (pthread_create(&th[i], nullptr, lane_main, &args[i])) return 1;
    }
    for (int i = 0; i < lanes; i++) pthread_join(th[i], nullptr);
    pthread_barrier_destroy(&sh.bar);
  }
  int32_t* s = scratch + (int64_t)n_tab * 3 * chunk;
  int32_t *ent = s, *n0 = s + n_chunks, *d0 = s + 2 * n_chunks,
          *code = s + 3 * n_chunks, *reach = s + 4 * n_chunks;
  const int64_t plane = (int64_t)n * max_seq;
  for (int b = 0; b < n; b++) {
    const int32_t cb = layout[b], nc = layout[b + 1] - cb;
    lz4tt_lw_hops(nc, chunk, scratch + (int64_t)layout[n + 1 + b] * 3 * chunk,
                  ent + cb, n0 + cb, d0 + cb);
  }
  for (int32_t g = n_chunks - 1; g >= 0; g--) {
    const int32_t b = block_of(layout, n, g), c = g - layout[b];
    int32_t* row = tables + (int64_t)b * max_seq;
    const Lz4ttLwTables t = {row, row + plane, row + 2 * plane,
                             row + 3 * plane, row + 4 * plane,
                             row + 5 * plane};
    const Lz4ttLwResult r = lz4tt_lw_chunk(
        comp + b * stride, lens[b], dest_cap, raw[b] != 0, t, max_seq, c,
        layout[b + 1] - layout[b], chunk, ent[g], n0[g], d0[g]);
    code[g] = r.code;
    n0[g] = r.n_seq;
    d0[g] = r.out_total;
    reach[g] = r.reach;
  }
  for (int b = 0; b < n; b++) {
    const int32_t cb = layout[b];
    const Lz4ttLwResult r = lz4tt_lw_finish(layout[b + 1] - cb, code + cb,
                                            n0 + cb, d0 + cb, reach + cb);
    res[b] = r.n_seq;
    res[n + b] = r.out_total;
    res[2 * n + b] = r.code;
    res[3 * n + b] = r.reach;
  }
  return 0;
}

// The exit table of one chunk [c0, c0 + chunk) of one block, by one thread.
void host_chunk_tables(const uint8_t* comp, int src_end, int c0, int chunk,
                       int32_t* tab) {
  std::vector<uint16_t> ff(chunk);
  std::vector<uint8_t> stage(chunk + LZ4TT_LW_MARGIN);
  std::vector<int32_t> ring(3 * LZ4TT_LW_RING);
  lz4tt_lw_tables(HostTeam(), comp, src_end, c0, c0 + chunk, tab,
                  {ff.data(), stage.data(), ring.data()});
}
}
"""

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
POISON = 0x5A5A5A5A


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("linked_chunks")
    (out / "harness.cpp").write_text(HARNESS)
    res = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-Wall",
         "-Werror", "-Wno-unknown-pragmas", "-I", str(build.CSRC), "-o",
         str(out / "libchunks.so"), str(out / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libchunks.so"))
    lib.host_chunked_walk.argtypes = [_P, _I64, _P, _P, _I32, _I32, _P, _I32,
                                      _P, _P, _I32, _I32, _I32, _I32, _I32,
                                      _P]
    lib.host_chunked_walk.restype = ctypes.c_int
    lib.host_chunk_tables.argtypes = [_P, _I32, _I32, _I32, _P]
    return lib


def chunked_walk(lib, comp, lens, raw, dest_cap, max_seq=None, chunk=64,
                 lanes=1, whole_below=0, ringed=True):
    """The chunked walk's bodies on a CPU batch: (tables, n_seq, out_total,
    code, reach) as ``walk_linked`` returns them, and the layout."""
    n = comp.shape[0]
    host = (lens.tolist(), raw.tolist())
    width = max_seq or ld.table_width(*host)
    lay, n_chunks, n_tab = ld.chunk_layout(*host, dest_cap, chunk,
                                           whole_below)
    tables = torch.zeros((6, n, width), dtype=torch.int32)
    res = torch.zeros((4, n), dtype=torch.int32)
    scratch = torch.full((n_tab * 3 * chunk + 5 * n_chunks,), POISON,
                         dtype=torch.int32)
    flags = raw.to(torch.uint8)
    lay_t = torch.from_numpy(lay)
    assert lib.host_chunked_walk(
        comp.data_ptr(), comp.stride(0), lens.data_ptr(), flags.data_ptr(),
        n, dest_cap, tables.data_ptr(), width, res.data_ptr(),
        lay_t.data_ptr(), n_chunks, n_tab, chunk, lanes, int(ringed),
        scratch.data_ptr()) == 0
    return (tables, *res), lay


def assert_walks_equal(got, want):
    """n_seq, out_total, code, reach, and each row's records: exact."""
    for x, y in zip(got[1:], want[1:]):
        assert x.tolist() == y.tolist()
    for i, k in enumerate(want[1].tolist()):
        assert torch.equal(got[0][:, i, :k], want[0][:, i, :k]), i


def _batch(blocks, raw=None):
    comp, lens = layout.to_device_layout(blocks, device=CPU)
    flags = torch.zeros(len(blocks), dtype=torch.bool) if raw is None \
        else torch.tensor(raw, dtype=torch.bool)
    return comp, lens, flags


def _lit_block(rng, lit: int, tail: int = 9, ml: int = 4) -> bytes:
    """One sequence of ``lit`` literals and a match, then the last
    ``tail`` literals: a literal run whose length bytes are 0xFF runs."""
    return testing.encode_block([(rng.integers(0, 256, lit, dtype=np.uint8)
                                  .tobytes(), 1, ml)],
                                rng.integers(0, 256, tail, dtype=np.uint8)
                                .tobytes())


def _run_blocks(rng) -> list[bytes]:
    """Literal runs over many chunks, 0xFF runs longer than a chunk (both
    lengths), the last literals in a late chunk, long matches, many short
    sequences before and after each."""
    a4 = testing.block_of(rng, "alphabet4", 3000)
    short = testing.linked_blocks(a4, 3000, CPU)[0][:-40]
    out = [_lit_block(rng, 5000), _lit_block(rng, 300_000),
           _lit_block(rng, 14), _lit_block(rng, 15), _lit_block(rng, 270),
           _lit_block(rng, 10, ml=200_000), _lit_block(rng, 3, ml=19),
           testing.encode_block([(b"", 1, 70_000), (b"xy", 2, 70_000)],
                                b"t" * 400),
           testing.encode_block([(b"ab", 2, 9)] * 300, b"q" * 3000),
           testing.encode_block([(rng.integers(0, 256, 40, dtype=np.uint8)
                                  .tobytes(), 40, 4)] * 200, b"end.." * 3)]
    # a linked block's sequences, then a literal run of 40,000 and more
    seqs = [(b"", 1, 10)] * 50 + [(bytes(40_000), 3, 300)] + [(b"z", 1, 5)] * 40
    out.append(testing.encode_block(seqs, b"tail tail"))
    out.append(short)
    return out


def _error_blocks(rng) -> list[bytes]:
    """Every way the walk stops on a bad block, late in the block: a token
    at the end, a literal run past the end or short of it, a cut offset,
    a match past dest_cap (at the caps used), and fuzz."""
    good = testing.encode_block([(b"ab", 2, 9)] * 400, b"q" * 20)
    body = good[:-21]
    return [body,                                   # ends at a token start
            body + bytes([0xF0]) + b"\xff" * 300,    # literal run past the end
            body + bytes([0x50]) + b"abc" + b"\x01\x00" + b"x" * 20,
            body + bytes([0x1F, ord("a"), 0x01]),    # offset cut
            body + bytes([0x0F, 0x01, 0x00]) + b"\xff" * 500,   # ml to the end
            body + bytes([0x0F, 0x01, 0x00]) + b"\xff" * 300 + b"\x07"
            + bytes([0x50]) + b"tail.",
            *testing.fuzz_blocks(rng, [good, _lit_block(rng, 2000)], 40)]


@pytest.fixture(scope="module")
def blocks():
    rng = np.random.default_rng(160)
    return _walk_blocks(rng) + _run_blocks(rng) + _error_blocks(rng)


@pytest.mark.parametrize("chunk, ringed", [
    (16, True), (17, True), (32, False), (64, True), (333, True),
    (333, False), (4096, True)])
@pytest.mark.parametrize("dest_cap, max_seq", [
    (BS, None), (400_000, None), (100, None), (17, None), (0, None),
    (BS, 1), (BS, 5), (400_000, 300)])
def test_chunked_walk_matches_plain(lib, blocks, chunk, ringed, dest_cap,
                                    max_seq):
    """The chunked walk (one host thread for the tables, with a ring of
    the last tables as the card's tables kernel, or without as its
    look-back kernel) against the plain walk,
    exact, on K2's edge blocks, boundary, chain, history, overreach,
    short-sequence and fuzzed blocks, literal runs over many chunks, 0xFF
    runs longer than a chunk, the last literals in a late chunk and every
    error kind (``TOO_MANY`` at table widths 1, 5 and 300, ``dest_cap`` 0
    and 17, one block in ten stored raw), at chunk sizes from 16 bytes."""
    rng = np.random.default_rng(161)
    raw = list(rng.random(len(blocks)) < 0.1)
    comp, lens, flags = _batch(blocks, raw)
    width = max_seq or ld.table_width(lens.tolist(), raw)
    want = ld.walk_linked_plain(comp, lens, flags, dest_cap, width)
    got, lay = chunked_walk(lib, comp, lens, flags, dest_cap, width, chunk,
                            ringed=ringed)
    assert_walks_equal(got, want)
    if dest_cap and chunk < 4096:
        assert int(lay[1, -1]) > len(blocks)       # many blocks were cut
    codes = set(want[3].tolist())
    if dest_cap == BS and max_seq is None:
        assert {codec.OK, codec.ERR_MALFORMED,
                codec.ERR_DEST_TOO_SMALL} <= codes
    if max_seq in (1, 5):
        assert ld.TOO_MANY in codes


@pytest.mark.parametrize("lanes, chunk, ringed", [
    (4, 16, True), (4, 100, False), (32, 40, True), (32, 256, True),
    (32, 600, True)])
def test_chunked_walk_on_a_team(lib, blocks, lanes, chunk, ringed):
    """The tables pass by a team of host threads (``lanes`` offsets a step,
    tokens that end inside a step resolved by pointer jumping over the
    team's shuffles; the ring of the last 256 offsets' tables wrapping
    inside a chunk), the rest as on the card: exact against the plain
    walk."""
    pick = blocks[::15] + _run_blocks(np.random.default_rng(162))[::2]
    comp, lens, flags = _batch(pick)
    want = ld.walk_linked_plain(comp, lens, flags, 400_000)
    got, _ = chunked_walk(lib, comp, lens, flags, 400_000, None, chunk, lanes,
                          ringed=ringed)
    assert_walks_equal(got, want)


def test_exit_table_is_the_path(lib):
    """Each offset's exit, count and output in a chunk's table are those of
    the token path from that offset (parsed here in Python), or a stop."""
    rng = np.random.default_rng(163)
    data = testing.block_of(rng, "alphabet4", 20_000)
    comp = testing.linked_blocks(data, 20_000, CPU)[0] + bytes(64)
    src_end = len(comp)
    c0, chunk = 1000, 64
    buf = torch.frombuffer(bytearray(comp), dtype=torch.uint8)
    tab = torch.zeros((3 * chunk,), dtype=torch.int32)
    lib.host_chunk_tables(buf.data_ptr(), src_end, c0, chunk, tab.data_ptr())

    def path(i):
        n = out = 0
        while i < c0 + chunk:
            token, s = comp[i], i + 1
            lit = token >> 4
            if lit == 15:
                while True:
                    b = comp[s] if s < src_end else 255
                    s += 1
                    lit += b
                    if b != 255 or s > src_end:
                        break
                s = min(s, src_end)
            if s + lit > src_end - 8:
                return -1, None, None
            s += lit + 2
            ml = token & 15
            if ml == 15:
                while True:
                    b = comp[s] if s < src_end else 255
                    s += 1
                    ml += b
                    if b != 255 or s > src_end:
                        break
                s = min(s, src_end)
            n, out, i = n + 1, out + lit + ml + 4, s
        return i, n, out

    for j in range(chunk):
        e, n, out = path(c0 + j)
        assert int(tab[3 * j]) == e, j
        if e != -1:
            assert (int(tab[3 * j + 1]), int(tab[3 * j + 2])) == (n, out)


def test_chunk_layout():
    """Raw blocks, blocks no longer than the chunk or ``whole_below`` and
    every block at ``dest_cap`` 0 are one chunk; the rest ``ceil(len /
    chunk)``, all but the last with tables."""
    lay, n_chunks, n_tab = ld.chunk_layout([0, 100, 101, 1000, 5000],
                                           [0, 0, 0, 1, 0], 70_000, 100, 0)
    assert lay.tolist() == [[0, 1, 2, 4, 5, 55], [0, 0, 0, 1, 1, 50]]
    assert (n_chunks, n_tab) == (55, 50)
    assert ld.chunk_layout([5000], [0], 70_000, 100, 6000)[1:] == (1, 0)
    assert ld.chunk_layout([5000], [0], 0, 100, 0)[1:] == (1, 0)
    # by default blocks of up to 64 KiB are one chunk, longer ones are cut
    assert ld.chunk_layout([65536, 65537], [0, 0], 1 << 22)[1:] == (18, 16)


def _frame_outcome(frame, fn):
    out = io.BytesIO()
    try:
        fn(frame, out)
    except Exception as e:      # noqa: BLE001 - compared between readers
        return out.getvalue(), type(e).__name__
    return out.getvalue(), None


def _jax_read(frame, out):
    reader = jframe.Lz4FrameInputStream(io.BytesIO(frame),
                                        allow_dependent_blocks=True)
    while chunk := reader.read(1 << 20):
        out.write(chunk)


def _port_read(frame, out):
    decode_frames(io.BytesIO(frame), out, "cuda", 3, CPU,
                  allow_dependent=True)


@pytest.mark.parametrize("case", ["literal_runs", "long_matches", "fault"])
def test_frames_with_long_runs(case):
    """Linked frames of 1 MiB blocks with long literal and 0xFF runs
    (``testing.long_run_frame``) decoded through the port on the CPU,
    where the walk is the plain one (``walk_linked_plain``; the card's
    chunked walk decodes the same frames in ``test_torch_card.py``):
    bytes written and error equal the JAX package's reader, exactly."""
    frame = testing.long_run_frame(case)
    want = _frame_outcome(frame, _jax_read)
    assert _frame_outcome(frame, _port_read) == want
    assert (want[1] is None) == (case != "fault")
