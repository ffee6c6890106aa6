"""The batched decode of linked-block frames (``kernels/linked_decode.py``)
on the CPU: the g++ build of its kernels' bodies (``csrc/linked_decode.cuh``)
against the plain versions, the walk's codes against K1 with a history,
and whole frames through ``decode_frames`` (the plain versions) against
the port's serial reader (``Lz4FrameInputStream``, K1 with a history a
block) and the JAX package's reader, byte for byte and error for error,
the bytes written before an error included."""

import ctypes
import io
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

import design_variants
from lz4_tpu.formats import frame as jframe
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.formats import frame as frame_mod
from lz4_tpu_torch.kernels import build, codec, layout, linked_decode as ld
from lz4_tpu_torch.streams.pipeline import decode_frames
from test_torch_dependent_frames import (
    _upstream_dict_frame, _upstream_linked_frame, needs_liblz4)

ni = pytest.importorskip("lz4_tpu.api.native_instances")

CPU = "cpu"
BS = 1 << 16

HARNESS = r"""
#include <pthread.h>

#include <vector>

#include "linked_decode.cuh"

// A team of host threads for lz4tt_rs_segment: a barrier a sync, atomics
// for the shared and device memory ors and adds.
struct RsShared {
  pthread_barrier_t bar;
};
struct RsTeam {
  RsShared* sh;
  int id, n;
  int rank() const { return id; }
  int size() const { return n; }
  void sync() const { pthread_barrier_wait(&sh->bar); }
  int32_t add(int32_t* p, int32_t v) const {
    return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
  }
  void add_all(int32_t* p, int32_t v) const { add(p, v); }
  void or_global(uint32_t* p, uint32_t v) const {
    __atomic_fetch_or(p, v, __ATOMIC_SEQ_CST);
  }
  // the bitmaps start zeroed here, so a bit is or'ed in
  void put_bit(uint32_t* words, int32_t j, bool on, bool) const {
    if (on) or_global(words + (j >> 5), 1u << (j & 31));
  }
  void or_shared(uint32_t* p, uint32_t v) const { or_global(p, v); }
};
struct RsJob {
  const Lz4ttRsBatch* bt;
  const Lz4ttRsMaps* m;
  int32_t s0, seg;
  Lz4ttRsShared sh;
  RsShared* team;
  int lanes;
};
struct RsLane {
  RsJob* job;
  int id;
};
static void* rs_lane(void* arg) {
  RsLane* l = (RsLane*)arg;
  RsJob* j = l->job;
  lz4tt_rs_segment(RsTeam{j->team, l->id, j->lanes}, *j->bt, *j->m, j->s0,
                   j->seg, j->sh);
  return nullptr;
}

// The same team as lz4tt_rs_rounds' grid.
struct RsGrid : RsTeam {
  bool leader() const { return id == 0; }
};
struct RoundsJob {
  const Lz4ttRsMaps* m;
  int32_t len, own, turn, left;
  int32_t *tally, *rounds;  // rounds: each lane's
  RsShared* team;
  int lanes;
};
struct RoundsLane {
  RoundsJob* job;
  int id;
};
static void* rounds_lane(void* arg) {
  RoundsLane* l = (RoundsLane*)arg;
  RoundsJob* j = l->job;
  int32_t turn = j->turn, rounds = 0;
  const int32_t left =
      lz4tt_rs_rounds(RsGrid{{j->team, l->id, j->lanes}}, *j->m, j->len,
                      j->own, j->tally, turn, rounds);
  j->rounds[l->id] = rounds;
  if (l->id == 0) {  // the same on every lane
    j->turn = turn;
    j->left = left;
  }
  return nullptr;
}

// Runs fn(lane) on `lanes` host threads, joined.
template <class Lane, class Job>
static void run_lanes(Job* job, int lanes, void* (*fn)(void*)) {
  std::vector<pthread_t> th(lanes);
  std::vector<Lane> ls(lanes);
  for (int k = 0; k < lanes; k++) {
    ls[k] = {job, k};
    pthread_create(&th[k], nullptr, fn, &ls[k]);
  }
  for (int k = 0; k < lanes; k++) pthread_join(th[k], nullptr);
}

extern "C" {

// every block walked (lz4tt_lw_walk); res: int32[4][n] of n_seq,
// out_total, code, reach
void host_linked_walk(const uint8_t* comp, long long stride,
                      const int32_t* lens, const uint8_t* raw, int n,
                      int dest_cap, int32_t* tables, int max_seq,
                      int32_t* res) {
  const int64_t plane = (int64_t)n * max_seq;
  for (int b = 0; b < n; b++) {
    int32_t* row = tables + (int64_t)b * max_seq;
    const Lz4ttLwTables t = {row, row + plane, row + 2 * plane,
                             row + 3 * plane, row + 4 * plane,
                             row + 5 * plane};
    const Lz4ttLwResult r = lz4tt_lw_walk(comp + b * stride, lens[b],
                                          dest_cap, raw[b] != 0, t, max_seq);
    res[b] = r.n_seq;
    res[n + b] = r.out_total;
    res[2 * n + b] = r.code;
    res[3 * n + b] = r.reach;
  }
}

// The resolve as its five kernels run it (lz4tt_linked_resolve): each
// segment of seg nodes by a team of `lanes` host threads (tiles of 2 lanes
// nodes), in ascending or (reverse) descending order; the open exits,
// their ranks as count_kernel and init_kernel make them; the list in
// chunks of list_cap, each chunk's entries and positions, its rounds by
// lz4tt_rs_rounds on `lanes` host threads (own: each thread's own rounds
// before the grid's; -1, the kernel's), then its bytes; then every other
// open node's byte. plant >= 0: a fault planted in the first chunk, entry
// `plant` pointing at itself. open, exits, word_base: uint32 or
// int32[ceil(n_nodes / 32)], exits zeroed; off: uint16[n_nodes]; list:
// int32[2 * list_cap] (the entries, then their positions); counters:
// int32[4], zeroed.
void host_linked_resolve(const uint8_t* comp, long long stride,
                         int32_t* tables, int max_seq, int n,
                         const int32_t* n_seq, const int64_t* block_at,
                         int n_ok, const uint8_t* window, int w, int n_nodes,
                         int seg, int lanes, int reverse, long long list_cap,
                         int own, int plant, uint8_t* out, uint16_t* off,
                         uint32_t* open, uint32_t* exits, int32_t* word_base,
                         int32_t* list, int32_t* counters) {
  const Lz4ttRsBatch bt = {comp, stride, tables, max_seq, n, n_seq,
                           block_at, n_ok, window, w, n_nodes};
  const Lz4ttRsMaps m = {out, off, open, exits, word_base, list,
                         list + list_cap};
  const int n_segs = (n_nodes + seg - 1) / seg;
  std::vector<int32_t> nodes(seg), more(lanes + 4);
  std::vector<uint32_t> ex(LZ4TT_RS_EXIT_WORDS);
  RsShared team;
  pthread_barrier_init(&team.bar, nullptr, lanes);
  for (int i = 0; i < n_segs; i++) {
    const int g = reverse ? n_segs - 1 - i : i;
    RsJob job = {&bt, &m, g * seg, seg,
                 {nodes.data(), ex.data(), more.data(), more.data() + lanes},
                 &team, lanes};
    run_lanes<RsLane>(&job, lanes, rs_lane);
    counters[0] += job.sh.cnt[2];
  }
  const int words = (n_nodes + 31) / 32;
  int32_t all = 0;
  for (int k = 0; k < words; k++) {
    exits[k] &= open[k];
    word_base[k] = all;
    all += lz4tt_popc(exits[k]);
  }
  counters[1] = all;
  int32_t tally[3] = {0, 0, 0}, turn = 0;
  std::vector<int32_t> rounds(lanes);
  for (int32_t base = 0; base < all; base += (int32_t)list_cap) {
    const int32_t len =
        all - base < list_cap ? all - base : (int32_t)list_cap;
    for (int k = 0; k < words; k++)  // init_kernel's, or the chunk's scan
      for (uint32_t b = lz4tt_rs_in_chunk(m, k, base, len); b; b &= b - 1) {
        const int32_t q = k * 32 + lz4tt_ffs(b) - 1;
        list[lz4tt_rs_rank(m, q) - base] =
            lz4tt_rs_entry(m, lz4tt_rs_exit(m, q, seg), base);
        m.pos[lz4tt_rs_rank(m, q) - base] = q;
      }
    if (base == 0 && plant >= 0 && plant < len) list[plant] = plant;
    RoundsJob job = {&m, len,
                     own < 0 ? lz4tt_rs_rounds_for(len) : own, turn, 0,
                     tally, rounds.data(), &team, lanes};
    run_lanes<RoundsLane>(&job, lanes, rounds_lane);
    turn = job.turn;
    for (int32_t r : rounds)
      if (r > counters[2]) counters[2] = r;
    counters[3] += job.left;
    for (int i = 0; i < len; i++) out[m.pos[i]] = (uint8_t)list[i];
  }
  pthread_barrier_destroy(&team.bar);
  for (int j = 0; j < n_nodes; j++)
    if (off[j] && !lz4tt_rs_listed(m, j))
      out[j] = out[lz4tt_rs_exit(m, j, seg)];
}

// The resolve's first design as its kernels run it, one thread: the fill (a
// record longer than LZ4TT_LR_LONG nodes in `step` interleaved parts, as a
// CTA's threads take it), then rounds in place over [0, n_nodes),
// ascending or (reverse) descending; the latter reads every parent before
// this round writes it, so its counts are the synchronous rounds'. open:
// int32[rounds].
void host_linked_resolve_first(const uint8_t* comp, long long stride,
                         int32_t* tables, int max_seq, int n,
                         const int32_t* n_seq, const int64_t* block_at,
                         long long n_ok, const uint8_t* window, int w,
                         long long n_nodes, int32_t* nodes, uint8_t* out,
                         int32_t* open, int rounds, int step, int reverse) {
  for (int j = 0; j < w; j++) nodes[j] = lz4tt_lr_known(window[j]);
  const int64_t plane = (int64_t)n * max_seq;
  for (int b = 0; b < n_ok; b++) {
    int32_t* row = tables + (int64_t)b * max_seq;
    const Lz4ttLwTables t = {row, row + plane, row + 2 * plane,
                             row + 3 * plane, row + 4 * plane,
                             row + 5 * plane};
    for (int k = 0; k < n_seq[b]; k++) {
      if (lz4tt_lr_long(t, k)) {
        for (int from = 0; from < step; from++)
          lz4tt_lr_fill(comp + b * stride, t, k, nodes, w + block_at[b],
                        from, step);
      } else {
        lz4tt_lr_fill(comp + b * stride, t, k, nodes, w + block_at[b], 0, 1);
      }
    }
  }
  for (int r = 0; r < rounds; r++) {
    if (r > 0 && open[r - 1] == 0) break;
    int32_t left = 0;
    for (long long i = 0; i < n_nodes; i++)
      left += lz4tt_lr_step(nodes, reverse ? n_nodes - 1 - i : i);
    open[r] = left;
  }
  for (long long j = 0; j < n_nodes; j++) out[j] = (uint8_t)nodes[j];
}
}
"""

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("linked_decode")
    (out / "harness.cpp").write_text(HARNESS.replace(
        '#include "linked_decode.cuh"\n',
        '#include "linked_decode.cuh"\n\n' + design_variants.FIRST_RESOLVE_CUH))
    res = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-Wall",
         "-Werror", "-Wno-unknown-pragmas", "-I", str(build.CSRC), "-o",
         str(out / "liblinked.so"), str(out / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "liblinked.so"))
    lib.host_linked_walk.argtypes = [_P, _I64, _P, _P, _I32, _I32, _P, _I32,
                                     _P]
    lib.host_linked_resolve.argtypes = [_P, _I64, _P, _I32, _I32, _P, _P,
                                        _I32, _P, _I32, _I32, _I32, _I32,
                                        _I32, _I64, _I32, _I32, _P, _P, _P,
                                        _P, _P, _P, _P]
    lib.host_linked_resolve_first.argtypes = [_P, _I64, _P, _I32, _I32, _P,
                                              _P, _I64, _P, _I32, _I64, _P,
                                              _P, _P, _I32, _I32, _I32]
    return lib


def _rb(rng, n, k=256) -> bytes:
    return rng.integers(0, k, n, dtype=np.uint8).tobytes()


def _host_walk(lib, comp, lens, raw, dest_cap, max_seq):
    n = comp.shape[0]
    tables = torch.zeros((6, n, max_seq), dtype=torch.int32)
    res = torch.zeros((4, n), dtype=torch.int32)
    flags = raw.to(torch.uint8)
    lib.host_linked_walk(comp.data_ptr(), comp.stride(0), lens.data_ptr(),
                         flags.data_ptr(), n, dest_cap, tables.data_ptr(),
                         max_seq, res.data_ptr())
    return (tables, *res)


def _assert_walks_equal(a, b):
    """n_seq, out_total, code, reach, and each row's records."""
    for x, y in zip(a[1:], b[1:]):
        assert x.tolist() == y.tolist()
    for i, k in enumerate(a[1].tolist()):
        assert torch.equal(a[0][:, i, :k], b[0][:, i, :k]), i


def _walk_blocks(rng):
    """K2's blocks of the edge kinds, the boundary, chain, history,
    overreach and short-sequence blocks, fuzz; with raw flags on some."""
    raws = testing.mixed_blocks(rng, (0, 5, 12, 13, 1000, 4000))
    src, lens = layout.to_device_layout(raws, device=CPU)
    comp, clens, _ = codec.compress_fast_plain(src, lens,
                                               max_compressed_length(4000))
    blocks = layout.from_device_layout(comp, clens)
    blocks += testing.boundary_blocks()
    blocks += [c for c, _ in testing.chain_blocks(rng)]
    blocks += [testing.encode_block(s, t)
               for _, s, t in testing.history_blocks(rng)]
    blocks += [b for _, b in testing.overreach_blocks(rng)]
    for case in ("periods", "null", "runs"):
        blocks += [testing.encode_block(s, t) for s, t in
                   testing.short_sequence_blocks(case, rng)[:12]]
    blocks += testing.fuzz_blocks(rng, blocks, 60)
    return blocks


@pytest.fixture(scope="module")
def walk_batch():
    rng = np.random.default_rng(140)
    blocks = _walk_blocks(rng)
    comp, lens = layout.to_device_layout(blocks, device=CPU)
    raw = torch.from_numpy(rng.random(len(blocks)) < 0.1)
    return blocks, comp, lens, raw


@pytest.mark.parametrize("dest_cap, max_seq", [
    (BS, None), (70000, None), (100, None), (17, None), (0, None),
    (BS, 1), (BS, 5)])
def test_host_walk_matches_plain(lib, walk_batch, dest_cap, max_seq):
    """The walk's body (g++) against the plain walk: records, n_seq,
    out_total, codes (``TOO_MANY`` at tiny table widths) and reach."""
    _, comp, lens, raw = walk_batch
    width = max_seq or ld.table_width(lens.tolist(), raw.tolist())
    plain = ld.walk_linked(comp, lens, raw, dest_cap, width)
    _assert_walks_equal(_host_walk(lib, comp, lens, raw, dest_cap, width),
                        plain)
    if max_seq is None:
        assert ld.TOO_MANY not in plain[3].tolist()


@pytest.mark.parametrize("out_max", [BS, 100, 17])
def test_walk_reach_is_k1_with_a_history(walk_batch, out_max):
    """At every history length of ``testing.HIST_LENS``, the walk's code,
    with MALFORMED where its reach goes past the history, is K1's with
    that history, and so is its output length on OK blocks."""
    rng = np.random.default_rng(141)
    blocks, comp, lens, _ = walk_batch
    raw = torch.zeros(len(blocks), dtype=torch.bool)
    _, _, out_total, code, reach = ld.walk_linked(comp, lens, raw, out_max)
    for h in testing.HIST_LENS:
        hist = torch.from_numpy(np.frombuffer(_rb(rng, max(h, 1), 8),
                                              np.uint8).copy()).view(1, -1)
        _, k1_lens, k1_err = codec.decompress_safe_hist_plain(
            comp, lens, out_max, hist,
            torch.full((len(blocks),), h, dtype=torch.int32))
        want = torch.where(reach > h, codec.ERR_MALFORMED, code)
        assert want.tolist() == k1_err.tolist(), h
        ok = want == codec.OK
        assert out_total[ok].tolist() == k1_lens[ok].tolist(), h


def _linked_batch(rng, sizes, w, kind="period"):
    """A batch of linked blocks of ``sizes`` after a window of ``w`` bytes
    (content made so that matches reach across blocks and into the
    window), each compressed against the up to 64 KiB before it, stored
    raw when not shorter. Returns (window, content, payloads, raw flags)."""
    total = w + sum(sizes)
    if kind == "period":
        period = _rb(rng, 700, 16)
        data = (period * (total // 700 + 1))[:total]
    else:
        data = _rb(rng, total, 4)
    window, pos, pays, raw = data[:w], w, [], []
    for n in sizes:
        chunk = data[pos:pos + n]
        comp = ni.compress_block_with_dict(chunk, data[max(0, pos - BS):pos])
        raw.append(len(comp) >= n)
        pays.append(chunk if raw[-1] else comp)
        pos += n
    return window, data[w:], pays, raw


def _resolve_inputs(pays, raw, window, dest_cap):
    comp, lens = layout.to_device_layout(pays, device=CPU)
    flags = torch.tensor(raw, dtype=torch.bool)
    tables, n_seq, out_total, code, reach = ld.walk_linked(comp, lens, flags,
                                                           dest_cap)
    block_at, code, n_ok, n_nodes = ld.frame_plan(out_total, code, reach,
                                                  len(window))
    win = torch.frombuffer(bytearray(window), dtype=torch.uint8) if window \
        else torch.empty((0,), dtype=torch.uint8)
    return comp, tables, n_seq, block_at, n_ok, n_nodes, win, code


def _bits(words, total):
    """A bitmap of int32 words as bool[total]."""
    return np.unpackbits(words.numpy().view(np.uint8),
                         bitorder="little")[:total].astype(bool)


def _host_resolve(lib, comp, tables, n_seq, block_at, n_ok, n_nodes, win,
                  seg, lanes, reverse, list_cap=None, own=-1, plant=-1):
    """The g++ build of the resolve's five kernels (``host_linked_resolve``;
    ``own`` and ``plant`` are its): (out, open nodes, the list (open
    exits), counters)."""
    total = int(n_nodes)
    words = -(-total // 32)
    out = torch.zeros((total,), dtype=torch.uint8)
    off = torch.zeros((total,), dtype=torch.int16)
    maps = torch.zeros((3, max(words, 1)), dtype=torch.int32)
    cap = total if list_cap is None else list_cap
    lst = torch.zeros((2 * max(cap, 1),), dtype=torch.int32)
    counters = torch.zeros((4,), dtype=torch.int32)
    lib.host_linked_resolve(
        comp.data_ptr(), comp.stride(0), tables.data_ptr(), tables.shape[2],
        comp.shape[0], n_seq.data_ptr(), block_at.data_ptr(), int(n_ok),
        win.data_ptr(), win.numel(), total, seg, lanes, reverse, cap, own,
        plant, out.data_ptr(), off.data_ptr(), maps[0].data_ptr(),
        maps[1].data_ptr(), maps[2].data_ptr(), lst.data_ptr(),
        counters.data_ptr())
    return out, _bits(maps[0], total), _bits(maps[1], total), counters


def _assert_host_resolve(lib, inputs, seg, lanes, reverse, content=None):
    """The g++ resolve (``reverse``: its segments from the last and the
    list's rounds the grid's alone, no thread's own) equals the plain
    version (and ``content``); its open nodes are those whose chain leaves
    their segment, its list those of them that are exits (both from the
    plain version's nodes); its counts say so, and nothing is left
    open."""
    comp, tables, n_seq, block_at, n_ok, n_nodes, win, _ = inputs
    total = int(n_nodes)
    plain, _ = ld.resolve_linked(comp, tables, n_seq, block_at, n_ok,
                                 n_nodes, win, max(total, 1))
    if content is not None:
        assert plain[:total].numpy().tobytes() == content
    out, opened, listed, counters = _host_resolve(
        lib, comp, tables, n_seq, block_at, n_ok, n_nodes, win, seg, lanes,
        reverse, own=0 if reverse else -1)
    assert torch.equal(out, plain[:total])
    leaves, want = testing.resolve_sets(tables, n_seq, block_at, n_ok,
                                        win.numel(), total, seg)
    assert np.array_equal(opened, leaves)
    assert np.array_equal(listed, want)
    assert counters.tolist()[:2] == [int(leaves.sum()), int(want.sum())]
    assert int(counters[3]) == 0
    return counters


@pytest.mark.parametrize("sizes, w, kind", [
    ((BS, BS, 1000, BS), 0, "period"),
    ((300, 250, 10, 700, 400, 2000), 5000, "period"),
    ((200,) * 12, 65536, "a4"),
    ((BS, 500, 3000), 100, "a4"),
])
@pytest.mark.parametrize("reverse", [0, 1])
def test_host_resolve_matches_plain(lib, sizes, w, kind, reverse):
    """The resolve's bodies (g++: each segment by a team of host threads,
    in segment order or (reverse) from the last; the list's rounds each
    thread's own first or (reverse) the grid's alone) against the plain
    version's synchronous rounds, at segments of
    256 (tiles of 8), 1,024 (16) and the card's 16 KiB (16): the batch's
    bytes equal its content; the open nodes are exactly those whose chain
    leaves their segment, and the list exactly those of them that are
    exits, counted from the plain version's nodes."""
    rng = np.random.default_rng(142 + w)
    window, content, pays, raw = _linked_batch(rng, sizes, w, kind)
    inputs = _resolve_inputs(pays, raw, window, BS)
    assert int(inputs[4]) == len(sizes)
    for seg, lanes in ((256, 4), (1024, 8), (ld.SEGMENT, 8)):
        counters = _assert_host_resolve(lib, inputs, seg, lanes, reverse,
                                        window + content)
        if seg == 256:
            assert int(counters[1]) > 0    # chains leave their segments


@pytest.mark.parametrize("sizes, w, kind", [
    ((BS, BS, 1000, BS), 0, "period"),
    ((300, 250, 10, 700, 400, 2000), 5000, "period"),
    ((200,) * 12, 65536, "a4"),
    ((BS, 500, 3000), 100, "a4"),
])
@pytest.mark.parametrize("reverse", [0, 1])
def test_host_first_resolve_matches_plain(lib, sizes, w, kind, reverse):
    """The resolve's first design (``lz4tt_linked_resolve_rounds``, kept
    for timing; g++: the fill with long records split as a CTA splits
    them, rounds in place) against the plain version's synchronous
    rounds: the batch's bytes equal its content; walking the nodes from
    the last (each parent read before it is written) gives the plain
    version's open counts round for round."""
    rng = np.random.default_rng(142 + w)
    window, content, pays, raw = _linked_batch(rng, sizes, w, kind)
    comp, tables, n_seq, block_at, n_ok, n_nodes, win, _ = _resolve_inputs(
        pays, raw, window, BS)
    cap = w + len(sizes) * BS
    plain, plain_open = ld.resolve_linked(comp, tables, n_seq, block_at,
                                          n_ok, n_nodes, win, cap)
    total = int(n_nodes)
    assert plain[:total].numpy().tobytes() == window + content
    nodes = torch.zeros((total,), dtype=torch.int32)
    out = torch.zeros((total,), dtype=torch.uint8)
    rounds = ld.rounds_for(cap)
    opened = torch.zeros((rounds,), dtype=torch.int32)
    lib.host_linked_resolve_first(
        comp.data_ptr(), comp.stride(0), tables.data_ptr(), tables.shape[2],
        comp.shape[0], n_seq.data_ptr(), block_at.data_ptr(), int(n_ok),
        win.data_ptr(), w, total, nodes.data_ptr(), out.data_ptr(),
        opened.data_ptr(), rounds, 256, reverse)
    assert torch.equal(out, plain[:total])
    assert int(opened[-1]) == 0
    if reverse:
        assert opened.tolist() == plain_open.tolist()
        assert int(plain_open[0]) > 0      # chains longer than one hop


def _case_inputs(case, seed=160):
    window, raws, comps, dest_cap, n_ok = testing.resolve_case(
        case, np.random.default_rng(seed))
    pays = testing.payloads(raws, comps)
    flags = [len(c) >= len(r) for r, c in zip(raws, comps)]
    inputs = _resolve_inputs(pays, flags, window, dest_cap)
    assert int(inputs[4]) == n_ok
    return inputs, window + b"".join(raws[:n_ok])


@pytest.mark.parametrize("case", testing.RESOLVE_CASES)
@pytest.mark.parametrize("seg, lanes, reverse", [(64, 8, 0), (1024, 4, 1),
                                                 (ld.SEGMENT, 8, 0)])
def test_host_resolve_cases(lib, case, seg, lanes, reverse):
    """``testing.resolve_case``'s batches through the resolve's bodies
    (g++) against the plain version and their content: distance-1 to -3
    chains over segment and tile seams, 256 short blocks each reaching
    into the block before, the window as the only source, null offsets
    across seams, records longer than a segment, a 4 MiB block cut
    mid-match, and a batch whose fourth block fails (``n_ok`` 3)."""
    if case == "big_block":
        # a team of host threads waits at a barrier a tile: 4 MiB of tiles
        # take minutes, so one thread, and segments of at least 1 KiB
        seg, lanes = max(seg, 1024), 1
    inputs, content = _case_inputs(case)
    _assert_host_resolve(lib, inputs, seg, lanes, reverse, content)


@pytest.mark.parametrize("room", [1, 7, 3])
def test_host_resolve_in_chunks(lib, room):
    """Room for fewer open exits than the batch has (one, 7, a third of
    them): the resolve takes them in chunks in output order, each resolved
    before the next reads it, and gives the same bytes and counts."""
    inputs, content = _case_inputs("chains")
    comp, tables, n_seq, block_at, n_ok, n_nodes, win, _ = inputs
    args = (lib, comp, tables, n_seq, block_at, n_ok, n_nodes, win, 1024, 8,
            0)
    whole = _host_resolve(*args)[3]
    need = int(whole[1])
    assert need > 21
    cap = need // 3 + 1 if room == 3 else room
    out, _, _, counters = _host_resolve(*args, list_cap=cap)
    assert out.numpy().tobytes() == content
    assert counters.tolist()[:2] == whole.tolist()[:2]
    assert int(counters[3]) == 0


@pytest.mark.parametrize("own, lanes", [(-1, 1), (-1, 4), (0, 4), (2, 3)])
def test_host_resolve_counts_a_planted_fault(lib, own, lanes):
    """A list entry planted to point at itself (no correct list has one: a
    chain that never ends) cannot hang the rounds: they stop
    after a thread's own rounds (the kernel's, none, or two) and the
    grid's ``lz4tt_rs_rounds_for(len)``, and count the entries left open,
    the planted one and those whose chains run through it."""
    inputs, content = _case_inputs("chains")
    comp, tables, n_seq, block_at, n_ok, n_nodes, win, _ = inputs
    args = (lib, comp, tables, n_seq, block_at, n_ok, n_nodes, win, 1024,
            lanes, 0)
    whole = _host_resolve(*args, own=own)
    assert int(whole[3][3]) == 0
    assert whole[0].numpy().tobytes() == content
    need = int(whole[3][1])
    counters = _host_resolve(*args, own=own, plant=need // 2)[3]
    assert int(counters[3]) >= 1
    most = ld.rounds_for(need)
    assert int(counters[2]) <= (most if own < 0 else own) + most
    # the list in chunks of a third of it (the fault in the first), the
    # tally's turns going on from chunk to chunk
    counters = _host_resolve(*args, list_cap=need // 3 + 1, own=own,
                             plant=0)[3]
    assert int(counters[3]) >= 1


def test_decode_linked_batch_raises_on_nodes_left_open(monkeypatch):
    """``decode_linked_batch`` reads the resolve's last count, the nodes it
    left open, back with the codes, and raises where it is not 0."""
    rng = np.random.default_rng(164)
    window, content, pays, raw = _linked_batch(rng, (300, 250, 700), 0,
                                               "period")
    comp, cl = layout.to_device_layout(pays, device=CPU)
    flags = torch.tensor(raw)
    win = torch.empty((0,), dtype=torch.uint8)
    batch = ld.decode_linked_batch(comp, cl, flags, BS, win)
    assert batch.out[:batch.n_nodes].numpy().tobytes() == content
    resolve = ld.resolve_linked

    def faulty(*args):
        out, open_ = resolve(*args)
        return out, torch.tensor([7, 3, 2, 2], dtype=torch.int32)
    monkeypatch.setattr(ld, "resolve_linked", faulty)
    with pytest.raises(RuntimeError, match="2 nodes still open"):
        ld.decode_linked_batch(comp, cl, flags, BS, win)


_RESOLVE_EDITS = {"first design": design_variants._FIRST_RESOLVE,
                  "look-back walk": design_variants._LOOKBACK,
                  **{k: v[0] for k, v in
                     design_variants.RESOLVE_BUILDS.items()}}


@pytest.mark.parametrize("name", list(_RESOLVE_EDITS))
def test_linked_design_variants_apply(name):
    """Every build of ``design_variants`` for the linked walk and resolve
    (the resolve's first design, its segment sizes, its parts, options
    tried; the look-back walk) is still a set of edits to the shipped
    sources: each replaced text is there once."""
    for fname, old, new in _RESOLVE_EDITS[name]:
        assert (build.CSRC / fname).read_text().count(old) == 1
        assert old != new


def test_resolve_stops_at_the_first_failing_block():
    """A block whose reach goes past its history (short blocks: block 2
    starts 500 bytes into a frame with no window) is MALFORMED, nothing of
    it or after it gets a node, and the blocks before it decode."""
    rng = np.random.default_rng(143)
    a, b = _rb(rng, 300), _rb(rng, 200)
    pays = [testing.encode_block([], a),
            testing.encode_block([(b"xy", 250, 10)], b"tail....."),
            testing.encode_block([(b"zz", 503, 8)], b"tail....."),
            testing.encode_block([], b)]
    comp, tables, n_seq, block_at, n_ok, n_nodes, win, code = \
        _resolve_inputs(pays, [False] * 4, b"", BS)
    assert code.tolist() == [codec.OK, codec.OK, codec.ERR_MALFORMED,
                             codec.OK]
    assert int(n_ok) == 2 and int(n_nodes) == 300 + 21
    out, _ = ld.resolve_linked(comp, tables, n_seq, block_at, n_ok, n_nodes,
                               win, 4 * BS)
    want = a + b"xy" + (a + b"xy")[2 + 300 - 250:][:10] + b"tail....."
    assert out[:int(n_nodes)].numpy().tobytes() == want
    assert not bool(out[int(n_nodes):].any())
    # a block whose checksum did not hold stops the batch there too
    _, _, out_total, code, reach = ld.walk_linked(
        comp, torch.tensor([len(p) for p in pays], dtype=torch.int32),
        torch.zeros(4, dtype=torch.bool), BS)
    for held, want_ok in (([True, False, True, True], 1),
                          ([True, True, False, False], 2),
                          ([False] * 4, 0)):
        plan = ld.frame_plan(out_total, code, reach, 0, torch.tensor(held))
        assert int(plan[2]) == want_ok and int(plan[3]) == [0, 300, 321][
            want_ok]


# ---------------------------------------------------------------------------
# whole frames: the batched path against the serial readers
# ---------------------------------------------------------------------------

def _serial(frame, dictionary):
    """(bytes written, error) of the port's serial reader, read as the
    frame loop read it before the batched path: 1 MiB at a time."""
    out = io.BytesIO()
    reader = frame_mod.Lz4FrameInputStream(
        io.BytesIO(frame), allow_dependent_blocks=True, dictionary=dictionary,
        device=CPU)
    try:
        while chunk := reader.read(1 << 20):
            out.write(chunk)
    except Lz4Error as e:
        return out.getvalue(), e
    return out.getvalue(), None


def _jax(frame, dictionary):
    """The same of the JAX package's reader."""
    out = io.BytesIO()
    reader = jframe.Lz4FrameInputStream(
        io.BytesIO(frame), allow_dependent_blocks=True, dictionary=dictionary)
    try:
        while chunk := reader.read(1 << 20):
            out.write(chunk)
    except Exception as e:      # noqa: BLE001 - compared with the port's
        return out.getvalue(), e
    return out.getvalue(), None


def _batched(frame, dictionary, batch_blocks):
    out = io.BytesIO()
    try:
        decode_frames(io.BytesIO(frame), out, "cuda", batch_blocks, CPU,
                      allow_dependent=True, dictionary=dictionary)
    except Lz4Error as e:
        return out.getvalue(), e
    return out.getvalue(), None


def _what(err):
    """An error's class and message; the JAX package's native history
    decode names itself after the message."""
    if err is None:
        return None
    return (type(err).__name__,
            str(err).replace(" (decompress_block_with_history)", ""))


def _assert_outcome(frame, dictionary=None, batches=(1, 3, 256),
                    want=None):
    """The batched path at each batch size equals the port's serial
    reader and the JAX reader: bytes written and error. Returns the
    error."""
    got, err = _serial(frame, dictionary)
    jgot, jerr = _jax(frame, dictionary)
    assert got == jgot
    assert _what(err) == _what(jerr)
    if want is not None:
        assert got == want and err is None
    for b in batches:
        bgot, berr = _batched(frame, dictionary, b)
        assert bgot == got, b
        assert _what(berr) == _what(err), b
    return err


def _short_frame(rng, sizes, dictionary=b"", kind="period", **kw):
    """A linked frame of blocks of ``sizes`` (a few hundred bytes to 64
    KiB), each compressed against the dictionary's tail and the content
    before it."""
    window, content, pays, raw = _linked_batch(rng, sizes, len(dictionary),
                                               kind)
    if dictionary:          # the content was made behind a window: use it
        dictionary = window
    comps = [p if not r else p + b"+" for p, r in zip(pays, raw)]
    raws = [content[sum(sizes[:i]):sum(sizes[:i + 1])]
            for i in range(len(sizes))]
    kw.setdefault("block_checksum", False)
    return testing.build_frame(raws, comps, independent=False, **kw), \
        content, dictionary


@needs_liblz4
@pytest.mark.parametrize("size, kw", [
    (300_000, dict(content_checksum=True)),
    (200_000, dict(content_checksum=False, block_checksum=True)),
    (150_000, dict(content_checksum=True, content_size=True)),
    (65536, dict()),
])
def test_upstream_linked_frames(size, kw):
    """LZ4F's linked frames (``blockMode`` 0) of 64 KiB blocks, with and
    without checksums and the content size."""
    rng = np.random.default_rng(size)
    period = _rb(rng, 40_000, 32)
    data = (period * (size // 40_000 + 1))[:size]
    _assert_outcome(_upstream_linked_frame(data, **kw), want=data)


@needs_liblz4
def test_upstream_linked_dictionary_frame():
    """A linked frame compressed against a dictionary by LZ4F, and the same
    frame without it (malformed: its matches reach before the frame)."""
    rng = np.random.default_rng(144)
    dictionary = _rb(rng, 70_000, 16)
    data = (dictionary[-30_000:] * 6)[:170_000]
    fr = _upstream_dict_frame(data, dictionary, block_mode=0)
    _assert_outcome(fr, dictionary, want=data)
    assert _assert_outcome(fr) is not None


@pytest.mark.parametrize("bd, kind", [(4, "period"), (4, "a4"), (5, "period")])
def test_port_linked_frames(bd, kind):
    """Frames of ``testing.linked_blocks`` (full blocks, each against the
    content before it): deep chains of alphabet-4 data across blocks, 64
    KiB and 256 KiB blocks."""
    rng = np.random.default_rng(145)
    bs = 1 << (2 * bd + 8)
    size = (2 if kind == "period" else 1) * bs + 12345
    data = (_rb(rng, 40_000, 32) * 40)[:size] if kind == "period" \
        else _rb(rng, size, 4)
    raws = [data[i:i + bs] for i in range(0, size, bs)]
    fr = testing.build_frame(raws, testing.linked_blocks(data, bs, CPU),
                             bd=bd, independent=False, block_checksum=False)
    _assert_outcome(fr, want=data, batches=(2, 256))


@pytest.mark.parametrize("dictionary", [b"", b"dict"])
@pytest.mark.parametrize("kind", ["period", "a4"])
def test_short_blocks(dictionary, kind):
    """Blocks of a few hundred bytes: histories shorter than 64 KiB for
    many blocks in a row, matches reaching through several blocks into
    the dictionary; raw blocks among them."""
    rng = np.random.default_rng(146)
    sizes = [int(s) for s in rng.integers(1, 900, 40)] + [BS, 7]
    fr, content, d = _short_frame(rng, sizes, dictionary * 20000, kind)
    _assert_outcome(fr, d or None, want=content, batches=(3, 256))


def test_null_offsets_and_overlaps():
    """Hand-made blocks: null offsets (zeros), overlapping matches of
    periods 1-4, and matches into the block and the frame before it."""
    rng = np.random.default_rng(147)
    first = [(_rb(rng, 10), 1, 30), (_rb(rng, 3), 0, 20), (b"", 2, 17),
             (_rb(rng, 4), 4, 100), (b"", 3, 9)]
    second = [(b"", 50, 40), (b"q", 0, 4), (b"", 160, 64), (b"r", 1, 300)]
    raws, comps, hist = [], [], b""
    for seqs in (first, second, first):
        tail = _rb(rng, 6)
        raws.append(testing.expand_block(seqs, tail, hist))
        comps.append(testing.encode_block(seqs, tail))
        hist += raws[-1]
    fr = testing.build_frame(raws, comps, independent=False)
    _assert_outcome(fr, want=b"".join(raws))


def test_concatenated_frames_reset_the_window():
    """Two linked frames in a row, a skippable frame between them: each
    starts with an empty window; the second's first block reaching back
    is malformed, as it is in the serial readers."""
    rng = np.random.default_rng(148)
    a, ca, _ = _short_frame(rng, [500, 700, 300])
    b, cb, _ = _short_frame(rng, [400, 400])
    skip = struct.pack("<II", 0x184D2A50, 3) + b"abc"
    _assert_outcome(a + skip + b, want=ca + cb)
    reach = testing.build_frame([b"x" * 14], [testing.encode_block(
        [(b"x", 1, 8)], b"xxxxx")], independent=False)
    bad = testing.build_frame([b"y" * 10], [testing.encode_block(
        [(b"", 5, 5)], b"yyyyy")], independent=False)
    assert _assert_outcome(a + reach + a + bad) is not None
    out = io.BytesIO()
    decode_frames(io.BytesIO(a + b), out, "cuda", device=CPU,
                  allow_dependent=True, single_frame=True)
    assert out.getvalue() == ca


def _frame_of(blocks, **kw):
    """A linked frame of hand-made compressed ``(raw, comp)`` blocks."""
    return testing.build_frame([r for r, _ in blocks], [c for _, c in blocks],
                               independent=False, **kw)


def _good(rng, n=300):
    data = _rb(rng, n)
    return data, testing.encode_block([], data)


def _oversized():
    """A block that decodes to 65,542 bytes, past its 64 KiB slot."""
    ml = 65536 - 4 - 15
    return b"x" * 65537, (bytes([0x1F, ord("A"), 0x01, 0x00])
                          + b"\xff" * (ml // 255) + bytes([ml % 255])
                          + bytes([0x50]) + b"BBBBB")


def _reach_then_long_literals(reach):
    """A block whose second sequence reaches ``reach`` bytes before its
    start, then a literal run declared past 64 KiB."""
    return b"z" * 70000, (testing.encode_block([(b"ab", 2 + reach, 4)], b"")[:-1]
                          + bytes([0xF0]) + b"\xff" * 300 + b"\x00")


@pytest.mark.parametrize("case", [
    "reach_first", "reach_in_dictionary", "oversized", "reach_short",
    "fuzz"])
@pytest.mark.parametrize("at", [0, 4])
def test_decode_errors(case, at):
    """Each failing block after ``at`` good ones: the walk's first error in
    walk order (a reach before the frame wins over a later literal run
    past the block size, which without the reach is DEST_TOO_SMALL), a
    block decoding past its slot, a reach past a short history, and fuzz;
    the blocks before it are written, nothing of it or after it."""
    rng = np.random.default_rng(149 + at)
    blocks = [_good(rng, int(rng.integers(50, 400))) for _ in range(at)]
    dictionary = None
    if case == "reach_first":
        blocks.append(_reach_then_long_literals(5000))
    elif case == "reach_in_dictionary":
        dictionary = _rb(rng, 6000)
        blocks.append(_reach_then_long_literals(5000))
    elif case == "oversized":
        blocks.append(_oversized())
    elif case == "reach_short":
        blocks.append((b"r" * 20, testing.encode_block(
            [(b"", sum(len(r) for r, _ in blocks) + 1, 8)], b"t" * 12)))
    else:
        seeds = [testing.encode_block([(b"ab", 2, 40)], b"x" * 9),
                 testing.encode_block([(_rb(rng, 30), 0, 20), (b"", 7, 50)],
                                      _rb(rng, 9))]
        blocks += [(b"f" * 70000, f)
                   for f in testing.fuzz_blocks(rng, seeds, 12)]
    blocks.append(_good(rng))
    err = _assert_outcome(_frame_of(blocks), dictionary)
    assert err is not None or case == "fuzz"


@pytest.mark.parametrize("fault", ["checksum", "premature", "oversize",
                                   "content", "size"])
def test_frame_faults(fault):
    """A block checksum mismatch at block 5 (checked before its decode), a
    stream cut inside block 5, a block size past the frame's, a content
    checksum and a declared size that differ: the blocks before each
    fault written, as the serial readers write them."""
    rng = np.random.default_rng(150)
    fr, content, _ = _short_frame(rng, [300, 800, 5, 600, 100, 700, 200],
                                  block_checksum=True)
    # walk the frame to block 5's size word
    pos, sizes = 7, []
    for _ in range(5):
        n = struct.unpack_from("<I", fr, pos)[0] & 0x7FFFFFFF
        sizes.append(n)
        pos += 4 + n + 4
    fr = bytearray(fr)
    if fault == "checksum":
        n = struct.unpack_from("<I", fr, pos)[0] & 0x7FFFFFFF
        fr[pos + 4 + n] ^= 1
    elif fault == "premature":
        fr = fr[:pos + 9]
    elif fault == "oversize":
        fr[pos:pos + 4] = struct.pack("<I", BS + 1)
    elif fault == "content":
        fr[-1] ^= 0x80
    else:
        fr = bytearray(_upstream_frame_with_size(content, len(content) + 1))
    _assert_outcome(bytes(fr))


def _upstream_frame_with_size(content: bytes, declared: int) -> bytes:
    """A linked frame of ``content`` that declares ``declared`` bytes."""
    desc = bytes([0x40 | 0x08, 0x40]) + struct.pack("<Q", declared)
    hc = (frame_mod.xxh32_bytes(desc) >> 8) & 0xFF
    body = struct.pack("<I", len(content) | 0x80000000) + content
    return struct.pack("<I", 0x184D2204) + desc + bytes([hc]) + body + \
        struct.pack("<I", 0)


def test_pipeline_entry_points_take_the_batched_path(monkeypatch, tmp_path):
    """``decompress_frame``, ``decompress_stream`` and the CLI's
    ``--allow-dependent`` go through the walk and the resolve, a fixed
    number of calls a batch, and never through the serial history
    decode."""
    from lz4_tpu_torch.__main__ import main as cli_main
    from lz4_tpu_torch.streams import decompress_stream

    rng = np.random.default_rng(151)
    fr, content, _ = _short_frame(rng, [int(s) for s in
                                        rng.integers(100, 2000, 40)])
    calls = {"walk": 0, "resolve": 0, "hist": 0}

    def counting(name, fn):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(ld, "walk_linked_plain",
                        counting("walk", ld.walk_linked_plain))
    monkeypatch.setattr(ld, "resolve_linked_plain",
                        counting("resolve", ld.resolve_linked_plain))
    monkeypatch.setattr(codec, "decompress_safe_hist_plain",
                        counting("hist", codec.decompress_safe_hist_plain))
    assert frame_mod.decompress_frame(fr, allow_dependent_blocks=True,
                                      device=CPU) == content
    assert calls == {"walk": 1, "resolve": 1, "hist": 0}
    out = io.BytesIO()
    decompress_stream(io.BytesIO(fr), out, allow_dependent=True,
                      batch_blocks=16, device=CPU)
    assert out.getvalue() == content
    assert calls == {"walk": 4, "resolve": 4, "hist": 0}
    src, dst = tmp_path / "in.lz4", tmp_path / "out.bin"
    src.write_bytes(fr)
    assert cli_main(["decompress", "--allow-dependent", str(src), str(dst)],
                    device=CPU) == 0
    assert dst.read_bytes() == content
    assert calls["hist"] == 0 and calls["walk"] == calls["resolve"] == 5
