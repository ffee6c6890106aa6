"""The per-block bodies of the port's CUDA kernels (``lz4_tpu_torch/csrc/
*.cuh``), built for the host with g++ as one-lane teams, against the plain
versions on the same seeded inputs. This catches logic faults in the
kernels' code without a card; the package never uses this build."""

import ctypes
import functools
import shutil
import subprocess

import numpy as np
import pytest
import torch

import design_variants
from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.kernels import (
    build, codec, gather_decode, hc, layout, parallel_compress, segment_decode,
    sequences, xxhash, xxhash_stream)
from test_torch_segment import CORRUPTIONS, corrupt

HARNESS = r"""
// every read of the parser's window is held to the window's promise
static int window_faults = 0;
#define LZ4TT_PARSE_CHECK(i, lo, hi) \
  if ((i) < (lo) || (i) >= (hi)) __atomic_add_fetch(&window_faults, 1, __ATOMIC_RELAXED)
// K6's speculated walks: the links that failed and were followed
static long long hc_followed = 0;
#define LZ4TT_HC_FOLLOWED() __atomic_add_fetch(&hc_followed, 1, __ATOMIC_RELAXED)
// and every record's chain copy a walk reads, against its chain slot
static int hc_copy_faults = 0;
#define LZ4TT_HC_CHECK_COPY(copy, slot) \
  if ((copy) != (slot)) __atomic_add_fetch(&hc_copy_faults, 1, __ATOMIC_RELAXED)
#include "block_stream.cuh"
#include "frame_pack.cuh"
#include "gather_decode.cuh"
#include "lz4_compress.cuh"
#include "lz4_decode.cuh"
#include "lz4_hc.cuh"
#include "lz4_parse.cuh"
#include "parallel_compress.cuh"
#include "segment_decode.cuh"
#include "xxh32.cuh"
#include "xxh64.cuh"
#include <pthread.h>
#include <vector>

// A team of n host threads that meet at a barrier for every collective, as
// a warp's lanes do: it runs a body's multi-lane logic (the lane split,
// ballots, shuffles, the queue) on the host. Nothing here models the
// card's memory; the barrier orders all memory.
struct ThreadTeamShared {
  pthread_barrier_t bar;
  int32_t slot[32];
};
struct ThreadTeam {
  ThreadTeamShared* sh;
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
  int32_t bcast(int32_t v) const { return shfl(v, 0); }
  unsigned match_any(uint32_t v) const {
    sh->slot[id] = (int32_t)v;
    sync();
    unsigned m = 0;
    for (int i = 0; i < n; i++) m |= (uint32_t)sh->slot[i] == v ? 1u << i : 0u;
    sync();
    return m;
  }
  uint32_t reduce_max(uint32_t v) const {
    sh->slot[id] = (int32_t)v;
    sync();
    uint32_t m = 0;
    for (int i = 0; i < n; i++)
      m = (uint32_t)sh->slot[i] > m ? (uint32_t)sh->slot[i] : m;
    sync();
    return m;
  }
  // the block-team collectives of K7 and K8 (parallel_compress.cuh)
  int rank() const { return id; }
  int32_t exclusive_sum(int32_t v, int32_t* total) const {
    sync();
    sh->slot[id] = v;
    sync();
    int32_t e = 0, s = 0;
    for (int i = 0; i < n; i++) {
      s += sh->slot[i];
      if (i < id) e += sh->slot[i];
    }
    *total = s;
    return e;
  }
  int32_t exclusive_min(int32_t v, int32_t* total) const {
    sync();
    sh->slot[id] = v;
    sync();
    int32_t m = LZ4TT_PC_NO_STOP, all = v;
    for (int i = 0; i < n; i++) {
      all = sh->slot[i] < all ? sh->slot[i] : all;
      if (i < id) m = sh->slot[i] < m ? sh->slot[i] : m;
    }
    *total = all;
    return m;
  }
  void sort_pass(const uint32_t* ks, const int32_t* vs, uint32_t* kd,
                 int32_t* vd, int32_t m, int shift, uint32_t mask) const {
    sync();
    if (id == 0) lz4tt_pc_sort_serial(ks, vs, kd, vd, m, shift, mask);
    sync();
  }
  int32_t slot(int32_t* p) const { return add(p, 1); }
  int warp_size() const { return 1; }
  int32_t warp_min(int32_t v) const { return v; }
  int32_t warp_suffix_min(int32_t v) const { return v; }
  int32_t warp_bcast(int32_t v, int) const { return v; }
  int32_t warp_count(bool p) const { return p ? 1 : 0; }
  int32_t warp_rank(bool) const { return 0; }
  bool any(bool p) const {
    sync();
    sh->slot[id] = p;
    sync();
    bool r = false;
    for (int i = 0; i < n; i++) r |= sh->slot[i] != 0;
    return r;
  }
  int32_t add(int32_t* p, int32_t v) const {
    return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
  }
};

struct SegmentJob {
  const uint8_t* comp;
  int32_t comp_len, ns, max_seq, out_max;
  Lz4ttSeqTables s;
  uint8_t* out;
  uint8_t* ring;
  Lz4ttCopies* q;
  ThreadTeamShared* sh;
  int lanes;
  int32_t err[32];
};
struct SegmentLane {
  SegmentJob* job;
  int id;
};
static void* segment_lane(void* arg) {
  SegmentLane* l = (SegmentLane*)arg;
  SegmentJob* j = l->job;
  ThreadTeam t = {j->sh, l->id, j->lanes};
  j->err[l->id] = lz4tt_segment_block(t, j->comp, j->comp_len, j->s, j->ns,
                                      j->max_seq, j->out, j->out_max, j->ring,
                                      *j->q);
  return nullptr;
}

// One block of K6's body by a team of host threads.
struct HcJob {
  const uint8_t* src;
  int32_t len;
  uint8_t* dst;
  int32_t dest_cap;
  long long dst_width;
  int32_t attempts;
  uint8_t* scratch;
  uint32_t* counts;
  ThreadTeamShared* sh;
  int lanes;
  int32_t out_len[32], err[32];
};
struct HcLane {
  HcJob* job;
  int id;
};
static void* hc_lane(void* arg) {
  HcLane* l = (HcLane*)arg;
  HcJob* j = l->job;
  ThreadTeam t = {j->sh, l->id, j->lanes};
  lz4tt_hc_block(t, j->src, j->len, j->dst, j->dest_cap, j->dst_width,
                 j->attempts, j->scratch, j->counts, &j->out_len[l->id],
                 &j->err[l->id]);
  return nullptr;
}

// One block of a batch by a team of host threads, one job a launch of
// host_team: the parser's body or the pack body.
struct TeamBatch {
  const uint8_t* a;
  long long a_stride;
  const int32_t* a_lens;
  const uint8_t* b;
  long long b_stride;
  const int32_t* b_lens;
  const int32_t* offs;
  uint8_t* body;
  int32_t max_seq;
  int32_t* tables;
  int32_t* n_seq;
  int32_t* out_total;
  int n;
  uint8_t* win;
};
struct TeamJob {
  const TeamBatch* batch;
  long long row;
  ThreadTeamShared* sh;
  int lanes;
  int32_t code[32], total[32];
};
struct TeamLane {
  TeamJob* job;
  int id;
};
template <class Team>
static void parse_row(const Team& t, const TeamBatch& x, long long b,
                      int32_t* code, int32_t* total) {
  *code = lz4tt_parse_block(t, x.a + b * x.a_stride, x.a_lens[b], x.max_seq,
                            lz4tt_seq_row(x.tables, x.n, x.max_seq, b), x.win,
                            total);
}
template <class Team>
static void pack_row(const Team& t, const TeamBatch& x, long long b) {
  lz4tt_pack_block(t, x.a + b * x.a_stride, x.a_lens[b], x.b + b * x.b_stride,
                   x.b_lens[b], x.body + x.offs[b]);
}
static void* parse_lane(void* arg) {
  TeamLane* l = (TeamLane*)arg;
  TeamJob* j = l->job;
  ThreadTeam t = {j->sh, l->id, j->lanes};
  parse_row(t, *j->batch, j->row, &j->code[l->id], &j->total[l->id]);
  return nullptr;
}
static void* pack_lane(void* arg) {
  TeamLane* l = (TeamLane*)arg;
  ThreadTeam t = {l->job->sh, l->id, l->job->lanes};
  pack_row(t, *l->job->batch, l->job->row);
  return nullptr;
}
// Every row of x by a team of `lanes` host threads running fn; for the
// parser, returns -1 if the lanes disagree on a row's code or total.
static int host_team(const TeamBatch& x, int lanes, void* (*fn)(void*)) {
  ThreadTeamShared sh;
  pthread_barrier_init(&sh.bar, nullptr, lanes);
  int rc = 0;
  for (long long b = 0; b < x.n && rc == 0; b++) {
    TeamJob job = {&x, b, &sh, lanes, {}, {}};
    pthread_t th[32];
    TeamLane ls[32];
    for (int i = 0; i < lanes; i++) {
      ls[i] = {&job, i};
      pthread_create(&th[i], nullptr, fn, &ls[i]);
    }
    for (int i = 0; i < lanes; i++) pthread_join(th[i], nullptr);
    if (fn == parse_lane) {
      x.n_seq[b] = job.code[0];
      x.out_total[b] = job.total[0];
      for (int i = 1; i < lanes; i++)
        if (job.code[i] != job.code[0] || job.total[i] != job.total[0]) rc = -1;
    }
  }
  pthread_barrier_destroy(&sh.bar);
  return rc;
}

// Absorb a row's n_stripes stripes into its lanes v[4] as a CTA does: in
// stages of `per` stripes (lz4tt_xxh_stage_stripes), each copied into an
// aligned buffer, every lane absorbed from it by `stage`.
template <int kStripe, class T, class Stage>
static void host_stages(const uint8_t* data, int64_t n_stripes, int32_t per, T* v,
                        Stage stage) {
  alignas(16) uint8_t buf[LZ4TT_XXH_STAGE];
  for (int64_t i = 0; i * per < n_stripes; i++) {
    const int32_t n = lz4tt_xxh_stage_stripes(n_stripes, i, per);
    memcpy(buf, data + i * per * kStripe, kStripe * n);
    for (int k = 0; k < 4; k++) v[k] = stage(buf, n, k, v[k]);
  }
}

// f(team) on each of `lanes` host threads that form one team.
template <class F>
static void run_team(int lanes, F f) {
  struct Arg {
    F* f;
    ThreadTeamShared* sh;
    int id, n;
  };
  ThreadTeamShared sh;
  pthread_barrier_init(&sh.bar, nullptr, lanes);
  Arg args[32];
  pthread_t th[32];
  for (int i = 0; i < lanes; i++) {
    args[i] = {&f, &sh, i, lanes};
    pthread_create(&th[i], nullptr, [](void* a) -> void* {
      Arg* x = (Arg*)a;
      (*x->f)(ThreadTeam{x->sh, x->id, x->n});
      return nullptr;
    }, &args[i]);
  }
  for (int i = 0; i < lanes; i++) pthread_join(th[i], nullptr);
  pthread_barrier_destroy(&sh.bar);
}

extern "C" {
void host_decode(const uint8_t* comp, long long comp_stride,
                 const int32_t* comp_lens, uint8_t* out, long long out_stride,
                 int out_max, int32_t* out_lens, int32_t* err, int n) {
  HostTeam t;
  alignas(16) uint8_t ring[LZ4TT_RING];
  Lz4ttCopies q;
  int32_t read;
  for (int b = 0; b < n; b++)
    lz4tt_decode_row<false>(t, comp + b * comp_stride, comp_stride,
                            comp_lens[b], out + b * out_stride, out_max, ring,
                            q, &out_lens[b], &read, &err[b]);
}
void host_decode_fast(const uint8_t* comp, long long comp_stride,
                      const int32_t* comp_avail, uint8_t* out,
                      long long out_stride, int dest_len, int32_t* src_read,
                      int32_t* err, int n) {
  HostTeam t;
  alignas(16) uint8_t ring[LZ4TT_RING];
  Lz4ttCopies q;
  int32_t len;
  for (int b = 0; b < n; b++)
    lz4tt_decode_row<true>(t, comp + b * comp_stride, comp_stride,
                           comp_avail[b], out + b * out_stride, dest_len, ring,
                           q, &len, &src_read[b], &err[b]);
}
void host_compress(const uint8_t* src, long long src_stride,
                   const int32_t* src_lens, uint8_t* dst, long long dst_stride,
                   int dest_cap, int32_t* out_lens, int32_t* err, int n) {
  HostTeam t;
  std::vector<uint32_t> table(LZ4TT_TABLE_BYTES / 4);
  for (int b = 0; b < n; b++)
    lz4tt_compress_block(t, src + b * src_stride, src_lens[b],
                         dst + b * dst_stride, dest_cap, dst_stride,
                         table.data(), &out_lens[b], &err[b]);
}
// The hashes as a CTA of K3 or K4 computes them when it takes `rows` rows:
// each row's whole stripes in stages of lz4tt_xxh_seg(rows) bytes, each
// stage copied into an aligned buffer and every lane absorbed from it by
// the stage body, then the row's finish.
void host_xxh32(const uint8_t* data, long long stride, const int32_t* lens,
                unsigned seed, uint32_t* out, int n, int rows) {
  for (int b = 0; b < n; b++) {
    uint32_t v[4];
    for (int k = 0; k < 4; k++) v[k] = lz4tt_xxh32_lane_init(seed, k);
    host_stages<16>(data + b * stride, lens[b] / 16, lz4tt_xxh_seg(rows) / 16, v,
                    lz4tt_xxh32_stage_lane);
    out[b] = lz4tt_xxh32_finish(v, data + b * stride, lens[b], seed);
  }
}
void host_xxh64(const uint8_t* data, long long stride, const int32_t* lens,
                unsigned long long seed, uint64_t* out, int n, int rows) {
  for (int b = 0; b < n; b++) {
    uint64_t v[4];
    for (int k = 0; k < 4; k++) v[k] = lz4tt_xxh64_lane_init(seed, k);
    host_stages<32>(data + b * stride, lens[b] / 32, lz4tt_xxh_seg(rows) / 32, v,
                    lz4tt_xxh64_stage_lane);
    out[b] = lz4tt_xxh64_finish(v, data + b * stride, lens[b], seed);
  }
}
// rows a CTA takes in a launch of n rows when `slots` CTAs fit at once
int host_xxh_rows(long long n, long long slots) { return lz4tt_xxh_rows(n, slots); }
// the parse kernel's body, one block after the other, by a team of `lanes`
// (1: one lane; else host threads); returns -1 if the lanes disagree
int host_parse(const uint8_t* comp, long long comp_stride,
               const int32_t* comp_lens, int max_seq, int32_t* tables,
               int32_t* n_seq, int32_t* out_total, int n, int lanes) {
  alignas(16) static uint8_t win[LZ4TT_PARSE_WIN];
  const TeamBatch x = {comp,    comp_stride, comp_lens, nullptr, 0,
                       nullptr, nullptr,     nullptr,   max_seq, tables,
                       n_seq,   out_total,   n,         win};
  if (lanes > 1) return host_team(x, lanes, parse_lane);
  for (int b = 0; b < n; b++) parse_row(HostTeam(), x, b, &n_seq[b], &out_total[b]);
  return 0;
}
// the sentinel tails of OK rows, as the parse kernel writes them after
// the body when its tail is not 0
void host_parse_sentinel(int32_t* tables, const int32_t* n_seq, int max_seq,
                         int n, int tail) {
  for (int b = 0; b < n; b++)
    lz4tt_parse_sentinel(HostTeam(), lz4tt_seq_row(tables, n, max_seq, b),
                         n_seq[b], max_seq, tail);
}
// the parser's reads outside its window since the last call
int host_window_faults() { return __atomic_exchange_n(&window_faults, 0, __ATOMIC_RELAXED); }
// the pack kernel's body, one block after the other, by a team of `lanes`
void host_pack(const uint8_t* src, long long src_stride, const int32_t* lens,
               const uint8_t* comp, long long comp_stride,
               const int32_t* comp_lens, const int32_t* offs, uint8_t* body,
               int n, int lanes) {
  const TeamBatch x = {src,  src_stride, lens, comp,    comp_stride,
                       comp_lens, offs, body, 0, nullptr, nullptr, nullptr,
                       n,    nullptr};
  if (lanes > 1) {
    host_team(x, lanes, pack_lane);
    return;
  }
  for (int b = 0; b < n; b++) pack_row(HostTeam(), x, b);
}
// K5's body, one block after the other, by a one-lane team
void host_segment(const uint8_t* comp, long long comp_stride,
                  const int32_t* comp_lens, const int32_t* n_seq,
                  const int32_t* tables, int max_seq, uint8_t* out,
                  long long out_stride, int out_max, int32_t* err, int n) {
  HostTeam t;
  alignas(16) uint8_t ring[LZ4TT_RING];
  Lz4ttCopies q;
  for (int b = 0; b < n; b++)
    err[b] = lz4tt_segment_block(t, comp + b * comp_stride, comp_lens[b],
                                 lz4tt_seq_tables(tables, n, max_seq, b),
                                 n_seq[b], max_seq, out + b * out_stride,
                                 out_max, ring, q);
}
// the decode ring's size (k = 0) and the farthest match it serves (k = 1)
int host_ring(int k) { return k ? (int)LZ4TT_RING_NEAR : (int)LZ4TT_RING; }
// the streaming updates as their kernels run them: one row, stage by stage
// (the whole stage), the lanes carried
void host_xxh32_stream(const uint8_t* data, long long n_stripes,
                       uint32_t* lanes) {
  host_stages<16>(data, n_stripes, lz4tt_xxh_seg(1) / 16, lanes,
                  lz4tt_xxh32_stage_lane);
}
void host_xxh64_stream(const uint8_t* data, long long n_stripes,
                       uint64_t* lanes) {
  host_stages<32>(data, n_stripes, lz4tt_xxh_seg(1) / 32, lanes,
                  lz4tt_xxh64_stage_lane);
}
int host_xxh32_stage_bytes() { return LZ4TT_XXH_STAGE; }
// K6's body at `level`, one block after the other in the one team's
// tables of `scratch` (never cleared here), by a team of `lanes` (1: one
// lane; else host threads); returns -1 if the lanes disagree on a block
int host_hc(const uint8_t* src, long long src_stride, const int32_t* src_lens,
            uint8_t* dst, long long dst_stride, int dest_cap, int level,
            uint8_t* scratch, int32_t* out_lens, int32_t* err, int n,
            int lanes) {
  const int32_t attempts = 1 << (level - 1);
  uint32_t counts[LZ4TT_HC_COUNTS];
  if (lanes == 1) {
    HostTeam t;
    for (int b = 0; b < n; b++)
      lz4tt_hc_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,
                     dest_cap, dst_stride, attempts, scratch, counts,
                     &out_lens[b], &err[b]);
    return 0;
  }
  ThreadTeamShared sh;
  pthread_barrier_init(&sh.bar, nullptr, lanes);
  int rc = 0;
  for (int b = 0; b < n && rc == 0; b++) {
    HcJob job = {src + b * src_stride, src_lens[b], dst + b * dst_stride,
                 dest_cap, dst_stride, attempts, scratch, counts, &sh, lanes,
                 {}, {}};
    pthread_t th[32];
    HcLane ls[32];
    for (int i = 0; i < lanes; i++) {
      ls[i] = {&job, i};
      pthread_create(&th[i], nullptr, hc_lane, &ls[i]);
    }
    for (int i = 0; i < lanes; i++) pthread_join(th[i], nullptr);
    out_lens[b] = job.out_len[0];
    err[b] = job.err[0];
    for (int i = 1; i < lanes; i++)
      if (job.out_len[i] != job.out_len[0] || job.err[i] != job.err[0]) rc = -1;
  }
  pthread_barrier_destroy(&sh.bar);
  return rc;
}
int host_hc_team_bytes() { return LZ4TT_HC_TEAM_BYTES; }
// K1's body with a history a row (row b's: the hist_lens[b] bytes that end
// at hist_end + b * hist_stride), one block after the other, by a team of
// `lanes` (1: one lane; else host threads); returns -1 if the lanes
// disagree on a block
int host_decode_hist(const uint8_t* comp, long long comp_stride,
                     const int32_t* comp_lens, uint8_t* out,
                     long long out_stride, int out_max, const uint8_t* hist_end,
                     long long hist_stride, const int32_t* hist_lens,
                     int32_t* out_lens, int32_t* err, int n, int lanes) {
  alignas(16) static uint8_t ring[LZ4TT_RING];
  static Lz4ttCopies q;
  int rc = 0;
  for (int b = 0; b < n; b++) {
    const Lz4ttHist h = {hist_end + b * hist_stride, hist_lens[b]};
    int32_t len[32], read[32], e[32];
    auto body = [&](const auto& t) {
      lz4tt_decode_row<false, true>(t, comp + b * comp_stride, comp_stride,
                                    comp_lens[b], out + b * out_stride,
                                    out_max, ring, q, &len[t.lane()],
                                    &read[t.lane()], &e[t.lane()], h);
    };
    if (lanes == 1)
      body(HostTeam());
    else
      run_team(lanes, body);
    out_lens[b] = len[0];
    err[b] = e[0];
    for (int i = 1; i < lanes; i++)
      if (len[i] != len[0] || e[i] != e[0]) rc = -1;
  }
  return rc;
}
// K1's safe body with each row's whole output in its scratch (the ring the
// CTA-a-row kernel keeps in shared memory, poisoned before every row), one
// block after the other, by a team of `lanes` (1: one lane; else host
// threads); returns -1 if the lanes disagree on a block
int host_decode_whole(const uint8_t* comp, long long comp_stride,
                      const int32_t* comp_lens, uint8_t* out,
                      long long out_stride, int out_max, int32_t* out_lens,
                      int32_t* err, int n, int lanes) {
  alignas(16) static uint8_t ring[LZ4TT_WHOLE];
  static Lz4ttCopies q;
  int rc = 0;
  for (int b = 0; b < n; b++) {
    memset(ring, 0x5A, sizeof ring);
    int32_t len[32], read[32], e[32];
    auto body = [&](const auto& t) {
      lz4tt_decode_row<false, false, Lz4ttWhole>(
          t, comp + b * comp_stride, comp_stride, comp_lens[b],
          out + b * out_stride, out_max, ring, q, &len[t.lane()],
          &read[t.lane()], &e[t.lane()]);
    };
    if (lanes == 1)
      body(HostTeam());
    else
      run_team(lanes, body);
    out_lens[b] = len[0];
    err[b] = e[0];
    for (int i = 1; i < lanes; i++)
      if (len[i] != len[0] || e[i] != e[0]) rc = -1;
  }
  return rc;
}
int host_whole() { return LZ4TT_WHOLE; }
}  // extern "C"
// The split decode's pipe on the host: a semaphore a signal and slot; a
// team's leader waits or posts, its barrier holds the rest.
struct HostPipeState {
  pthread_mutex_t mu;
  pthread_cond_t cv;
  int full[LZ4TT_SLOTS], empty[LZ4TT_SLOTS];
};
struct HostPipe {
  HostPipeState* st;
  template <class T>
  void wait(const T& t, int* c) const {
    if (t.leader()) {
      pthread_mutex_lock(&st->mu);
      while (*c == 0) pthread_cond_wait(&st->cv, &st->mu);
      (*c)--;
      pthread_mutex_unlock(&st->mu);
    }
    t.sync();
  }
  template <class T>
  void post(const T& t, int* c) const {
    t.sync();
    if (t.leader()) {
      pthread_mutex_lock(&st->mu);
      (*c)++;
      pthread_cond_broadcast(&st->cv);
      pthread_mutex_unlock(&st->mu);
    }
  }
  template <class T> void wait_empty(const T& t, int s) const { wait(t, &st->empty[s]); }
  template <class T> void fill(const T& t, int s) const { post(t, &st->full[s]); }
  template <class T> void wait_full(const T& t, int s) const { wait(t, &st->full[s]); }
  template <class T> void empty(const T& t, int s) const { post(t, &st->empty[s]); }
};
extern "C" {
// The CTA-a-row kernel's body (lz4tt_split_row), one block after the
// other: the walker a host thread of its own, the copier a team of `lanes`
// (1: one lane; else host threads) beside it, the ring poisoned before
// every row; returns -1 if the copier's lanes disagree on a block or a
// signal is left over
int host_decode_split(const uint8_t* comp, long long comp_stride,
                      const int32_t* comp_lens, uint8_t* out,
                      long long out_stride, int out_max, int32_t* out_lens,
                      int32_t* err, int n, int lanes) {
  alignas(16) static uint8_t ring[LZ4TT_WHOLE];
  static Lz4ttSlot slots[LZ4TT_SLOTS];
  HostPipeState st = {};
  pthread_mutex_init(&st.mu, nullptr);
  pthread_cond_init(&st.cv, nullptr);
  const HostPipe p = {&st};
  int rc = 0;
  for (int b = 0; b < n; b++) {
    memset(ring, 0x5A, sizeof ring);
    int32_t len[32], e[32];
    auto row = [&](const auto& t, bool walker) {
      lz4tt_split_row(t, walker, p, comp + b * comp_stride, comp_stride,
                      comp_lens[b], out + b * out_stride, out_max, ring, slots,
                      &len[t.lane()], &e[t.lane()]);
    };
    pthread_t walker;
    auto walk = [&] { row(HostTeam(), true); };
    pthread_create(&walker, nullptr, [](void* f) -> void* {
      (*(decltype(walk)*)f)();
      return nullptr;
    }, &walk);
    if (lanes == 1)
      row(HostTeam(), false);
    else
      run_team(lanes, [&](const auto& t) { row(t, false); });
    pthread_join(walker, nullptr);
    out_lens[b] = len[0];
    err[b] = e[0];
    for (int i = 1; i < lanes; i++)
      if (len[i] != len[0] || e[i] != e[0]) rc = -1;
    for (int s = 0; s < LZ4TT_SLOTS; s++)
      if (st.full[s] || st.empty[s]) rc = -1;
  }
  pthread_mutex_destroy(&st.mu);
  pthread_cond_destroy(&st.cv);
  return rc;
}
// K2's body with a dictionary a row (row b's: the dict_lens[b] bytes that
// end at dict_end + b * dict_stride), as host_decode_hist runs K1's
int host_compress_dict(const uint8_t* src, long long src_stride,
                       const int32_t* src_lens, const uint8_t* dict_end,
                       long long dict_stride, const int32_t* dict_lens,
                       uint8_t* dst, long long dst_stride, int dest_cap,
                       int32_t* out_lens, int32_t* err, int n, int lanes) {
  std::vector<uint32_t> table(LZ4TT_TABLE_BYTES / 4);
  int rc = 0;
  for (int b = 0; b < n; b++) {
    int32_t len[32], e[32];
    auto body = [&](const auto& t) {
      lz4tt_compress_dict_block(t, src + b * src_stride, src_lens[b],
                                dict_end + b * dict_stride, dict_lens[b],
                                dst + b * dst_stride, dest_cap, dst_stride,
                                table.data(), &len[t.lane()], &e[t.lane()]);
    };
    if (lanes == 1)
      body(HostTeam());
    else
      run_team(lanes, body);
    out_lens[b] = len[0];
    err[b] = e[0];
    for (int i = 1; i < lanes; i++)
      if (len[i] != len[0] || e[i] != e[0]) rc = -1;
  }
  return rc;
}
long long host_hc_followed() { return hc_followed; }
int host_hc_copy_faults() { return hc_copy_faults; }
int host_hc_spec_attempts() { return LZ4TT_HC_SPEC_ATTEMPTS; }
// K5's body, one block after the other, by a team of `lanes` threads;
// returns -1 if the lanes disagree on a block's code
int host_segment_team(const uint8_t* comp, long long comp_stride,
                      const int32_t* comp_lens, const int32_t* n_seq,
                      const int32_t* tables, int max_seq, uint8_t* out,
                      long long out_stride, int out_max, int32_t* err, int n,
                      int lanes) {
  ThreadTeamShared sh;
  pthread_barrier_init(&sh.bar, nullptr, lanes);
  alignas(16) static uint8_t ring[LZ4TT_RING];
  Lz4ttCopies q;
  for (int b = 0; b < n; b++) {
    SegmentJob job = {comp + b * comp_stride, comp_lens[b], n_seq[b], max_seq,
                      out_max, lz4tt_seq_tables(tables, n, max_seq, b),
                      out + b * out_stride, ring, &q, &sh, lanes, {}};
    pthread_t th[32];
    SegmentLane ls[32];
    for (int i = 0; i < lanes; i++) {
      ls[i] = {&job, i};
      pthread_create(&th[i], nullptr, segment_lane, &ls[i]);
    }
    for (int i = 0; i < lanes; i++) pthread_join(th[i], nullptr);
    err[b] = job.err[0];
    for (int i = 1; i < lanes; i++)
      if (job.err[i] != job.err[0]) return -1;
  }
  pthread_barrier_destroy(&sh.bar);
  return 0;
}
// K7's bodies on each block, one after the other: part 1 on each of its
// windows of wl positions (last first, each a team of `lanes`: 1,
// Lz4ttBlockSerial; else host threads) in one team's scratch and one
// store a window (all poisoned first, never cleared), part 2 on the row,
// part 3 on each window, walks of at most walk_limit steps
int host_parallel(const uint8_t* src, long long src_stride,
                  const int32_t* src_lens, uint8_t* dst, long long dst_stride,
                  int cap, long long width, int32_t* out_lens, int n,
                  int lanes, int wl, int walk_limit) {
  const int64_t span = lz4tt_pc_span(width, wl);
  const int64_t groups = lz4tt_pc_groups(width, wl);
  const int64_t ww = lz4tt_pc_window_words(width, wl);
  std::vector<int32_t> scratch(lz4tt_pc_team_words(width, wl), 0x5A5A5A5A);
  std::vector<uint16_t> mlen(lz4tt_pc_mlen_len(wl), 0x5A5A);
  std::vector<int32_t> stores(lz4tt_pc_windows(width, wl) * ww, 0x5A5A5A5A);
  int32_t row[LZ4TT_PC_ROW_WORDS], queue = 0;
  for (int b = 0; b < n; b++) {
    const uint8_t* x = src + b * src_stride;
    const int32_t len = src_lens[b];
    const int32_t nw = lz4tt_pc_windows(len, wl);
    auto each = [&](auto body) {
      for (int32_t w = nw - 1; w >= 0; w--) {
        auto on = [&](const auto& t) { body(t, w); };
        if (lanes == 1)
          on(Lz4ttBlockSerial());
        else
          run_team(lanes, on);
      }
    };
    each([&](const auto& t, int32_t w) {
      lz4tt_pc_window(t, x, len, w, wl, walk_limit, scratch.data(), span,
                      groups, mlen.data(), stores.data() + w * ww);
    });
    out_lens[b] = lz4tt_pc_row(len, wl, cap, stores.data(), ww, groups, row);
    each([&](const auto& t, int32_t w) {
      lz4tt_pc_emit_window(t, x, len, w, wl, stores.data() + w * ww, groups,
                           row, dst + b * dst_stride, cap, scratch.data(),
                           span, &queue);
    });
  }
  return 0;
}
// K8's body, one block after the other in one team's scratch (poisoned
// first), by a team of `lanes` as host_parallel runs K7's
void host_gather(const uint8_t* comp, long long comp_stride, int cmax,
                 const int32_t* lit_out, const int32_t* lit_src,
                 const int32_t* lit_len, const int32_t* m_out,
                 const int32_t* m_dist, const int32_t* m_len, int max_seq,
                 uint8_t* out, long long out_stride, int out_len,
                 int max_depth, int n, int lanes) {
  std::vector<int32_t> scratch(lz4tt_gd_team_words(out_len, max_seq),
                               0x5A5A5A5A);
  int32_t counters[4] = {7, 7, 7, 7};
  for (int b = 0; b < n; b++) {
    const long long o = (long long)b * max_seq;
    const Lz4ttGdTables s = {lit_out + o, lit_src + o, lit_len + o,
                             m_out + o,   m_dist + o,  m_len + o};
    auto body = [&](const auto& t) {
      lz4tt_gd_block(t, comp + b * comp_stride, cmax, s, max_seq,
                     out + b * out_stride, out_len, max_depth, scratch.data(),
                     counters);
    };
    if (lanes == 1)
      body(Lz4ttBlockSerial());
    else
      run_team(lanes, body);
  }
}
// the rounds K8 runs at most, and whether in place
int host_gd_rounds(int out_len, int max_depth) {
  return lz4tt_gd_in_place(out_len, max_depth) ? lz4tt_gd_rounds(out_len)
                                               : -max_depth;
}
int host_gd_used(const int32_t* lit_out, int max_seq) {
  return lz4tt_gd_used(lit_out, max_seq);
}
// the LZ4Block pack kernel's body: block b by a team of `lanes` at offs[b],
// its header's check checks[b]; the end block at end_at
void host_lz4block_pack(const uint8_t* src, long long src_stride,
                        const int32_t* lens, const uint8_t* comp,
                        long long comp_stride, const int32_t* comp_lens,
                        const int32_t* offs, const uint32_t* checks, int level,
                        uint8_t* body, int end_at, int n, int lanes) {
  for (int b = 0; b <= n; b++) {
    auto body_of = [&](const auto& t) {
      if (b == n) {
        lz4tt_lz4block_end(t, level, body + end_at);
        return;
      }
      lz4tt_pack_payload(t, Lz4ttBlockHeader{level, checks[b]},
                         src + b * src_stride, lens[b], comp + b * comp_stride,
                         comp_lens[b], body + offs[b]);
    };
    if (lanes == 1)
      body_of(HostTeam());
    else
      run_team(lanes, body_of);
  }
}
// the reader's walk from pos (the index's records), and its end
int host_lz4block_walk(const uint8_t* s, long long len, long long pos,
                       int stop, int max_blocks, int32_t* table,
                       long long* end) {
  int64_t e = 0;
  const int k = lz4tt_lz4block_walk(s, len, pos, stop, 0, max_blocks, table,
                                    max_blocks, &e);
  *end = e;
  return k;
}
// the mark's test of 16 positions, chunk by chunk: hits[c] for the 16
// positions of s[16 c, 16 c + 16), s zero past len
void host_lz4block_hits(const uint8_t* s, long long len, uint32_t* hits,
                        int n_chunks) {
  for (int c = 0; c < n_chunks; c++) {
    uint32_t w[6];
    for (int k = 0; k < 6; k++) {
      uint32_t x = 0;
      for (int i = 0; i < 4; i++) {
        const long long p = 16LL * c + 4 * k + i;
        if (p < len) x |= (uint32_t)s[p] << (8 * i);
      }
      w[k] = x;
    }
    hits[c] = lz4tt_lz4block_hits(w);
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
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "harness.cpp").write_text(HARNESS)
    res = subprocess.run(
        [gxx, "-std=c++17", "-O2", "-shared", "-fPIC", "-pthread", "-Wall",
         "-Werror",
         "-Wno-unknown-pragmas", "-I", str(build.CSRC), "-o",
         str(out / "libhost.so"), str(out / "harness.cpp")],
        capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    lib = ctypes.CDLL(str(out / "libhost.so"))
    lib.host_decode.argtypes = [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32]
    lib.host_decode_fast.argtypes = lib.host_decode.argtypes
    lib.host_compress.argtypes = [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32]
    lib.host_xxh32.argtypes = [_P, _I64, _P, ctypes.c_uint, _P, _I32, _I32]
    lib.host_xxh64.argtypes = [_P, _I64, _P, ctypes.c_ulonglong, _P, _I32,
                               _I32]
    lib.host_xxh_rows.argtypes = [_I64, _I64]
    lib.host_parse.argtypes = [_P, _I64, _P, _I32, _P, _P, _P, _I32, _I32]
    lib.host_pack.argtypes = [_P, _I64, _P, _P, _I64, _P, _P, _P, _I32, _I32]
    lib.host_segment.argtypes = [_P, _I64, _P, _P, _P, _I32, _P, _I64, _I32,
                                 _P, _I32]
    lib.host_segment_team.argtypes = lib.host_segment.argtypes + [_I32]
    lib.host_ring.argtypes = [_I32]
    lib.host_xxh32_stream.argtypes = [_P, _I64, _P]
    lib.host_xxh64_stream.argtypes = [_P, _I64, _P]
    lib.host_hc.argtypes = [_P, _I64, _P, _P, _I64, _I32, _I32, _P, _P, _P,
                            _I32, _I32]
    lib.host_decode_hist.argtypes = [_P, _I64, _P, _P, _I64, _I32, _P, _I64,
                                     _P, _P, _P, _I32, _I32]
    lib.host_decode_whole.argtypes = [_P, _I64, _P, _P, _I64, _I32, _P, _P,
                                      _I32, _I32]
    lib.host_decode_split.argtypes = lib.host_decode_whole.argtypes
    lib.host_compress_dict.argtypes = [_P, _I64, _P, _P, _I64, _P, _P, _I64,
                                       _I32, _P, _P, _I32, _I32]
    lib.host_parse_sentinel.argtypes = [_P, _P, _I32, _I32, _I32]
    lib.host_parallel.argtypes = [_P, _I64, _P, _P, _I64, _I32, _I64, _P,
                                  _I32, _I32, _I32, _I32]
    lib.host_gd_rounds.argtypes = [_I32, _I32]
    lib.host_gather.argtypes = [_P, _I64, _I32] + [_P] * 6 + [
        _I32, _P, _I64, _I32, _I32, _I32, _I32]
    lib.host_gd_used.argtypes = [_P, _I32]
    lib.host_lz4block_pack.argtypes = [_P, _I64, _P, _P, _I64, _P, _P, _P,
                                       _I32, _P, _I32, _I32, _I32]
    lib.host_lz4block_walk.argtypes = [_P, _I64, _I64, _I32, _I32, _P, _P]
    lib.host_lz4block_hits.argtypes = [_P, _I64, _P, _I32]
    lib.host_hc_followed.restype = ctypes.c_longlong
    lib.host_hc_spec_attempts.restype = ctypes.c_int
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


@pytest.mark.parametrize("size", [65535, 65536, 65546, 65547])
def test_host_compress_table_edges(lib, size):
    """The 16-bit table up to its largest block (65,546 B) and the first
    12-bit block (65,547 B), on the main path's three kinds of data
    (``make_blocks``: random, a4, text, a4), whole rows against the plain
    version and the reference."""
    rows = sharded.make_blocks(4, 65547, 5)[:, :size]
    src, lens = layout.to_device_layout([r.tobytes() for r in rows],
                                        device="cpu")
    cap = max_compressed_length(size)
    host = _host_codec(lib.host_compress, src, lens, layout.row_stride(cap),
                       cap)
    plain = codec.compress_fast_batch(src, lens, cap)
    _assert_same(host, plain)
    assert torch.equal(host[0], plain[0])
    assert host[2].tolist() == [codec.OK] * 4
    assert host[1][0] > size > max(host[1][1:].tolist())


@pytest.mark.parametrize("fast", [False, True], ids=["safe", "fast"])
@pytest.mark.parametrize("case", testing.SHORT_CASES)
def test_host_decode_short_sequences(lib, case, fast):
    """Hand-built blocks through both contracts of the decode body, against
    the plain version and the expected bytes, with a guard region behind
    every row (rows misaligned by the guard's width)."""
    rng = np.random.default_rng(len(case))
    assert (lib.host_ring(0), lib.host_ring(1)) == (testing.RING,
                                                    testing.RING_NEAR)
    blocks = testing.short_sequence_blocks(case, rng)
    comp = [testing.encode_block(*b) for b in blocks]
    want = [testing.expand_block(*b) for b in blocks]
    c, cl = layout.to_device_layout(comp, device="cpu")
    out_max = max(map(len, want))
    if not fast:
        guard = torch.full((len(comp), out_max + 37), 0xA5, dtype=torch.uint8)
        host = _host_codec(lib.host_decode, c, cl, None, out_max, out=guard)
        _assert_same(host, codec.decompress_safe_plain(c, cl, out_max))
        assert host[1].tolist() == [len(w) for w in want]
        got = layout.from_device_layout(guard, host[1])
        assert bool((guard[:, out_max:] == 0xA5).all())
    else:
        got = []
        for i, w in enumerate(want):
            guard = torch.full((1, len(w) + 37), 0xA5, dtype=torch.uint8)
            host = _host_codec(lib.host_decode_fast, c[i:i + 1], cl[i:i + 1],
                               None, len(w), out=guard)
            plain = codec.decompress_fast_plain(c[i:i + 1], cl[i:i + 1],
                                                len(w))
            _assert_same(host, plain, out_len=len(w))
            assert host[1].tolist() == [len(comp[i])]
            assert bool((guard[:, len(w):] == 0xA5).all())
            got.append(guard[0, :len(w)].numpy().tobytes())
    assert host[2].tolist() == [codec.OK] * host[2].numel()
    assert got == want


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
                   len(sizes), 1)
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


# --- K1 with each row's whole output in its scratch -------------------------

# "split": the CTA-a-row kernel's body (lz4tt_split_row: a walker, and a
# copier team behind it); "whole": K1's one-team body with a whole ring
WHOLE_BODIES = ("split", "whole")


def _host_whole(lib, body: str = "split", lanes: int = 1):
    """K1's safe body with each row's whole output in its scratch (one of
    ``WHOLE_BODIES``), called as :func:`_host_codec` calls a body; the
    lanes must agree on every block."""
    fn = lib.host_decode_split if body == "split" else lib.host_decode_whole

    def call(*args):
        assert fn(*args, lanes) == 0
    return call


def _whole_vs_plain(lib, c, cl, out_max, body="split", lanes=1,
                    guard_width=37):
    """A whole-output body and the plain version on rows of ``out_max`` +
    ``guard_width`` bytes of 0xA5: codes, lengths of OK rows, and every
    byte of every row alike (errors' decoded prefixes too); nothing
    written at or past ``out_max``. Returns the body's result."""
    assert lib.host_whole() == testing.WHOLE
    n = c.shape[0]
    guard = torch.full((n, out_max + guard_width), 0xA5, dtype=torch.uint8)
    host = _host_codec(_host_whole(lib, body, lanes), c, cl, None, out_max,
                       out=guard)
    plain = codec.decompress_safe_plain(c, cl, out_max,
                                        out=torch.full_like(guard, 0xA5))
    _assert_same(host, plain, all_lens=False)
    assert torch.equal(guard, plain[0])
    assert bool((guard[:, out_max:] == 0xA5).all())
    return host


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("body", WHOLE_BODIES)
@pytest.mark.parametrize("case", testing.SHORT_CASES + ("far",))
def test_host_decode_whole_short_sequences(lib, case, body, lanes):
    """The CTA-a-row kernel's body (the walk decoupled from the copies,
    the copier a team of 1 or 32 host threads) and K1's one-team body with
    the whole output in its scratch (at most 64 KiB), on the hand-built
    blocks of the warp body's cases
    (periods 1-40, null offsets, runs about 16, 32 and 64, the ring's
    edge) and of ``far_match_blocks`` (matches 3,071-3,073, 4,095-4,097,
    32,768 and up to 65,527 bytes back): against the plain version byte
    for byte, the warp body and the
    expected bytes; a block past 64 KiB fails alike on all three."""
    rng = np.random.default_rng(len(case))
    blocks = (testing.far_match_blocks(rng) if case == "far"
              else testing.short_sequence_blocks(case, rng))
    comp = [testing.encode_block(*b) for b in blocks]
    want = [testing.expand_block(*b) for b in blocks]
    c, cl = layout.to_device_layout(comp, device="cpu")
    out_max = min(max(map(len, want)), testing.WHOLE)
    host = _whole_vs_plain(lib, c, cl, out_max, body, lanes)
    warp = _host_codec(lib.host_decode, c, cl, None, out_max,
                       out=torch.full_like(host[0], 0xA5))
    assert host[2].tolist() == warp[2].tolist()
    assert torch.equal(host[0], warp[0])
    fits = [len(w) <= out_max for w in want]
    assert [e == codec.OK for e in host[2].tolist()] == fits
    assert sum(fits) >= len(want) - 1
    assert [host[0][i, :len(w)].numpy().tobytes()
            for i, w in enumerate(want) if fits[i]] == \
        [w for w, f in zip(want, fits) if f]


@pytest.mark.parametrize("body", WHOLE_BODIES)
@pytest.mark.parametrize("out_max", [0, 1, 4096, 65535, 65536])
def test_host_decode_whole_matches_plain(lib, edge_batch, out_max, body):
    """Both whole-output bodies on K2's output of the edge blocks (0 to
    70,000 bytes) and their fuzz, at capacities from none to the 64 KiB
    they hold, every row misaligned by the guard behind it: byte for byte
    the plain version's."""
    blocks, (src, lens) = edge_batch
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    batch = comp_blocks + testing.fuzz_blocks(
        np.random.default_rng(out_max + 7), comp_blocks, 128)
    c, cl = layout.to_device_layout(batch, device="cpu")
    host = _whole_vs_plain(lib, c, cl, out_max, body, guard_width=64)
    fits = [i for i, b in enumerate(blocks) if len(b) <= out_max]
    assert host[2][fits].tolist() == [codec.OK] * len(fits)


@pytest.mark.parametrize("seed", [0, (1 << 64) - 1, 0xCAFEBABE12345678])
def test_host_xxh64_matches_plain(lib, seed):
    rng = np.random.default_rng(seed & 0xFF)
    sizes = list(range(101)) + [1000, 65536]
    data, lens = layout.to_device_layout(
        [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes],
        device="cpu")
    out = torch.zeros((len(sizes),), dtype=torch.int64)
    lib.host_xxh64(_ptr(data), data.stride(0), _ptr(lens), seed, _ptr(out),
                   len(sizes), 1)
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


def _host_parse(lib, c, cl, max_seq, lanes=1, shift=0, sentinel=False):
    """The parser's body by a team of ``lanes`` into tables, counts and
    totals filled with 0x5A5A5A5A first: the body writes every entry.
    With ``shift`` the rows start that many bytes past a 16-byte
    boundary; with ``sentinel``, then the sentinel tails."""
    n = c.shape[0]
    if shift:
        wide = torch.zeros((n, c.shape[1] + 16), dtype=torch.uint8)
        wide[:, shift:shift + c.shape[1]] = c
        c = wide[:, shift:]
    tables = torch.full((6, n, max_seq), 0x5A5A5A5A, dtype=torch.int32)
    n_seq = torch.full((n,), 0x5A5A5A5A, dtype=torch.int32)
    total = torch.full((n,), 0x5A5A5A5A, dtype=torch.int32)
    lib.host_window_faults()
    assert lib.host_parse(_ptr(c), c.stride(0), _ptr(cl), max_seq,
                          _ptr(tables), _ptr(n_seq), _ptr(total), n,
                          lanes) == 0
    assert lib.host_window_faults() == 0
    if sentinel:
        lib.host_parse_sentinel(_ptr(tables), _ptr(n_seq), max_seq, n,
                                sequences.SENTINEL)
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


@functools.cache
def _text_rows():
    """K2's plain output of the text blocks of ``make_blocks(8, 65536,
    3)``."""
    src, lens = sharded.upload_blocks(sharded.make_blocks(8, 65536, 3),
                                      torch.device("cpu"))
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(65536))
    kinds = sharded.block_kinds(8, 3)
    return [r for r, k in zip(layout.from_device_layout(comp, comp_lens),
                              kinds) if k == 1]


@pytest.mark.parametrize("lanes, shift", [(1, 5), (8, 5), (32, 0)])
def test_host_parse_team_matches_plain(lib, lanes, shift):
    """The parser body by one lane and by a team of 8 or 32 host threads
    (its ballots, scan, runs of 3-byte sequences, chains of short ones and
    window refills) on K2 output, periods 1-15, the boundary blocks,
    fuzz and text blocks (``make_blocks``' phrases), with rows aligned
    and 5 bytes past a 16-byte boundary, against the plain version with
    the default width and one narrow enough to give ``-3``."""
    c, cl = _comp_batch(7, 48)
    c, cl = layout.to_device_layout(
        layout.from_device_layout(c, cl) + _text_rows(), device="cpu")
    for max_seq in (None, 40):
        want = sequences.parse_plain(c, cl, max_seq)
        got = _host_parse(lib, c, cl, want[0].shape[2], lanes, shift)
        for g, w in zip(got, want):
            assert torch.equal(g, w), max_seq


@pytest.mark.parametrize("lanes", [1, 8, 32])
def test_host_parse_run_edges(lib, lanes):
    """The parser body at the edges of its runs and chains, by one lane
    and by teams of 8 and 32 host threads, against the plain version: a
    malformed offset inside a run or a chain (the sequence keeps its
    literal entries, and the zeros start after them), runs and chains
    that end exactly at the block end, widths of 1, 2, 31, 32 and 33
    sequences inside a run (``-3``), and the widths that just fit or miss
    a block of 102 sequences."""
    c, cl = layout.to_device_layout(testing.run_blocks(), device="cpu")
    for max_seq in (None, 1, 2, 31, 32, 33, 101, 102):
        want = sequences.parse_plain(c, cl, max_seq)
        got = _host_parse(lib, c, cl, want[0].shape[2], lanes)
        for g, w in zip(got, want):
            assert torch.equal(g, w), max_seq
        if max_seq is None:
            codes = got[1].tolist()
            bad = testing.RUN_MALFORMED
            assert codes[:bad] == [sequences.PARSE_MALFORMED] * bad
            assert min(codes[bad:]) > 0
            # the malformed offset's sequence keeps its literal entries
            assert testing.RUN_BAD_AT[3] == 32
            bad = 1 + 32
            assert got[0][2, 3, bad] == 0 and got[0][0, 3, bad] > 0
            assert got[0][3, 3, bad] == 0 and not got[0][:, 3, bad + 1:].any()
    assert got[1][-1] == 102   # under the last width, 102


@functools.cache
def _cap_blocks():
    """The boundary blocks, then match and literal length extensions one
    0xFF byte below and at the 0x7E000000 cap (about 8.3 MB of 0xFF
    each), in the layout, with the plain version's tables of width 4."""
    blocks = testing.boundary_blocks()
    blocks += [bytes([0x1F, 65, 1, 0]) + b"\xff" * k + bytes([0, 0])
               for k in (8_289_918, 8_289_919)]
    blocks += [bytes([0xF0]) + b"\xff" * k + bytes([0, 0])
               for k in (8_289_918, 8_289_919)]
    c, cl = layout.to_device_layout(blocks, device="cpu")
    return c, cl, sequences.parse_plain(c, cl, 4)


@pytest.mark.parametrize("lanes", [1, 32])
def test_host_parse_length_cap(lib, lanes):
    """The parser body on the boundary blocks and on length extensions
    below and at the cap, whose bytes run far past the window, by one
    lane and by 32 host threads, against the plain version."""
    c, cl, want = _cap_blocks()
    got = _host_parse(lib, c, cl, 4, lanes)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert got[1].tolist() == [2, 2, -2, -2, 2, -2, -2, -2]


def _pack_batch(rng, shift):
    """``testing.pack_cases`` as rows of random bytes, the source rows
    starting ``shift`` bytes into a wider buffer, so that they are
    misaligned too."""
    cases = testing.pack_cases()
    lens = torch.tensor([c[0] for c in cases], dtype=torch.int32)
    comp_lens = torch.tensor([c[1] for c in cases], dtype=torch.int32)
    n, width = len(cases), layout.row_stride(70000)
    raw = torch.from_numpy(rng.integers(0, 256, (n, width + 16),
                                        dtype=np.uint8))
    comp = torch.from_numpy(rng.integers(0, 256, (n, width), dtype=np.uint8))
    return raw[:, shift:shift + width], lens, comp, comp_lens


@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("shift", [0, 3])
def test_host_pack_matches_plain(lib, shift, lanes):
    """The pack body by one lane and by teams of 8 and 32 host threads,
    against ``frame_body_packed_plain``: each block at the offset the
    wrapper scans, spread by a 16-byte guard behind every block, which
    must stay as it was."""
    src, lens, comp, comp_lens = _pack_batch(np.random.default_rng(shift),
                                             shift)
    want, total = sharded.frame_body_packed_plain(src, lens, comp, comp_lens)
    use_raw = comp_lens >= lens
    emit = torch.where(lens > 0, torch.where(use_raw, lens, comp_lens) + 4, 0)
    offs = torch.cumsum(emit, 0) - emit
    spread = (torch.cumsum(emit + 16, 0) - emit - 16).to(torch.int32)
    assert {int(o + 4) % 16 for o in spread[:16]} == set(range(16))
    body = torch.full((int(spread[-1] + emit[-1]) + 16,), 0xA5,
                      dtype=torch.uint8)
    lib.host_pack(_ptr(src), src.stride(0), _ptr(lens), _ptr(comp),
                  comp.stride(0), _ptr(comp_lens), _ptr(spread), _ptr(body),
                  lens.numel(), lanes)
    expect = torch.full_like(body, 0xA5)
    for o, g, e in zip(offs.tolist(), spread.tolist(), emit.tolist()):
        expect[g:g + e] = want[o:o + e]
    assert int(offs[-1] + emit[-1]) == total
    assert torch.equal(body, expect)


def _host_segment(lib, c, cl, n_seq, tables, out_max, lanes=1):
    """K5's body by a team of ``lanes`` (1: one lane; else host threads)
    into rows of ``out_max`` bytes filled with 0x5A and a guard of 64
    bytes of 0xA5 behind each; returns (buffer, codes)."""
    guard = torch.full((c.shape[0], out_max + 64), 0xA5, dtype=torch.uint8)
    guard[:, :out_max] = 0x5A
    err = torch.zeros((c.shape[0],), dtype=torch.int32)
    args = (_ptr(c), c.stride(0), _ptr(cl), _ptr(n_seq), _ptr(tables),
            tables.shape[2], _ptr(guard), guard.stride(0), out_max, _ptr(err),
            c.shape[0])
    if lanes == 1:
        lib.host_segment(*args)
    else:
        assert lib.host_segment_team(*args, lanes) == 0
    assert bool((guard[:, out_max:] == 0xA5).all())
    return guard, err


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("out_max", [64, 1000, 70000])
def test_host_segment_matches_plain(lib, out_max, lanes):
    """K5's body on parsed tables and on corrupted ones (one row of each
    corruption, the out-of-order one included), against the plain
    version, with a guard region behind every row; by one lane and by a
    team of 8 host threads."""
    c, cl = _comp_batch(6, 64)
    tables, n_seq, _ = sequences.parse_plain(c, cl)
    bad = tables.clone()
    rows = torch.nonzero((n_seq > 1) & (cl < out_max)).flatten()
    rows = rows[:len(CORRUPTIONS)]
    for row, kind in zip(rows.tolist(), CORRUPTIONS):
        corrupt(bad, row, kind, int(cl[row]), out_max)
    for t in (tables, bad):
        got, err = _host_segment(lib, c, cl, n_seq, t, out_max, lanes)
        out, want_err = segment_decode.decompress_segments_plain(
            c, cl, n_seq, t, out_max)
        assert torch.equal(err, want_err)
        assert torch.equal(got[:, :out_max], out[:, :out_max])
    assert bool((want_err[rows] == codec.ERR_MALFORMED).all())
    assert not got[rows, :out_max].any()


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("case", testing.SHORT_CASES + ("boundary",))
def test_host_segment_short_sequences(lib, case, lanes):
    """K5's body on hand-built blocks for its lane copies, team copies and
    ring: overlap periods 1-40, dist around len, literal runs and matches
    of 63, 64 and 65 bytes, null-offset holes, matches at the ring's edge,
    and the boundary blocks (a null-offset hole, a match reaching the row
    start); rows longer than the blocks, so the zero tail is written too.
    By one lane and by 32 host threads, against the plain version and the
    expected bytes."""
    rng = np.random.default_rng(len(case) + 100)
    if case == "boundary":
        comp = testing.boundary_blocks()[:2]
        want = [b"*" + bytes(4) + b"*" * 8, b"AAAAABBBBB"]
    else:
        blocks = testing.short_sequence_blocks(case, rng)
        comp = [testing.encode_block(*b) for b in blocks]
        want = [testing.expand_block(*b) for b in blocks]
    c, cl = layout.to_device_layout(comp, device="cpu")
    tables, n_seq, total = sequences.parse_plain(c, cl)
    assert total.tolist() == [len(w) for w in want]
    out_max = max(map(len, want)) + 37
    got, err = _host_segment(lib, c, cl, n_seq, tables, out_max, lanes)
    out, want_err = segment_decode.decompress_segments_plain(
        c, cl, n_seq, tables, out_max)
    assert err.tolist() == want_err.tolist() == [codec.OK] * len(comp)
    assert torch.equal(got[:, :out_max], out[:, :out_max])
    assert [bytes(r[:out_max].numpy()) for r in got] == \
        [w + bytes(out_max - len(w)) for w in want]


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF, (1 << 64) - 1])
def test_host_stream_stripes_match_plain(lib, seed):
    """The streaming updates' bodies from a carried state, against the
    plain absorbs, stage by stage as their kernels run them, over updates
    of 1 stripe, one stage less one, one stage, one more, the ring less
    one, the ring, one more, and three stages and a part."""
    assert lib.host_xxh32_stage_bytes() == xxhash_stream.STAGE_BYTES
    rng = np.random.default_rng(seed & 0xFF)
    data = torch.from_numpy(rng.integers(
        0, 256, xxhash_stream.STAGE_BYTES * 4 + 32 * 517, dtype=np.uint8))
    s32 = xxhash_stream.StreamState32(seed, "cpu")
    s64 = xxhash_stream.StreamState64(seed, "cpu")
    lanes32 = s32.lanes.view(torch.int32).clone()
    lanes64 = s64.lanes.clone()
    for stripe, lanes, state, host, plain in (
            (16, lanes32, s32, lib.host_xxh32_stream,
             xxhash_stream.absorb32_plain),
            (32, lanes64, s64, lib.host_xxh64_stream,
             xxhash_stream.absorb64_plain)):
        stage = xxhash_stream.STAGE_BYTES // stripe
        for n in (1, stage - 1, stage, stage + 1, 4 * stage - 1, 4 * stage,
                  4 * stage + 1, 3 * stage + 517):
            host(_ptr(data), n, _ptr(lanes))
            plain(state.lanes, data[:stripe * n])
            got = lanes.view(torch.uint32) if stripe == 16 else lanes
            assert got.tolist() == state.lanes.tolist(), (stripe, n)


def _hash_batch(stripe):
    """Rows of the lengths the kernels' edges give: 0-100, 1000, one stage
    and the ring of a one-row CTA each +- one stripe, 65536, 65547."""
    st = xxhash_stream.STAGE_BYTES
    sizes = list(range(101)) + [1000, st - stripe, st, st + stripe,
                                4 * st - stripe, 4 * st, 4 * st + stripe,
                                65536, 65547]
    rng = np.random.default_rng(stripe)
    return layout.to_device_layout(
        [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in sizes],
        device="cpu")


_PLAIN = {}


def _plain_hashes(bits, seed):
    """The plain version's hashes of ``_hash_batch``, once per width and
    seed (the plain XXH64 takes seconds at these lengths)."""
    if (bits, seed) not in _PLAIN:
        data, lens = _hash_batch(bits // 2)
        fn = xxhash.xxh32_plain if bits == 32 else xxhash.xxh64_plain
        _PLAIN[bits, seed] = fn(data, lens, seed)
    return _PLAIN[bits, seed]


@pytest.mark.parametrize("rows", [1, 2, 3, 32])
@pytest.mark.parametrize("bits, seed", [(32, 0), (32, 0xFFFFFFFF),
                                        (64, (1 << 64) - 1),
                                        (64, 0xCAFEBABE12345678)])
def test_host_hash_rows_match_plain(lib, bits, seed, rows):
    """K3's and K4's bodies as a CTA of ``rows`` rows runs them (every
    lane's stage body over the row's share of each stage, then the row's
    finish), against the plain version, at the lengths around a stage and
    the ring."""
    data, lens = _hash_batch(bits // 2)
    n = lens.numel()
    if bits == 32:
        out = torch.zeros((n,), dtype=torch.int32)
        lib.host_xxh32(_ptr(data), data.stride(0), _ptr(lens), seed,
                       _ptr(out), n, rows)
        out = out.view(torch.uint32)
    else:
        out = torch.zeros((n,), dtype=torch.int64)
        lib.host_xxh64(_ptr(data), data.stride(0), _ptr(lens), seed,
                       _ptr(out), n, rows)
    assert out.tolist() == _plain_hashes(bits, seed).tolist()


@pytest.mark.parametrize("n, slots, rows", [(1, 132, 1), (132, 132, 1),
                                            (133, 132, 2), (4096, 132, 32),
                                            (10 ** 6, 132, 32), (5, 1, 5)])
def test_host_rows_a_cta(lib, n, slots, rows):
    """One CTA a row while every row fits on the card at once, then as
    many rows a CTA as spread them over it, at most 32."""
    assert lib.host_xxh_rows(n, slots) == rows


def _host_hc(lib, src, lens, dest_cap, level, lanes=1, scratch=None):
    """K6's body at ``level`` by a team of ``lanes`` over the batch, one
    block after the other in one team's tables; ``scratch`` (default: one
    team's tables filled with 0x5A, a poisoned chain) is never cleared, so
    each block also starts on the chain the one before left."""
    n = src.shape[0]
    if scratch is None:
        scratch = torch.full((lib.host_hc_team_bytes(),), 0x5A,
                             dtype=torch.uint8)
    out = torch.zeros((n, layout.row_stride(dest_cap)), dtype=torch.uint8)
    out_lens = torch.full((n,), -7, dtype=torch.int32)
    err = torch.full((n,), -7, dtype=torch.int32)
    assert lib.host_hc(_ptr(src), src.stride(0), _ptr(lens), _ptr(out),
                       out.stride(0), dest_cap, level, _ptr(scratch),
                       _ptr(out_lens), _ptr(err), n, lanes) == 0
    # every chain copy a speculated walk read equals its chain slot
    assert lib.host_hc_copy_faults() == 0
    return out, out_lens, err


@functools.cache
def _hc_small():
    """The HC edge blocks and 3000 bytes of each kind."""
    rng = np.random.default_rng(41)
    blocks = testing.hc_edge_blocks(rng) + [
        testing.block_of(rng, k, 3000) for k in testing.HC_KINDS]
    return layout.to_device_layout(blocks, device="cpu")


@functools.cache
def _hc_plain(level, dest_cap=None):
    src, lens = _hc_small()
    cap = max_compressed_length(int(lens.max())) if dest_cap is None \
        else dest_cap
    return cap, hc.compress_hc_plain(src, lens, cap, level)


@pytest.mark.parametrize("level", range(1, 18))
def test_host_hc_levels_match_plain(lib, level):
    """K6's body by one lane at every level, on the edge blocks (literal
    runs and matches at the token's and extension bytes' edges, runs of
    one byte, periods 1-8, empty and 12-byte blocks) and a block of each
    kind, against the plain version (the host HC): whole rows."""
    src, lens = _hc_small()
    cap, plain = _hc_plain(level)
    host = _host_hc(lib, src, lens, cap, level)
    _assert_same(host, plain)
    assert torch.equal(host[0], plain[0])
    assert host[2].tolist() == [codec.OK] * lens.numel()
    assert host[0][0, :host[1][0]].tolist() == [0]      # the empty block


@pytest.mark.parametrize("level", [1, 9, 17])
def test_host_hc_team_matches_plain(lib, level):
    """The same by a team of 32 host threads (its ballots in the compares,
    the leader's table writes between syncs, the lane-split copies and
    reset); every lane ends with the same length and code."""
    src, lens = _hc_small()
    cap, plain = _hc_plain(level)
    host = _host_hc(lib, src, lens, cap, level, lanes=32)
    _assert_same(host, plain)
    assert torch.equal(host[0], plain[0])


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("dest_cap", [0, 1, 40, 300, 1000])
def test_host_hc_tight_dest_cap(lib, dest_cap, lanes):
    """Caps that some rows do not fit, at levels 1 and 9: the same rows
    fail as in the plain version (the reference's ``(run_len >> 8)`` and
    ``(ml >> 8)`` checks), with a length of 0; the others are equal."""
    src, lens = _hc_small()
    for level in (1, 9):
        cap, plain = _hc_plain(level, dest_cap)
        host = _host_hc(lib, src, lens, cap, level, lanes)
        _assert_same(host, plain)
        bad = host[2] != codec.OK
        assert bool(bad.any()) and not host[1][bad].any()
        if dest_cap == 1000:
            assert int(bad.sum()) < lens.numel() // 4


@functools.cache
def _hc_big(size):
    rng = np.random.default_rng(size)
    return layout.to_device_layout(
        [testing.block_of(rng, k, size) for k in testing.HC_KINDS],
        device="cpu")


@pytest.mark.parametrize("level", [1, 2])
@pytest.mark.parametrize("size", testing.HC_BIG_SIZES)
def test_host_hc_long_blocks(lib, size, level):
    """Blocks of 65,536, 65,547, 70,000 and 200 KiB of each kind, where
    the chain slots (``off & 0xFFFF``) wrap and the ``MAX_DISTANCE``
    window cuts the chains, one after the other in one team's tables:
    whole rows against the plain version."""
    src, lens = _hc_big(size)
    cap = max_compressed_length(size)
    host = _host_hc(lib, src, lens, cap, level)
    plain = hc.compress_hc_plain(src, lens, cap, level)
    _assert_same(host, plain)
    assert torch.equal(host[0], plain[0])
    assert host[1][0] < size // 200 and host[1][3] > size  # zeros, random


def test_host_hc_chain_needs_no_reset(lib):
    """A block's chain slots are written before they are read: the output
    is the same whatever the chain holds before the block (zeros, 0x5A,
    0xFF, another block's chain)."""
    src, lens = _hc_small()
    cap, plain = _hc_plain(9)
    nbytes = lib.host_hc_team_bytes()
    for fill in (0x00, 0x5A, 0xFF):
        scratch = torch.full((nbytes,), fill, dtype=torch.uint8)
        for idx in (torch.arange(lens.numel()),
                    torch.arange(lens.numel() - 1, -1, -1)):
            host = _host_hc(lib, src[idx].contiguous(), lens[idx].contiguous(),
                            cap, 9, scratch=scratch)
            assert torch.equal(host[0], plain[0][idx]), fill
            assert torch.equal(host[1], plain[1][idx])


@functools.cache
def _hc_collisions():
    """``testing.hc_collision_blocks``: runs whose chains leave their
    buckets' order, and a predecessor more than 65,535 positions back."""
    return layout.to_device_layout(
        testing.hc_collision_blocks(np.random.default_rng(43)), device="cpu")


@functools.cache
def _hc_collisions_plain(level):
    src, lens = _hc_collisions()
    cap = max_compressed_length(int(lens.max()))
    return cap, hc.compress_hc_plain(src, lens, cap, level)


def _speculates(lib, level):
    return 1 << (level - 1) >= lib.host_hc_spec_attempts()


@pytest.mark.parametrize("level", range(1, 18))
def test_host_hc_collision_blocks(lib, level):
    """K6's body by one lane, with the scratch poisoned, on the collision
    blocks at every level against the plain version: whole rows. Where
    the level speculates, links failed and the walk followed the true
    chain (the host build's counter)."""
    src, lens = _hc_collisions()
    cap, plain = _hc_collisions_plain(level)
    before = lib.host_hc_followed()
    host = _host_hc(lib, src, lens, cap, level)
    _assert_same(host, plain)
    assert torch.equal(host[0], plain[0])
    assert host[2].tolist() == [codec.OK] * lens.numel()
    followed = lib.host_hc_followed() - before
    assert (followed > 0) == _speculates(lib, level), followed


@pytest.mark.parametrize("level", range(1, 18))
def test_host_hc_collision_blocks_team(lib, level):
    """The same by a team of 32 host threads on the 1,000-byte blocks
    (the lanes' link checks, ballots, match_any ranks, the reduction and
    the team's finishing of long candidates): every lane ends with the
    same length and code, and links were followed."""
    src, lens = _hc_collisions()
    idx = torch.nonzero(lens <= 1000).flatten()
    src, lens = src[idx].contiguous(), lens[idx].contiguous()
    cap, plain = _hc_collisions_plain(level)
    before = lib.host_hc_followed()
    host = _host_hc(lib, src, lens, cap, level, lanes=32)
    _assert_same(host, tuple(x[idx] for x in plain))
    assert (lib.host_hc_followed() > before) == _speculates(lib, level)


@pytest.mark.parametrize("lanes", [1, 32])
def test_host_hc_collision_tight_caps(lib, lanes):
    """Caps of n - 1, n and n + 1 of each small collision block's output
    at levels 1 and 9: the same rows fail as in the plain version."""
    src, lens = _hc_collisions()
    idx = torch.nonzero(lens <= 1000).flatten()
    src, lens = src[idx].contiguous(), lens[idx].contiguous()
    for level in (1, 9):
        n = int(_hc_collisions_plain(level)[1][1][idx].max())
        for cap in (n - 1, n, n + 1):
            plain = hc.compress_hc_plain(src, lens, cap, level)
            _assert_same(_host_hc(lib, src, lens, cap, level, lanes), plain)


@pytest.mark.parametrize("level", range(3, 18))
def test_host_hc_long_blocks_every_level(lib, level):
    """The blocks of ``testing.HC_BIG_SIZES`` of each kind (65,536 bytes
    speculates; longer blocks walk serially, over reused slots) at the
    levels the plain version is too slow for there, against the JAX
    package's native HC (held to the same reference by
    ``tests/test_native.py``): whole rows."""
    from lz4_tpu.api.native_instances import HighCompressor
    native = HighCompressor(level)
    for size in testing.HC_BIG_SIZES:
        src, lens = _hc_big(size)
        cap = max_compressed_length(size)
        data, out_lens, err = _host_hc(lib, src, lens, cap, level)
        assert err.tolist() == [codec.OK] * lens.numel()
        for i in range(lens.numel()):
            want = native.compress_alloc(src[i, :size].numpy().tobytes())
            assert data[i, :out_lens[i]].numpy().tobytes() == want, (size, i)


def test_build_digest_covers_every_header(tmp_path, monkeypatch):
    """Editing any ``csrc`` file, a ``.cuh`` header included, gives a new
    build directory, so a stale library is never loaded."""
    for p in build.CSRC.iterdir():
        (tmp_path / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert {p.name for p in build.sources()} >= {
        "xxh64.cu", "lz4_decode.cu", "lz4_parse.cu", "segment_decode.cu",
        "frame_pack.cu", "lz4_hc.cu"}
    digests = {build.source_digest()}
    headers = ("xxh64.cuh", "lz4_decode.cuh", "lz4tt_common.cuh",
               "lz4_parse.cuh", "segment_decode.cuh", "frame_pack.cuh",
               "lz4_hc.cuh")
    for name in headers:
        with open(tmp_path / name, "a") as f:
            f.write("\n")
        digests.add(build.source_digest())
    assert len(digests) == len(headers) + 1


def test_every_library_sets_its_device_and_no_body_does():
    """Each ``.cu`` library exports ``lz4tt_set_device`` (it includes
    ``lz4tt_device.cuh``, whose once-a-card attributes it also uses), and
    no per-block body header includes it, so the g++ builds stay as they
    are."""
    for p in build.sources():
        assert '#include "lz4tt_device.cuh"' in p.read_text(), p.name
    for p in build.CSRC.glob("*.cuh"):
        assert "lz4tt_device.cuh" not in p.read_text() or \
            p.name == "lz4tt_device.cuh", p.name
    for name in ("lz4_compress.cu", "xxh32.cu", "xxh64.cu"):
        assert "lz4tt_once_a_device(" in (build.CSRC / name).read_text()


def test_hc_split_edits_apply():
    """``design_variants --hc-split``'s counters go in where it says: each
    replaced text is in the shipped sources once."""
    for fname, old, new in design_variants._SPLIT_EDITS:
        assert (build.CSRC / fname).read_text().count(old) == 1 and old != new


@pytest.mark.parametrize("name", list(design_variants.VARIANTS))
def test_design_variants_apply(name):
    """Every design variant that ``PERF.md`` reports is still a set of
    edits to the shipped sources: each replaced text is present."""
    source, edits = design_variants.VARIANTS[name]
    assert (build.CSRC / f"{source}.cu").exists()
    for fname, old, new in edits:
        assert old in (build.CSRC / fname).read_text() and old != new



def _host_window_codec(fn, data, lens, win, win_lens, out_width, out_cap,
                       lanes, out=None):
    n = data.shape[0]
    if out is None:
        out = torch.zeros((n, out_width), dtype=torch.uint8)
    out_lens = torch.zeros((n,), dtype=torch.int32)
    err = torch.zeros((n,), dtype=torch.int32)
    rc = fn(_ptr(data), data.stride(0), _ptr(lens), *(
        (_ptr(out), out.stride(0), out_cap, _ptr(win) + win.shape[1],
         win.stride(0), _ptr(win_lens))
        if fn.__name__ == "host_decode_hist" else
        (_ptr(win) + win.shape[1], win.stride(0), _ptr(win_lens), _ptr(out),
         out.stride(0), out_cap)), _ptr(out_lens), _ptr(err), n, lanes)
    assert rc == 0, "the lanes disagree"
    return out, out_lens, err


def _history_batch(rng):
    """The blocks of ``testing.history_blocks`` (with their bytes), of
    ``testing.overreach_blocks`` (malformed) and fuzzed variants of them,
    each with its history."""
    cases = testing.history_blocks(rng)
    comp = [testing.encode_block(s, t) for _, s, t in cases]
    want = [testing.expand_block(s, t, h) for h, s, t in cases]
    hists = [h for h, _, _ in cases]
    over = testing.overreach_blocks(rng)
    fuzz = testing.fuzz_blocks(rng, comp, 48)
    return (comp + [b for _, b in over] + fuzz,
            hists + [h for h, _ in over] + [hists[i % len(hists)]
                                            for i in range(len(fuzz))],
            want, len(over))


@pytest.mark.parametrize("lanes", [1, 32])
@pytest.mark.parametrize("out_max", [70000, 1000, 64])
def test_host_decode_hist_matches_plain(lib, lanes, out_max):
    """K1's body with a history a row, as one lane and as 32 host threads
    (the ring's preload and the lanes' copies), on matches at the
    history's start, straddling its end, periods 1-40 from its tail,
    sources in it within the ring and past it, null offsets, matches
    reaching before it (MALFORMED) and fuzz, at history lengths
    ``testing.HIST_LENS``, against the plain version and the expected
    bytes; tight caps; a guard behind every row and the histories
    untouched."""
    rng = np.random.default_rng(11)
    blocks, hists, want, n_over = _history_batch(rng)
    if lanes > 1:
        keep = [i for i, h in enumerate(hists) if i < len(want) + n_over]
        blocks, hists = [blocks[i] for i in keep], [hists[i] for i in keep]
    c, cl = layout.to_device_layout(blocks, device="cpu")
    win, wl = testing.windows(hists, "cpu")
    before = win.clone()
    guard = torch.full((len(blocks), out_max + 37), 0xA5, dtype=torch.uint8)
    host = _host_window_codec(lib.host_decode_hist, c, cl, win, wl, None,
                              out_max, lanes, out=guard)
    plain = codec.decompress_safe_hist_batch(c, cl, out_max, win, wl)
    _assert_same(host, plain, all_lens=False)
    assert bool((guard[:, out_max:] == 0xA5).all())
    assert torch.equal(win, before)
    codes = host[2].tolist()
    if out_max == 70000:
        assert codes[:len(want)] == [codec.OK] * len(want)
        assert layout.from_device_layout(guard[:len(want)],
                                         host[1][:len(want)]) == want
        assert codes[len(want):len(want) + n_over] == \
            [codec.ERR_MALFORMED] * n_over
    else:
        assert codec.ERR_DEST_TOO_SMALL in codes or \
            codec.ERR_MALFORMED in codes[:len(want)]


def test_host_decode_hist_zero_is_k1(lib, edge_batch):
    """History length 0 on every row: the window body equals K1's, code for
    code and byte for byte, on the edge blocks' K2 output and fuzz."""
    _, (src, lens) = edge_batch
    comp, comp_lens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(70000))
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    batch = comp_blocks + testing.fuzz_blocks(np.random.default_rng(4),
                                              comp_blocks, 96)
    c, cl = layout.to_device_layout(batch, device="cpu")
    for out_max in (1, 1000, 70000):
        win, wl = testing.windows([b""] * len(batch), "cpu")
        a = _host_window_codec(lib.host_decode_hist, c, cl, win, wl,
                               out_max + 64, out_max, 1)
        b = _host_codec(lib.host_decode, c, cl, out_max + 64, out_max)
        assert a[2].tolist() == b[2].tolist()
        ok = a[2] == codec.OK
        assert torch.equal(a[1][ok], b[1][ok])
        assert torch.equal(a[0], b[0])


@pytest.mark.parametrize("empty", [False, True], ids=["cap", "cap0"])
@pytest.mark.parametrize("name", testing.DECODERS + WHOLE_BODIES)
def test_host_decode_lengths_outside_the_row(lib, name, empty):
    """K1's row guard (``lz4tt_decode_row``, ``lz4tt_split_row``) in the
    host build of each entry point (and of the safe one's whole-output
    bodies), with room for the blocks and with none (``dest_cap`` 0,
    where the body reads a row's first byte): rows whose length lies
    outside ``[0, S]`` (each of ``testing.BAD_LENGTHS``) are MALFORMED
    with length 0 and their rows untouched, and the other rows decode as
    the plain version decodes them, with a guard behind every row."""
    comp, lens, cap = testing.length_batch(np.random.default_rng(6), "cpu")
    cap = 0 if empty else cap
    n, stride = comp.shape
    rows = [1, 4, 7]
    bad = lens.clone()
    for i, length in zip(rows, testing.BAD_LENGTHS.values()):
        bad[i] = length(stride)
    guard = torch.full((n, cap + 37), 0xA5, dtype=torch.uint8)
    if name == "hist":
        win, wl = testing.windows([bytes(range(testing.DECODE_HIST))] * n,
                                  "cpu")
        host = _host_window_codec(lib.host_decode_hist, comp, bad, win, wl,
                                  None, cap, 1, out=guard)
    else:
        fn = {"safe": lib.host_decode, "fast": lib.host_decode_fast}.get(
            name) or _host_whole(lib, name)
        host = _host_codec(fn, comp, bad, None, cap, out=guard)
    plain = testing.decode_with("safe" if name in WHOLE_BODIES else name,
                                comp, bad, cap)
    _assert_same(host, plain, out_len=cap if name == "fast" else None)
    assert host[2][rows].tolist() == [codec.ERR_MALFORMED] * len(rows)
    assert host[1][rows].tolist() == [0] * len(rows)
    if cap:
        assert host[2].tolist().count(codec.OK) == n - len(rows)
    assert bool((guard[rows] == 0xA5).all())
    assert bool((guard[:, cap:] == 0xA5).all())


def _linked_content(rng, n_blocks: int, bs: int) -> bytes:
    """Content whose blocks match into the blocks before them: phrases of
    a small vocabulary with random bytes between."""
    words = [rng.integers(0, 256, int(k), dtype=np.uint8).tobytes()
             for k in rng.integers(8, 64, 40)]
    out = b"".join(words[int(i)] + bytes([int(i)])
                   for i in rng.integers(0, 40, n_blocks * bs // 20))
    return out[:n_blocks * bs - 123]


def test_host_linked_blocks_in_one_buffer(lib):
    """Linked blocks: each block compressed (K2's body with a dictionary)
    against the content before it, then decoded (K1's body with a
    history) in one buffer whose earlier output is each block's history,
    the layout the frame reader uses on the card."""
    rng = np.random.default_rng(12)
    bs = 4096
    content = _linked_content(rng, 24, bs)
    n = -(-len(content) // bs)
    buf = torch.zeros((n * bs + 16,), dtype=torch.uint8)
    buf[:len(content)] = torch.frombuffer(bytearray(content), dtype=torch.uint8)
    src = buf[:n * bs].view(n, bs)
    lens = torch.tensor([min(bs, len(content) - i * bs) for i in range(n)],
                        dtype=torch.int32)
    starts = [i * bs for i in range(n)]
    dlens = torch.tensor([min(s, 65536) for s in starts], dtype=torch.int32)
    cap = max_compressed_length(bs)
    comps = []
    for i in range(n):    # the window is the content before block i
        d = buf[:starts[i]].view(1, -1) if starts[i] else \
            torch.zeros((1, 1), dtype=torch.uint8)
        host = _host_window_codec(lib.host_compress_dict, src[i:i + 1],
                                  lens[i:i + 1], d, dlens[i:i + 1],
                                  layout.row_stride(cap), cap, 1)
        plain = codec.compress_dict_batch(src[i:i + 1], lens[i:i + 1], cap, d,
                                          dlens[i:i + 1])
        _assert_same(host, plain)
        comps.append(host[0][0, :int(host[1][0])].numpy().tobytes())
    assert sum(map(len, comps)) < len(content) // 2
    out = torch.zeros((n * bs + 64,), dtype=torch.uint8)
    pos = 0
    for i, blk in enumerate(comps):
        c, cl = layout.to_device_layout([blk], device="cpu")
        h = out[max(0, pos - 65536):pos].view(1, -1) if pos else \
            torch.zeros((1, 1), dtype=torch.uint8)
        hl = torch.tensor([min(pos, 65536)], dtype=torch.int32)
        row = out[pos:pos + bs].view(1, bs)
        got = _host_window_codec(lib.host_decode_hist, c, cl, h, hl, None, bs,
                                 1, out=row)
        assert got[2].tolist() == [codec.OK]
        pos += int(got[1][0])
    assert out[:pos].numpy().tobytes() == content


@pytest.mark.parametrize("lanes", [1, 32])
def test_host_compress_dict_matches_plain(lib, lanes):
    """K2's body with a dictionary, as one lane and as 32 host threads (the
    table seeded by the team), against the plain version: the edge sizes
    of every kind with dictionaries of ``testing.HIST_LENS`` bytes that
    share content with the blocks, at the full cap and at tight caps;
    writes past the lengths too."""
    rng = np.random.default_rng(13)
    sizes = (0, 5, 13, 1000, 65536, 70000) if lanes == 1 else (13, 1000)
    hist_lens = testing.HIST_LENS if lanes == 1 else (0, 4, 4095, 65536)
    blocks, dicts = [], []
    for hl in hist_lens:
        d = testing.block_of(rng, "text", hl)
        for size in sizes:
            for kind in testing.KINDS:
                b = testing.block_of(rng, kind, size)
                blocks.append((d[-3000:] + b)[:size] if kind == "alphabet4"
                              else b)
                dicts.append(d)
    src, lens = layout.to_device_layout(blocks, device="cpu")
    win, wl = testing.windows(dicts, "cpu")
    for cap in (max_compressed_length(max(sizes)), 600):
        width = layout.row_stride(cap)
        host = _host_window_codec(lib.host_compress_dict, src, lens, win, wl,
                                  width, cap, lanes)
        plain = codec.compress_dict_batch(src, lens, cap, win, wl)
        _assert_same(host, plain)
        assert torch.equal(host[0], plain[0])


def _host_parallel(lib, src, lens, cap, lanes=1, wl=65536, walk_limit=64):
    """K7's bodies on the rows of ``src`` in windows of ``wl`` positions
    (the card's 65,536, or a multiple of 512 below it), hash walks of at
    most ``walk_limit`` steps (0: the exact sort wherever a walk has a
    step)."""
    n = src.shape[0]
    out = torch.zeros((n, layout.row_stride(cap)), dtype=torch.uint8)
    out_lens = torch.zeros((n,), dtype=torch.int32)
    assert lib.host_parallel(_ptr(src), src.stride(0), _ptr(lens), _ptr(out),
                             out.stride(0), cap, src.shape[1], _ptr(out_lens),
                             n, lanes, wl, walk_limit) == 0
    return out, out_lens


@pytest.fixture(scope="module")
def parallel_batch():
    blocks = testing.parallel_blocks(np.random.default_rng(31))
    return layout.to_device_layout(blocks, device="cpu")


def _assert_parallel_same(host, plain):
    assert host[1].tolist() == plain[1].tolist()
    assert torch.equal(host[0], plain[0])


@pytest.mark.parametrize("cap, lanes", [(None, 1), (40, 1), (0, 1), (None, 8),
                                        (40, 8)])
def test_host_parallel_matches_plain(lib, parallel_batch, cap, lanes):
    """K7's body, as one thread and as a team of 8 host threads (tiles of
    8 positions: the sort's ranks, the scans' carries and the queue of
    long literal runs across many tiles), against the plain version, the
    rows at a tight cap (-1, their first cap bytes) included."""
    src, lens = parallel_batch
    if cap is None:
        cap = max_compressed_length(src.shape[1])
    host = _host_parallel(lib, src, lens, cap, lanes)
    plain = parallel_compress.compress_parallel_plain(src, lens, cap)
    _assert_parallel_same(host, plain)
    if cap == 40:
        assert (host[1] == -1).any() and (host[1] > 0).any()


@pytest.mark.parametrize("case", ["big", "window"])
def test_host_parallel_long_blocks(lib, case):
    """Blocks of 65,535-65,537 bytes of every kind, and the two window
    blocks of 70,028 bytes (a repeat just outside and just inside
    MAX_DISTANCE), on one thread."""
    rng = np.random.default_rng(32)
    blocks = (testing.parallel_blocks(rng, testing.PARALLEL_BIG_SIZES)[:-1]
              if case == "big" else testing.window_clamp_blocks())
    src, lens = layout.to_device_layout(blocks, device="cpu")
    cap = max_compressed_length(src.shape[1])
    _assert_parallel_same(_host_parallel(lib, src, lens, cap),
                          parallel_compress.compress_parallel_plain(src, lens,
                                                                    cap))


@pytest.fixture(scope="module")
def gather_batch():
    """K2's blocks of the edge batch kinds, the chain blocks and the
    null-offset block, with their plain parser's sentinel-tail tables."""
    rng = np.random.default_rng(34)
    raws = testing.mixed_blocks(rng, (0, 5, 13, 1000, 4000))
    src, lens = layout.to_device_layout(raws, device="cpu")
    comp, clens, _ = codec.compress_fast_plain(src, lens,
                                               max_compressed_length(4000))
    blocks = layout.from_device_layout(comp, clens)
    pairs = testing.chain_blocks(rng)
    blocks += [c for c, _ in pairs] + [testing.boundary_blocks()[0]]
    raws += [r for _, r in pairs] + [b"*" + bytes(4) + b"*" * 8]
    c, cl = layout.to_device_layout(blocks, device="cpu")
    tables, n_seq, total = sequences.parse_plain(c, cl, sentinel_tails=True)
    assert bool((n_seq > 0).all())
    return c, tables, raws, max(len(r) for r in raws), cl


def _host_gather(lib, c, tables, out_len, max_depth, lanes=1):
    out = torch.full((c.shape[0], out_len + 16), 0xA5, dtype=torch.uint8)
    lib.host_gather(_ptr(c), c.stride(0), c.shape[1],
                    *(_ptr(t) for t in tables.contiguous()), tables.shape[2],
                    _ptr(out), out.stride(0), out_len, max_depth, c.shape[0],
                    lanes)
    assert bool((out[:, out_len:] == 0xA5).all())
    return out[:, :out_len]


@pytest.mark.parametrize("max_depth, lanes", [(0, 1), (1, 1), (2, 1), (3, 1),
                                              (32, 1), (2, 8), (32, 8)])
def test_host_gather_matches_plain(lib, gather_batch, max_depth, lanes):
    """K8's body, as one thread and as 8 host threads, against the plain
    version at max_depth 0-3 (chains cut short) and 32, where every block
    decodes to its input."""
    c, tables, raws, out_len, _ = gather_batch
    host = _host_gather(lib, c, tables, out_len, max_depth, lanes)
    plain = gather_decode.gather_decompress_plain(c, *tables, out_len,
                                                  max_depth)
    assert torch.equal(host, plain)
    if max_depth == 32:
        for i, r in enumerate(raws):
            assert host[i, :len(r)].numpy().tobytes() == r, i
            assert not bool(host[i, len(r):].any())


@pytest.mark.parametrize("sentinel_tails", [True, False])
def test_host_gather_walks_the_sequences_only(lib, gather_batch,
                                              sentinel_tails):
    """K8's body writes the entries before a row's first sentinel
    (``lz4tt_gd_used``): the parser's ``n_seq`` with sentinel tails, every
    entry with zero tails."""
    c, _, _, _, cl = gather_batch
    tables, n_seq, _ = sequences.parse_plain(c, cl,
                                             sentinel_tails=sentinel_tails)
    lit_out = tables[0].contiguous()
    width = lit_out.shape[1]
    used = [lib.host_gd_used(_ptr(lit_out[i]), width)
            for i in range(lit_out.shape[0])]
    assert used == (n_seq.tolist() if sentinel_tails
                    else [width] * lit_out.shape[0])


def test_host_parse_sentinel_tails(lib):
    """The parser's sentinel tails (``lz4tt_parse_sentinel``, run after the
    body as the kernel runs it) against the plain parser's."""
    c, cl = _comp_batch(35, 8)
    want = sequences.parse_plain(c, cl, sentinel_tails=True)
    got = _host_parse(lib, c, cl, want[0].shape[2], sentinel=True)
    assert torch.equal(got[1], want[1])
    ok = want[1] >= 0
    assert torch.equal(got[0][:, ok], want[0][:, ok])
    assert bool((want[0][[0, 3]][:, ok, -1] == sequences.SENTINEL).all())


# ---------------------------------------------------------------------------
# the LZ4Block stream (block_stream.cuh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lanes", [1, 8, 32])
@pytest.mark.parametrize("shift", [0, 3])
def test_host_lz4block_pack_matches_plain(lib, shift, lanes):
    """The LZ4Block pack body (each block's 21-byte header and payload, and
    the end block) by one lane and by teams of host threads, against
    ``block_stream_body_packed_plain`` at a block size of 128 KiB."""
    from lz4_tpu_torch.kernels import block_stream as bs

    src, lens, comp, comp_lens = _pack_batch(np.random.default_rng(shift),
                                             shift)
    want, total = bs.block_stream_body_packed_plain(src, lens, comp,
                                                    comp_lens, 1 << 17)
    checks = xxhash.xxh32_plain(src.contiguous(), lens, bs.DEFAULT_SEED)
    emit = torch.where(lens > 0, torch.minimum(lens, comp_lens) + 21, 0)
    offs = (torch.cumsum(emit, 0) - emit).to(torch.int32)
    end_at = int(emit.sum())
    assert end_at + 21 == total
    body = torch.full((total + 16,), 0xA5, dtype=torch.uint8)
    lib.host_lz4block_pack(_ptr(src), src.stride(0), _ptr(lens), _ptr(comp),
                           comp.stride(0), _ptr(comp_lens), _ptr(offs),
                           _ptr(checks), bs.compression_level(1 << 17),
                           _ptr(body), end_at, lens.numel(), lanes)
    assert torch.equal(body[:total], want)
    assert bool((body[total:] == 0xA5).all())


def _lz4block_streams():
    """Each planted fault's stream (an empty block stops the walk), and
    streams with no first block, concatenated streams and a raw payload of
    magic bytes, walked with and without the stop."""
    from lz4_tpu.formats import compress_block_stream

    rng = np.random.default_rng(8)
    out = [(testing.lz4block_fault(case, rng)[0], True)
           for case in sorted(testing.LZ4BLOCK_FAULTS)]
    cat = (compress_block_stream(testing.block_of(rng, "text", 3000), 1024)
           + compress_block_stream(bytes(5000), 64))
    magic = testing.lz4block_stream([b"LZ4Block" * 128], [b"LZ4Block" * 128],
                                    1024)
    for blob in (b"", b"LZ4Block", bytes(30), cat, magic, cat[:-3]):
        out += [(blob, True), (blob, False)]
    return out


@pytest.mark.parametrize("max_blocks", [1, 3, 64])
def test_host_lz4block_walk_matches_plain(lib, max_blocks):
    """The walk body (the reference of the index kernels, and what they
    fall back on) against ``kernels/block_stream.py::walk``: records,
    count and end, from position 0 and from the middle of a stream."""
    from lz4_tpu_torch.kernels import block_stream as bs

    for blob, stop in _lz4block_streams():
        for pos in sorted({0, min(len(blob), 21 + 1024 + 21)}):
            buf = np.frombuffer(blob + bytes(16), np.uint8).copy()
            table = torch.full((6, max_blocks), 77, dtype=torch.int32)
            end = ctypes.c_longlong(-1)
            k = lib.host_lz4block_walk(buf.ctypes.data, len(blob), pos,
                                       int(stop), max_blocks, _ptr(table),
                                       ctypes.byref(end))
            want, want_end = bs.walk(blob, len(blob), pos, stop, max_blocks)
            assert (k, end.value) == (len(want), want_end), (pos, stop)
            assert table[:, :k].T.tolist() == [list(r) for r in want]


def test_host_lz4block_marks_every_magic(lib):
    """The mark's test of 16 positions (``lz4tt_lz4block_hits``) against a
    search of the bytes: magic at every offset of a chunk, across chunks,
    back to back, cut by the end, and beside near misses."""
    rng = np.random.default_rng(9)
    buf = bytearray(rng.integers(0, 256, 4096, dtype=np.uint8).tobytes())
    at = list(range(0, 16 * 24, 17)) + [600, 608, 616, 1000, 1001 + 8]
    for p in at:
        buf[p:p + 8] = b"LZ4Block"
    for p in (2000, 2100):                  # one byte short of the magic
        buf[p:p + 8] = b"LZ4Blocl" if p == 2000 else b"LZ4Bloc\x00"
    buf[-5:] = b"LZ4Bl"                     # cut by the end
    for length in (len(buf), len(buf) - 3, 4000 + 7):
        data = bytes(buf[:length])
        chunks = -(-length // 16)
        hits = np.zeros(chunks, np.uint32)
        lib.host_lz4block_hits(data, length, hits.ctypes.data, chunks)
        got = [16 * c + r for c in range(chunks) for r in range(16)
               if (int(hits[c]) >> r) & 1]
        want = [p for p in range(length - 7) if data[p:p + 8] == b"LZ4Block"]
        assert got == want
