"""Time design variants of block compress (K2), block decode (K1),
segment decode (K5), the hashes (K3, K4 and their streaming updates), the
sequence parser, frame-body packing and LZ4 HC (K6) against the shipped
kernels, on the card.

Each variant is the shipped ``csrc`` with a few text replacements: the
design options ``PERF.md`` reports as tried and lost. Every variant is
built with ``nvcc`` (in parallel, into ``build/lz4_tpu_torch/variants/``)
and timed with CUDA events on the main path's rows (``make_blocks(4096,
65536, 1234)``, its K2 output for K1, the parser and pack, and the
parser's tables of that for K5): all rows, the a4 and the text rows apart,
then the first 256 rows (a stream batch). A hash variant is timed
on three launches: the one-shot entry point on the 4096 rows and on one
16 MiB row (the first 256 rows end to end), and the update on the same 16
MiB, a stream batch. K6 is timed at levels 1-6, 9 and 17 on the 4096
rows (where the speculated walk starts to pay) and at levels 1, 9 and 17
on 1, 132, 1,056 and 4,096 of their a4 rows (its slowest kind). Each
variant's output is held against the shipped kernel's. Run from the root
of a checkout, on a machine with a card, for all of them or those of
some sources::

    python -m lz4_tpu_torch.design_variants [lz4_compress lz4_decode segment_decode lz4_parse frame_pack xxh32 xxh64 lz4_hc]

``--hc-split`` instead builds K6 with ``clock64`` counters in its first
team's lane 0 and prints the cycles of each part of its searches: on one
a4 row alone and on team 0 of 4,096 a4 rows, at level 9.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

from .core.constants import max_compressed_length
from .dist import sharded
from .kernels import build, codec, hc, sequences, xxhash, xxhash_stream

SEED, N_BLOCKS, BLOCK_LEN, REPS = 1234, 4096, 1 << 16, 5
HC_REPS = 2                      # K6's timed launches (the slow ones take 1 s)
HC_ALL_LEVELS = (1, 2, 3, 4, 5, 6, 9, 17)
HC_A4_LEVELS = (1, 9, 17)
HC_A4_ROWS = (1, 132, 1056, 4096)

_STAGED = """  uint4* row = table + LZ4TT_TABLE_BYTES / 16;
  const uint4* g = (const uint4*)(src + b * src_stride);
  for (int i = t.lane(); i < (src_lens[b] + 15) / 16; i += 32) row[i] = g[i];
  __syncwarp();
  lz4tt_compress_block(t, (const uint8_t*)row, src_lens[b], dst + b * dst_stride,"""
_WORDS = """#include "lz4tt_common.cuh"

LZ4TT_HD uint32_t lz4tt_load32u(const uint8_t* p, int64_t i) {
  const uintptr_t addr = (uintptr_t)(p + i);
  const uint8_t* w = (const uint8_t*)(addr & ~(uintptr_t)3);
  const int mis = (int)(addr & 3);
  return lz4tt_funnel_r(lz4tt_ld32(w), mis ? lz4tt_ld32(w + 4) : 0u, 8 * mis);
}
"""
_STAGES = "#define LZ4TT_XXH_STAGE 32768\n#define LZ4TT_XXH_STAGES 4"
_ROWS = "#define LZ4TT_XXH_ROWS 32"
_ROUND = """LZ4TT_HD uint32_t lz4tt_xxh_round(uint32_t v, uint32_t x) {
  return lz4tt_rotl32(v + x * LZ4TT_P2, 13) * LZ4TT_P1;
}
"""
# the first version of the update: one consumer carrying all four lanes
_ONE_CONSUMER_BODY = _ROUND + """
LZ4TT_HD lz4tt_u4 lz4tt_lds16(const uint8_t* p) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  return {v.x, v.y, v.z, v.w};
}

LZ4TT_HD void lz4tt_xxh32_stage4(const uint8_t* p, int32_t n, uint32_t* v) {
  uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  const int32_t groups = n / LZ4TT_XXH_GROUP;
  lz4tt_u4 w[LZ4TT_XXH_GROUP];
  if (groups > 0)
    for (int k = 0; k < LZ4TT_XXH_GROUP; k++) w[k] = lz4tt_lds16(p + 16 * k);
  for (int32_t g = 0; g < groups; g++) {
    lz4tt_u4 x[LZ4TT_XXH_GROUP];
    const uint8_t* next = p + 16 * LZ4TT_XXH_GROUP * (g + 1 < groups ? g + 1 : g);
#pragma unroll
    for (int k = 0; k < LZ4TT_XXH_GROUP; k++) x[k] = lz4tt_lds16(next + 16 * k);
#pragma unroll
    for (int k = 0; k < LZ4TT_XXH_GROUP; k++) {
      v1 = lz4tt_xxh_round(v1, w[k].x);
      v2 = lz4tt_xxh_round(v2, w[k].y);
      v3 = lz4tt_xxh_round(v3, w[k].z);
      v4 = lz4tt_xxh_round(v4, w[k].w);
    }
#pragma unroll
    for (int k = 0; k < LZ4TT_XXH_GROUP; k++) w[k] = x[k];
  }
  for (int32_t i = groups * LZ4TT_XXH_GROUP; i < n; i++) {
    const lz4tt_u4 y = lz4tt_lds16(p + 16 * i);
    v1 = lz4tt_xxh_round(v1, y.x);
    v2 = lz4tt_xxh_round(v2, y.y);
    v3 = lz4tt_xxh_round(v3, y.z);
    v4 = lz4tt_xxh_round(v4, y.w);
  }
  v[0] = v1;
  v[1] = v2;
  v[2] = v3;
  v[3] = v4;
}

"""
_ONE_CONSUMER_KERNEL = """__global__ void __launch_bounds__(64, 1)
    xxh32_one_consumer_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                              uint32_t* __restrict__ state) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[LZ4TT_XXH_STAGES], empty[LZ4TT_XXH_STAGES];
  const int32_t per = LZ4TT_XXH_STAGE / 16;
  const int64_t stages = (n_stripes + per - 1) / per;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LZ4TT_XXH_STAGES; s++) {
      lz4tt_mbar_init(&full[s], 1);
      lz4tt_mbar_init(&empty[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 32) {  // the producer
    for (int64_t i = 0; i < stages; i++) {
      const int s = (int)(i % LZ4TT_XXH_STAGES);
      const uint32_t use = (uint32_t)(i / LZ4TT_XXH_STAGES);
      const uint32_t bytes = 16u * lz4tt_xxh_stage_stripes(n_stripes, i, per);
      if (use > 0) lz4tt_mbar_wait(&empty[s], (use - 1) & 1);
      lz4tt_mbar_expect(&full[s], bytes);
      lz4tt_bulk_copy(ring + s * LZ4TT_XXH_STAGE, data + i * LZ4TT_XXH_STAGE, bytes,
                      &full[s]);
    }
  } else if (threadIdx.x == 0) {
    uint32_t v[4] = {state[0], state[1], state[2], state[3]};
    for (int64_t i = 0; i < stages; i++) {
      const int s = (int)(i % LZ4TT_XXH_STAGES);
      lz4tt_mbar_wait(&full[s], (uint32_t)(i / LZ4TT_XXH_STAGES) & 1);
      lz4tt_xxh32_stage4(ring + s * LZ4TT_XXH_STAGE,
                         lz4tt_xxh_stage_stripes(n_stripes, i, per), v);
      lz4tt_mbar_arrive(&empty[s]);
    }
    for (int k = 0; k < 4; k++) state[k] = v[k];
  }
}

// The kernels' shared memory allowed once a card; the CTAs of K3 the"""
_STREAM_LAUNCH32 = """  if (n_stripes > 0)
    xxh32_stream_kernel<<<1, kXxhThreads, lz4tt_xxh_smem(1), (cudaStream_t)stream>>>("""
_PREPARED = "// The kernels' shared memory allowed once a card; the CTAs of K3 the"
# one thread carrying the four lanes of a row (K3 before this design), in
# the textbook round, eight stripes' 16-byte loads from device memory ahead
_THREAD_ROWS32 = _ROUND + """
__device__ void thread_stripes32(const uint8_t* p, int64_t n, uint32_t* v) {
  int64_t i = 0;
  for (; i + 8 <= n; i += 8) {
    lz4tt_u4 w[8];
#pragma unroll
    for (int k = 0; k < 8; k++) w[k] = lz4tt_load16(p + 16 * (i + k));
#pragma unroll
    for (int k = 0; k < 8; k++) {
      v[0] = lz4tt_xxh_round(v[0], w[k].x);
      v[1] = lz4tt_xxh_round(v[1], w[k].y);
      v[2] = lz4tt_xxh_round(v[2], w[k].z);
      v[3] = lz4tt_xxh_round(v[3], w[k].w);
    }
  }
  for (; i < n; i++) {
    const lz4tt_u4 w = lz4tt_load16(p + 16 * i);
    v[0] = lz4tt_xxh_round(v[0], w.x);
    v[1] = lz4tt_xxh_round(v[1], w.y);
    v[2] = lz4tt_xxh_round(v[2], w.z);
    v[3] = lz4tt_xxh_round(v[3], w.w);
  }
}

__global__ void __launch_bounds__(32)
    xxh32_thread_kernel(const uint8_t* __restrict__ data, int64_t stride,
                        const int32_t* __restrict__ lens, uint32_t seed,
                        uint32_t* __restrict__ out, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * 32 + threadIdx.x;
  if (b >= n) return;
  uint32_t v[4];
  for (int k = 0; k < 4; k++) v[k] = lz4tt_xxh32_lane_init(seed, k);
  thread_stripes32(data + b * stride, lens[b] / 16, v);
  out[b] = lz4tt_xxh32_finish(v, data + b * stride, lens[b], seed);
}

// one thread loading global memory, 16 stripes loaded before the rounds of
// the 16 before them
__global__ void __launch_bounds__(1)
    xxh32_global_kernel(const uint8_t* __restrict__ data, int64_t n,
                        uint32_t* __restrict__ state) {
  uint32_t v1 = state[0], v2 = state[1], v3 = state[2], v4 = state[3];
  const int64_t groups = n / 16;
  lz4tt_u4 a[16];
  if (groups > 0)
    for (int k = 0; k < 16; k++) a[k] = lz4tt_load16(data + 16 * k);
  for (int64_t g = 0; g < groups; g++) {
    const int64_t next = 16 * (g + 1 < groups ? g + 1 : g);
    lz4tt_u4 b[16];
#pragma unroll
    for (int k = 0; k < 16; k++) b[k] = lz4tt_load16(data + 16 * (next + k));
#pragma unroll
    for (int k = 0; k < 16; k++) {
      v1 = lz4tt_xxh_round(v1, a[k].x);
      v2 = lz4tt_xxh_round(v2, a[k].y);
      v3 = lz4tt_xxh_round(v3, a[k].z);
      v4 = lz4tt_xxh_round(v4, a[k].w);
    }
#pragma unroll
    for (int k = 0; k < 16; k++) a[k] = b[k];
  }
  uint32_t v[4] = {v1, v2, v3, v4};
  thread_stripes32(data + 16 * 16 * groups, n - 16 * groups, v);
  for (int k = 0; k < 4; k++) state[k] = v[k];
}

""" + _PREPARED
_BATCH_LAUNCH32 = """    xxh32_kernel<<<(n + rows - 1) / rows, kXxhThreads, lz4tt_xxh_smem(rows),
                   (cudaStream_t)stream>>>((const uint8_t*)data, stride, (const int32_t*)lens,
                                           seed, (uint32_t*)out, n, rows);"""
# K4 and the XXH64 update before this design: one thread carrying the four
# lanes, four stripes' loads from device memory ahead
_THREAD64 = """__device__ void thread_stripes64(const uint8_t* p, int64_t n, uint64_t* v) {
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    lz4tt_u4 w[8];
#pragma unroll
    for (int k = 0; k < 8; k++) w[k] = lz4tt_load16(p + 32 * i + 16 * k);
#pragma unroll
    for (int k = 0; k < 4; k++) {
      v[0] = lz4tt_xxh64_round(v[0], (uint64_t)w[2 * k].x | ((uint64_t)w[2 * k].y << 32));
      v[1] = lz4tt_xxh64_round(v[1], (uint64_t)w[2 * k].z | ((uint64_t)w[2 * k].w << 32));
      v[2] = lz4tt_xxh64_round(v[2], (uint64_t)w[2 * k + 1].x | ((uint64_t)w[2 * k + 1].y << 32));
      v[3] = lz4tt_xxh64_round(v[3], (uint64_t)w[2 * k + 1].z | ((uint64_t)w[2 * k + 1].w << 32));
    }
  }
  for (; i < n; i++)
    for (int k = 0; k < 4; k++) v[k] = lz4tt_xxh64_round(v[k], lz4tt_read64(p, 32 * i + 8 * k));
}

__global__ void __launch_bounds__(32)
    xxh64_thread_kernel(const uint8_t* __restrict__ data, int64_t stride,
                        const int32_t* __restrict__ lens, uint64_t seed,
                        uint64_t* __restrict__ out, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * 32 + threadIdx.x;
  if (b >= n) return;
  uint64_t v[4];
  for (int k = 0; k < 4; k++) v[k] = lz4tt_xxh64_lane_init(seed, k);
  thread_stripes64(data + b * stride, lens[b] / 32, v);
  out[b] = lz4tt_xxh64_finish(v, data + b * stride, lens[b], seed);
}

__global__ void __launch_bounds__(1)
    xxh64_thread_stream_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                               uint64_t* __restrict__ state) {
  uint64_t v[4] = {state[0], state[1], state[2], state[3]};
  thread_stripes64(data, n_stripes, v);
  for (int k = 0; k < 4; k++) state[k] = v[k];
}

// The kernels' shared memory allowed once a card; the CTAs of K4 the"""
_PREPARED64 = "// The kernels' shared memory allowed once a card; the CTAs of K4 the"
_BATCH_LAUNCH64 = """    xxh64_kernel<<<(n + rows - 1) / rows, kXxhThreads, lz4tt_xxh_smem(rows),
                   (cudaStream_t)stream>>>((const uint8_t*)data, stride, (const int32_t*)lens,
                                           (uint64_t)seed, (uint64_t*)out, n, rows);"""
_STREAM_LAUNCH64 = """    xxh64_stream_kernel<<<1, kXxhThreads, lz4tt_xxh_smem(1), (cudaStream_t)stream>>>("""
_RING_H = "lz4tt_xxh_ring.cuh"
_RING = "  LZ4TT_RING = 4096,"
_NEAR = "enum { LZ4TT_RING_FLUSH = 2048, LZ4TT_RING_NEAR = 3072 };"

# the parser: its launch, the six zero tails, the kernel's call of the body
_PARSE_LAUNCH = """    parse_kernel<<<grid, 32 * kWarpsPerCta, 0, (cudaStream_t)stream>>>("""
_PARSE_MEMSET = """    cudaMemsetAsync(tables, 0, sizeof(int32_t) * 6 * (size_t)n * max_seq,
                    (cudaStream_t)stream);
""" + _PARSE_LAUNCH
_ZERO_TAILS = """  lz4tt_team_zero32(t, row.lit_out, at.n + at.lit, max_seq);
  lz4tt_team_zero32(t, row.lit_src, at.n + at.lit, max_seq);
  lz4tt_team_zero32(t, row.lit_len, at.n + at.lit, max_seq);
  lz4tt_team_zero32(t, row.m_out, at.n, max_seq);
  lz4tt_team_zero32(t, row.m_dist, at.n, max_seq);
  lz4tt_team_zero32(t, row.m_len, at.n, max_seq);
"""
_PARSE_NS = "}  // namespace"
# the parser before this design: one thread a block, 32 blocks a CTA, the
# whole walk by the serial rules from device memory, into zeroed tables
_PARSE_THREAD = """__global__ void __launch_bounds__(32)
    parse_thread_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                        const int32_t* __restrict__ comp_lens, int32_t max_seq,
                        int32_t* tables, int32_t* __restrict__ n_seq,
                        int32_t* __restrict__ out_total, int32_t n,
                        int32_t tail) {
  const int64_t b = (int64_t)blockIdx.x * 32 + threadIdx.x;
  if (b >= n) return;
  const Lz4ttParseSrc src = {comp + b * comp_stride, nullptr, 0, 0};
  const Lz4ttSeqRow row = lz4tt_seq_row(tables, n, max_seq, b);
  Lz4ttParseAt at = {0, 0, 0, 0};
  int32_t code;
  do {
    code = lz4tt_parse_seq(src, comp_lens[b], max_seq, row, at);
  } while (code == LZ4TT_PARSE_MORE);
  n_seq[b] = code == LZ4TT_PARSE_DONE ? at.n : code;
  out_total[b] = code == LZ4TT_PARSE_DONE ? at.d : 0;
  if (tail != 0)
    lz4tt_parse_sentinel(HostTeam(), row, n_seq[b], max_seq, tail);
}

}  // namespace"""
_PARSE_THREAD_LAUNCH = """    cudaMemsetAsync(tables, 0, sizeof(int32_t) * 6 * (size_t)n * max_seq,
                    (cudaStream_t)stream);
    parse_thread_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>("""
# lane 0 walks the whole block, 3-byte sequences four at a time (K1's run)
# staged in shared memory and written out by the warp with coalesced
# stores, any other sequence by the serial rules
_PARSE_BODY = "// Parse one block into its row of the tables by the team, the zero tails"
_PARSE_LEADER = """template <class Team>
LZ4TT_HD int32_t lz4tt_parse_block_leader(const Team& t, const uint8_t* block,
                                          int32_t src_len, int32_t max_seq,
                                          const Lz4ttSeqRow& row, uint8_t* win,
                                          int32_t* stage, int32_t* out_total) {
  Lz4ttParseSrc src = {block, win, 0, 0};
  Lz4ttParseAt at = {0, 0, 0, 0};
  int32_t code = LZ4TT_PARSE_MORE;
  while (code == LZ4TT_PARSE_MORE) {
    if (src.hi < src_len && at.s + LZ4TT_PARSE_AHEAD > src.hi)
      lz4tt_parse_fill(t, src, at.s, src_len, win);
    int32_t k = 0;
    const int32_t n0 = at.n;
    if (t.leader()) {
      while (k <= 28 && at.s + 12 <= src_len && at.n + k + 4 <= max_seq) {
        int32_t tk[4], ds[4];
#pragma unroll
        for (int j = 0; j < 4; j++) {
          tk[j] = src[at.s + 3 * j];
          ds[j] = src[at.s + 3 * j + 1] | (src[at.s + 3 * j + 2] << 8);
        }
        int j = 0;
        for (; j < 4; j++) {
          if (tk[j] > 14 || at.d < ds[j]) break;
          const int32_t m = tk[j] + LZ4TT_MIN_MATCH;
          stage[k] = at.d;
          stage[32 + k] = at.s + 1;
          stage[64 + k] = 0;
          stage[96 + k] = at.d;
          stage[128 + k] = ds[j];
          stage[160 + k] = ds[j] ? m : 0;
          k++;
          at.d += m;
          at.s += 3;
        }
        if (j < 4) break;
      }
    }
    k = t.bcast(k);
    t.sync();
    for (int32_t i = t.lane(); i < k; i += t.size()) {
      row.lit_out[n0 + i] = stage[i];
      row.lit_src[n0 + i] = stage[32 + i];
      row.lit_len[n0 + i] = stage[64 + i];
      row.m_out[n0 + i] = stage[96 + i];
      row.m_dist[n0 + i] = stage[128 + i];
      row.m_len[n0 + i] = stage[160 + i];
    }
    t.sync();
    at.n = n0 + k;
    if (t.leader() && k <= 28) code = lz4tt_parse_seq(src, src_len, max_seq, row, at);
    code = t.bcast(code);
    at = {t.bcast(at.s), t.bcast(at.d), t.bcast(at.n), t.bcast(at.lit)};
  }
""" + _ZERO_TAILS + """  *out_total = code == LZ4TT_PARSE_DONE ? at.d : 0;
  return code == LZ4TT_PARSE_DONE ? at.n : code;
}

""" + _PARSE_BODY
_PARSE_WINS = "  __shared__ __align__(16) uint8_t wins[kWarpsPerCta][LZ4TT_PARSE_WIN];"
_PARSE_CALL = "wins[warp], &total);"
_PARSE_CHAIN = "    if (lz4tt_parse_chain(t, src, src_len, max_seq, row, at)) continue;\n"
_PARSE_CHUNK = "// The 16 bytes src[i, i + 16) into a"
# lane 0 walks on by the serial rules until the next two sequences look
# like 3-byte ones, or its window runs short
_PARSE_WALK = """LZ4TT_HD int32_t lz4tt_parse_walk(const Lz4ttParseSrc& src, int32_t src_len,
                                  int32_t max_seq, const Lz4ttSeqRow& row,
                                  Lz4ttParseAt& w) {
  int32_t code;
  do {
    code = lz4tt_parse_seq(src, src_len, max_seq, row, w);
  } while (code == LZ4TT_PARSE_MORE &&
           (src.hi == src_len || w.s + LZ4TT_PARSE_AHEAD <= src.hi) &&
           !(w.s + 4 <= src_len && src.near(w.s) < LZ4TT_ML_MASK &&
             src.near(w.s + 3) < LZ4TT_ML_MASK));
  return code;
}

"""
_PARSE_NEAR = "    return win[i - lo];\n  }\n};"
_PARSE_NEAR_GLOBAL = "    return src[i];\n  }\n};"
_PACK_ALIGNED = "  const int32_t a1 = head + ((n - head) & ~15);"

# name -> (source, [(file, old, new)]): every occurrence of old is replaced
_HC_SPEC = "  LZ4TT_HC_SPEC_ATTEMPTS = 16,"
_HC_INSERT = """// _insert (jax_hc.py:41-59): positions ntu..off-1, a lane a position;
// returns the head table's entry of hash hc after them (cur's bucket: no
// load of the head table after the inserts' stores).
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_insert(const Team& t, Lz4ttHc& z, int32_t off,
                                 uint32_t hc) {
  if (z.ntu >= off) return z.ht()[hc];
  const int lane = t.lane(), size = t.size();
  int32_t head = -1;
  t.sync();
  for (int32_t b = z.ntu; b < off; b += size) {
    const int32_t p = b + lane;
    // one value for the idle lanes: match_any's time grows with the
    // distinct values
    const uint32_t h = p < off ? lz4tt_hc_hash(lz4tt_read32(z.src, p)) : ~0u;
    const int32_t rk = z.spec && p < off ? z.rank()[p] : 0;
    const int32_t before = z.ht()[hc];
    // a batch of one (most searches on incompressible data) needs no match
    const unsigned group = off - b > 1 ? t.match_any(h) : lane == 0 ? 1u : 0u;
    const unsigned below = group & ((1u << lane) - 1u);
    const int32_t prev =
        below ? b + lz4tt_fls(below) : p < off ? lz4tt_hc_head_pos(z, z.ht()[h]) : 0;
    t.sync();  // every lane has read the head table
    if (p < off) {
      int32_t delta = p - prev;
      if (delta > LZ4TT_MAX_DISTANCE - 1) delta = LZ4TT_MAX_DISTANCE - 1;
      lz4tt_hc_link(z, p, rk, (uint16_t)delta);
      if ((group >> lane) == 1u) z.ht()[h] = lz4tt_hc_head(z, p, rk);
    }
    if (b + size >= off) {  // the last batch: cur's bucket's newest
      const unsigned mine = t.ballot(h == hc);
      const int k = mine ? lz4tt_fls(mine) : 0;
      const int32_t rk_k = t.shfl(rk, k);
      head = mine ? lz4tt_hc_head(z, b + k, rk_k) : before;
    }
    t.sync();
  }
  z.ntu = off;
  return head;
}
"""
_HC_SERIAL_INSERT = """// _insert (jax_hc.py:41-59): the leader adds positions ntu..off-1.
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_insert(const Team& t, Lz4ttHc& z, int32_t off,
                                 uint32_t hc) {
  if (z.ntu < off) {
    t.sync();
    if (t.leader()) {
      for (int32_t p = z.ntu; p < off; p++) {
        const uint32_t h = lz4tt_hc_hash(lz4tt_read32(z.src, p));
        const int32_t rk = z.spec ? z.rank()[p] : 0;
        int32_t delta = p - lz4tt_hc_head_pos(z, z.ht()[h]);
        if (delta > LZ4TT_MAX_DISTANCE - 1) delta = LZ4TT_MAX_DISTANCE - 1;
        lz4tt_hc_link(z, p, rk, (uint16_t)delta);
        z.ht()[h] = lz4tt_hc_head(z, p, rk);
      }
    }
    z.ntu = off;
    t.sync();
  }
  return z.ht()[hc];
}
"""
_HC_FIRST = """  // the words after and before cur; the records' words serve while the
  // first forward word lies below match_limit
  const bool ahead = off + 2 * LZ4TT_MIN_MATCH <= z.match_limit;
  const uint32_t cur_ahead = ahead ? lz4tt_read32(src, off + LZ4TT_MIN_MATCH) : 0u;
  const uint32_t cur_back = kWide ? lz4tt_hc_word_in(src, off - 4, off) : 0u;
  // the backward length stops at start_limit on cur's side
  const int32_t back_max = off - start_limit > 0 ? off - start_limit : 0;
  int32_t left = z.max_attempts;
  int32_t r = rc >= 0 ? rc : z.rank()[c];
  // lane k's candidate of this step (the k-th after the first true one)
  // and of the next step
  Lz4ttHcRec x = lz4tt_hc_rec(z, r - lane), x2 = lz4tt_hc_rec(z, r - size - lane);
"""
_HC_FIRST_SERIAL = """  // The first candidate as the serial loop probes it, its rank loading
  // beside it: where chains are short (incompressible data), most walks
  // end there, and the index costs them nothing.
  int32_t r = rc >= 0 ? rc : z.rank()[c];
  int32_t next = c - z.chain()[c & LZ4TT_HC_MASK];
  if (lz4tt_read32(src, c) == cur) {
    const int32_t fwd = LZ4TT_MIN_MATCH +
        lz4tt_hc_common(t, src, c + LZ4TT_MIN_MATCH, off + LZ4TT_MIN_MATCH,
                        z.match_limit);
    const int32_t bwd = kWide ? lz4tt_hc_back(t, src, c, off, 0, start_limit) : 0;
    if (fwd + bwd > m.len) {
      m.len = fwd + bwd;
      m.ref = c - bwd;
      m.start = off - bwd;
    }
  }
  int32_t left = z.max_attempts - 1;
  if (left == 0 || next < lo || next > off) return;
  // the words after and before cur; the records' words serve while the
  // first forward word lies below match_limit
  const bool ahead = off + 2 * LZ4TT_MIN_MATCH <= z.match_limit;
  const uint32_t cur_ahead = ahead ? lz4tt_read32(src, off + LZ4TT_MIN_MATCH) : 0u;
  const uint32_t cur_back = kWide ? lz4tt_hc_word_in(src, off - 4, off) : 0u;
  // the backward length stops at start_limit on cur's side
  const int32_t back_max = off - start_limit > 0 ? off - start_limit : 0;
  // lane k's candidate of this step (the k-th after the true next) and
  // of the next step, speculated from c's bucket
  r -= 1;
  Lz4ttHcRec x = lz4tt_hc_rec(z, r - lane), x2 = lz4tt_hc_rec(z, r - size - lane);
  if (t.shfl(x.pos, 0) != next) {  // c's own link left its bucket's order
    if (t.leader()) LZ4TT_HC_FOLLOWED();
    r = z.rank()[next];
    x = lz4tt_hc_rec(z, r - lane);
    x2 = lz4tt_hc_rec(z, r - size - lane);
  }
"""
_HC_LINKS = """    // lane k's link holds if its true next is lane k + 1's candidate, or
    // both leave the window; the last lane's is checked against the next
    // slice when the walk goes on
    const int32_t nx = t.shfl(s, lane + 1 < size ? lane + 1 : lane);
    const bool holds = in && (lane + 1 == size || next == nx ||
                              ((next < lo || next > off) && (nx < lo || nx > off)));"""
_HC_LINKS_OWN = """    // lane k's link holds if its true next is lane k + 1's candidate (the
    // last lane's: the next slice's first), or both leave the window
    const int32_t after = t.shfl(s, lane + 1 < size ? lane + 1 : 0);
    const int32_t first2 = t.shfl(x2.pos, 0);
    const int32_t nx = lane + 1 < size ? after : first2;
    const bool holds = in && (next == nx || ((next < lo || next > off) &&
                                             (nx < lo || nx > off)));"""
_HC_GRID = "    const int grid = n < teams ? n : teams;"
_HC_BOUNDS = "__global__ void __launch_bounds__(32, 32)"


def _hc_teams_an_sm(k: int) -> str:
    return f"""    int dev = 0, sms = 1;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const int grid = n < teams ? (n < {k} * sms ? n : {k} * sms)
                               : (teams < {k} * sms ? teams : {k} * sms);"""


VARIANTS = {
    "K2": ("lz4_compress", []),
    "K2, row staged in shared memory (2 CTAs an SM)": ("lz4_compress", [
        ("lz4_compress.cu", """  lz4tt_compress_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,""",
         _STAGED),
        ("lz4_compress.cu", "cudaSharedmemCarveoutMaxShared);",
         "cudaSharedmemCarveoutMaxShared) ? cudaErrorUnknown : "
         "cudaFuncSetAttribute(compress_kernel, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "LZ4TT_TABLE_BYTES + 65552);"),
        ("lz4_compress.cu", "compress_kernel<<<n, 32, LZ4TT_TABLE_BYTES,",
         "compress_kernel<<<n, 32, LZ4TT_TABLE_BYTES + 65552,")]),
    "K2, default carve-out": ("lz4_compress", [
        ("lz4_compress.cu", "cudaSharedmemCarveoutMaxShared",
         "cudaSharedmemCarveoutDefault")]),
    "K2, the match's first word read after the probe": ("lz4_compress", [
        ("lz4_compress.cuh", "if (pre && x != 0 && z.s + 4 <= src_limit)",
         "if (false && x != 0 && z.s + 4 <= src_limit)")]),
    "K2, aligned words and funnel shifts for reads": ("lz4_compress", [
        ("lz4_compress.cuh", '#include "lz4tt_common.cuh"\n', _WORDS),
        ("lz4_compress.cuh", "lz4tt_read32(", "lz4tt_load32u(")]),
    "K1": ("lz4_decode", []),
    "K1, no four-token run": ("lz4_decode", [
        ("lz4_decode.cuh", "      while (n <= LZ4TT_BATCH - 4 &&",
         "      while (false && n <= LZ4TT_BATCH - 4 &&")]),
    "K1, lane copies of at most 16 bytes": ("lz4_decode", [
        ("lz4_decode.cuh", "  LZ4TT_LANE_COPY = 64,", "  LZ4TT_LANE_COPY = 16,")]),
    "K1, 2 KiB ring": ("lz4_decode", [
        ("lz4_decode.cuh", _RING, "  LZ4TT_RING = 2048,"),
        ("lz4_decode.cuh", _NEAR,
         "enum { LZ4TT_RING_FLUSH = 768, LZ4TT_RING_NEAR = 1408 };")]),
    "K1, 8 KiB ring": ("lz4_decode", [
        ("lz4_decode.cuh", _RING, "  LZ4TT_RING = 8192,"),
        ("lz4_decode.cuh", _NEAR,
         "enum { LZ4TT_RING_FLUSH = 4096, LZ4TT_RING_NEAR = 6144 };")]),
    "K5": ("segment_decode", []),
    "K5, each window's tables loaded when it starts": ("segment_decode", [
        ("segment_decode.cuh",
         "    const Lz4ttSeq cur = next;  // sequence k0 + lane; the next "
         "window's loads fly",
         "    const Lz4ttSeq cur = k0 + lane < ns ? lz4tt_seq_load(s, k0 + lane)"
         " : next;"),
        ("segment_decode.cuh",
         "    if (k0 + w + lane < ns) next = lz4tt_seq_load(s, k0 + w + lane);",
         "")]),
    "parser": ("lz4_parse", []),
    "parser, one thread a block from device memory (the kernel before)": (
        "lz4_parse", [
            ("lz4_parse.cuh", _PARSE_NEAR, _PARSE_NEAR_GLOBAL),
            ("lz4_parse.cu", _PARSE_NS, _PARSE_THREAD),
            ("lz4_parse.cu", _PARSE_LAUNCH, _PARSE_THREAD_LAUNCH)]),
    "parser, lane 0 walks, four-token runs staged and written by the warp": (
        "lz4_parse", [
            ("lz4_parse.cuh", _PARSE_BODY, _PARSE_LEADER),
            ("lz4_parse.cu", _PARSE_WINS, _PARSE_WINS
             + "\n  __shared__ int32_t stages[kWarpsPerCta][6 * 32];"),
            ("lz4_parse.cu", "lz4tt_parse_block(t, comp",
             "lz4tt_parse_block_leader(t, comp"),
            ("lz4_parse.cu", _PARSE_CALL, "wins[warp], stages[warp], &total);")]),
    "parser, tables zeroed by the wrapper": ("lz4_parse", [
        ("lz4_parse.cuh", _ZERO_TAILS, ""),
        ("lz4_parse.cu", _PARSE_LAUNCH, _PARSE_MEMSET)]),
    "parser, the block read from device memory (no window)": ("lz4_parse", [
        ("lz4_parse.cuh", _PARSE_NEAR, _PARSE_NEAR_GLOBAL),
        ("lz4_parse.cuh", "  if (r.hi < src_len && s + LZ4TT_PARSE_AHEAD > r.hi)",
         "  if (false)")]),
    "parser, no chain: lane 0 walks one sequence a step": ("lz4_parse", [
        ("lz4_parse.cuh", _PARSE_CHAIN, "")]),
    "parser, no chain: lane 0 walks until two 3-byte tokens": ("lz4_parse", [
        ("lz4_parse.cuh", _PARSE_CHAIN, ""),
        ("lz4_parse.cuh", _PARSE_CHUNK, _PARSE_WALK + _PARSE_CHUNK),
        ("lz4_parse.cuh", "if (t.leader()) code = lz4tt_parse_seq(",
         "if (t.leader()) code = lz4tt_parse_walk(")]),
    "pack": ("frame_pack", []),
    "pack, byte-wise stores": ("frame_pack", [
        ("frame_pack.cuh", _PACK_ALIGNED, "  const int32_t a1 = head;")]),
    "pack, one 16-byte store a lane in flight": ("frame_pack", [
        ("frame_pack.cuh", "#define LZ4TT_PACK_UNROLL 4", "#define LZ4TT_PACK_UNROLL 1")]),
    "update": ("xxh32", []),
    "update, 8 stages of 8 KiB": ("xxh32", [
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 8192\n#define LZ4TT_XXH_STAGES 8")]),
    "update, 4 stages of 16 KiB": ("xxh32", [
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 16384\n#define LZ4TT_XXH_STAGES 4")]),
    "update, 3 stages of 64 KiB": ("xxh32", [
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 65536\n#define LZ4TT_XXH_STAGES 3")]),
    "update, 2 stages of 4 KiB": ("xxh32", [
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 4096\n#define LZ4TT_XXH_STAGES 2")]),
    "update, rounds as rotl(v + x * P2, 13) * P1": ("xxh32", [
        ("xxh32.cuh", "#define LZ4TT_XXH_GROUP 8  // stripes loaded together\n",
         "#define LZ4TT_XXH_GROUP 8\n" + _ROUND),
        ("xxh32.cuh", "  uint32_t w = v + lz4tt_ld32(q) * LZ4TT_P2;",
         "  uint32_t w = lz4tt_xxh_round(v, lz4tt_ld32(q));"),
        ("xxh32.cuh", "w = lz4tt_xxh32_step(w, a[j] * LZ4TT_P2);",
         "w = lz4tt_xxh_round(w, a[j]);"),
        ("xxh32.cuh", "  return lz4tt_rotl32(w, 13) * LZ4TT_P1;\n}", "  return w;\n}")]),
    "update, carried form in plain C (no explicit multiply-add)": ("xxh32", [
        ("xxh32.cuh", "      w = lz4tt_xxh32_step(w, a[j] * LZ4TT_P2);",
         "      w = lz4tt_rotl32(w, 13) * LZ4TT_P1 + a[j] * LZ4TT_P2;")]),
    "update, one consumer carrying the four lanes": ("xxh32", [
        ("xxh32.cuh", "// The hash of the len bytes at p",
         _ONE_CONSUMER_BODY + "// The hash of the len bytes at p"),
        ("xxh32.cu", _PREPARED, _ONE_CONSUMER_KERNEL),
        ("xxh32.cu", _STREAM_LAUNCH32,
         "  cudaFuncSetAttribute(xxh32_one_consumer_kernel, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, lz4tt_xxh_smem(1));\n"
         "  if (n_stripes > 0)\n"
         "    xxh32_one_consumer_kernel<<<1, 64, lz4tt_xxh_smem(1), "
         "(cudaStream_t)stream>>>(")]),
    "update, one thread loading from global memory": ("xxh32", [
        ("xxh32.cu", _PREPARED, _THREAD_ROWS32),
        ("xxh32.cu", _STREAM_LAUNCH32,
         "  if (n_stripes > 0)\n"
         "    xxh32_global_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(")]),
    "K3, one thread a row (the kernel before the ring)": ("xxh32", [
        ("xxh32.cu", _PREPARED, _THREAD_ROWS32),
        ("xxh32.cu", _BATCH_LAUNCH32,
         "    xxh32_thread_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>("
         "(const uint8_t*)data, stride, (const int32_t*)lens, seed, "
         "(uint32_t*)out, n);")]),
    "K3, one CTA a row (4 stages of 32 KiB)": ("xxh32", [
        (_RING_H, _ROWS, "#define LZ4TT_XXH_ROWS 1")]),
    "K3, one CTA a row, 4 stages of 4 KiB": ("xxh32", [
        (_RING_H, _ROWS, "#define LZ4TT_XXH_ROWS 1"),
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 4096\n#define LZ4TT_XXH_STAGES 4")]),
    "K3, 4 stages of 8 KiB, up to 32 rows a CTA": ("xxh32", [
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 8192\n#define LZ4TT_XXH_STAGES 4")]),
    "K4": ("xxh64", []),
    "K4, one thread a row (the kernels before the ring)": ("xxh64", [
        ("xxh64.cu", _PREPARED64, _THREAD64),
        ("xxh64.cu", _BATCH_LAUNCH64,
         "    xxh64_thread_kernel<<<(n + 31) / 32, 32, 0, (cudaStream_t)stream>>>("
         "(const uint8_t*)data, stride, (const int32_t*)lens, (uint64_t)seed, "
         "(uint64_t*)out, n);"),
        ("xxh64.cu", _STREAM_LAUNCH64,
         "    xxh64_thread_stream_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(")]),
    "K4, rounds as rotl(v + x * Q2, 31) * Q1": ("xxh64", [
        ("xxh64.cuh", "  uint64_t w = v + lz4tt_ld64(q) * LZ4TT_Q2;",
         "  uint64_t w = lz4tt_xxh64_round(v, lz4tt_ld64(q));"),
        ("xxh64.cuh", "w = lz4tt_xxh64_step(w, a[j] * LZ4TT_Q2);",
         "w = lz4tt_xxh64_round(w, a[j]);"),
        ("xxh64.cuh", "  return lz4tt_rotl64(w, 31) * LZ4TT_Q1;\n}", "  return w;\n}")]),
    "K4, carried form in plain C (no explicit multiply-add)": ("xxh64", [
        ("xxh64.cuh", "      w = lz4tt_xxh64_step(w, a[j] * LZ4TT_Q2);",
         "      w = lz4tt_rotl64(w, 31) * LZ4TT_Q1 + a[j] * LZ4TT_Q2;")]),
    "K4, one CTA a row (4 stages of 32 KiB)": ("xxh64", [
        (_RING_H, _ROWS, "#define LZ4TT_XXH_ROWS 1")]),
    "K4, one CTA a row, 4 stages of 4 KiB": ("xxh64", [
        (_RING_H, _ROWS, "#define LZ4TT_XXH_ROWS 1"),
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 4096\n#define LZ4TT_XXH_STAGES 4")]),
    "K4, 3 stages of 64 KiB": ("xxh64", [
        (_RING_H, _STAGES,
         "#define LZ4TT_XXH_STAGE 65536\n#define LZ4TT_XXH_STAGES 3")]),
    "K6": ("lz4_hc", []),
    "K6, serial walk (the kernel before)": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_SPEC, "  LZ4TT_HC_SPEC_ATTEMPTS = 1 << 30,"),
        ("lz4_hc.cuh", _HC_INSERT, _HC_SERIAL_INSERT)]),
    "K6, serial inserts": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_INSERT, _HC_SERIAL_INSERT)]),
    "K6, a walk's first candidate probed serially": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_FIRST, _HC_FIRST_SERIAL)]),
    "K6, the index built, the walk serial (the index's cost)": ("lz4_hc", [
        ("lz4_hc.cuh", "  if (z.spec) {\n    lz4tt_hc_walk<false>",
         "  if (false) {\n    lz4tt_hc_walk<false>"),
        ("lz4_hc.cuh", "  if (z.spec) {\n    lz4tt_hc_walk<true>",
         "  if (false) {\n    lz4tt_hc_walk<true>")]),
    "K6, the searches and the encoder called, not inlined": ("lz4_hc", [
        ("lz4_hc.cuh", f"LZ4TT_HD {head}", f"__host__ __device__ __noinline__ {head}")
        for head in ("Lz4ttHcMatch lz4tt_hc_best(", "bool lz4tt_hc_wider(",
                     "bool lz4tt_hc_encode(")]),
    "K6, the last lane's link checked at the next step": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_LINKS_OWN, _HC_LINKS),
        ("lz4_hc.cuh", "    if (kf == size) {  // every link held: c is the next slice's first",
         "    if (p == size && t.shfl(x2.pos, 0) == c) {  // every link held")]),
    "K6, the head loaded after the inserts": ("lz4_hc", [
        ("lz4_hc.cuh", "  const int32_t head = lz4tt_hc_insert(t, z, off, lz4tt_hc_hash(cur));",
         "  lz4tt_hc_insert(t, z, off, lz4tt_hc_hash(cur));\n"
         "  const int32_t head = z.ht()[lz4tt_hc_hash(cur)];")]),
    "K6, speculation from level 3": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_SPEC, "  LZ4TT_HC_SPEC_ATTEMPTS = 4,")]),
    "K6, speculation from level 4": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_SPEC, "  LZ4TT_HC_SPEC_ATTEMPTS = 8,")]),
    "K6, speculation from level 6": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_SPEC, "  LZ4TT_HC_SPEC_ATTEMPTS = 32,")]),
    "K6, registers unbounded (fewer teams an SM)": ("lz4_hc", [
        ("lz4_hc.cu", _HC_BOUNDS, "__global__ void __launch_bounds__(32)")]),
    "K6, at most 8 teams an SM": ("lz4_hc", [
        ("lz4_hc.cu", _HC_GRID, _hc_teams_an_sm(8))]),
    "K6, at most 16 teams an SM": ("lz4_hc", [
        ("lz4_hc.cu", _HC_GRID, _hc_teams_an_sm(16))]),
}

_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGS = [_P, _I64, _P, _P, _I64, _I32, _P, _P, _I32, _P]
SYMBOLS = {  # source -> (C entry point, its argtypes)
    "lz4_compress": ("lz4tt_compress_fast", _ARGS),
    "lz4_decode": ("lz4tt_decompress_safe", _ARGS),
    "segment_decode": ("lz4tt_decompress_segments",
                       [_P, _I64, _P, _P, _P, _I32, _P, _I64, _I32, _P, _I32, _P]),
    "lz4_parse": ("lz4tt_parse_sequences", [_P, _I64, _P, _I32, _P, _P, _P, _I32, _P]),
    "frame_pack": ("lz4tt_frame_pack", [_P, _I64, _P, _P, _I64, _P, _P, _P, _I32, _P]),
    "xxh32": ("lz4tt_xxh32_batch", [_P, _I64, _P, ctypes.c_uint, _P, _I32, _P]),
    "xxh64": ("lz4tt_xxh64_batch",
              [_P, _I64, _P, ctypes.c_ulonglong, _P, _I32, _P]),
    "lz4_hc": ("lz4tt_compress_hc",
               [_P, _I64, _P, _P, _I64, _I32, _I32, _P, _I32, _P, _P, _I32, _P]),
}
# the hash sources' launches, each timed: the one-shot entry point on the
# 4096 rows and on one 16 MiB row, the update on the same 16 MiB
HASH_SETS = ("4096 rows", "one 16 MiB row", "update, 16 MiB")


# K6 with clock64 counters (--hc-split): the parts of its searches, timed
# by the first team's lane 0
_SPLIT_PARTS = ("best: insert and head", "best: walk", "wider: insert and head",
                "wider: walk", "index", "phase machine, all")
_SPLIT_EDITS = [
    ("lz4_hc.cuh", "enum {\n  LZ4TT_HC_HASH_LOG = 15,", """#ifdef __CUDACC__
__device__ unsigned long long lz4tt_split[16];
#endif
#ifdef __CUDA_ARCH__
#define PT(v) const long long v = clock64()
#define PA(i, a, b) if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  lz4tt_split[i] += (b) - (a); lz4tt_split[(i) + 8] += 1; }
#else
#define PT(v)
#define PA(i, a, b)
#endif
enum {
  LZ4TT_HC_HASH_LOG = 15,"""),
    ("lz4_hc.cuh",
     "LZ4TT_HD Lz4ttHcMatch lz4tt_hc_best(const Team& t, Lz4ttHc& z, int32_t off) {\n",
     "LZ4TT_HD Lz4ttHcMatch lz4tt_hc_best(const Team& t, Lz4ttHc& z, int32_t off) {\n"
     "  PT(b0);\n"),
    ("lz4_hc.cuh", "  int32_t rref = z.spec && head != -1",
     "  PT(b1);\n  PA(0, b0, b1);\n  int32_t rref = z.spec && head != -1"),
    ("lz4_hc.cuh", "    lz4tt_hc_walk<false>(t, z, off, cur, ref, rref, lo, 0, m);",
     "    PT(b2);\n    lz4tt_hc_walk<false>(t, z, off, cur, ref, rref, lo, 0, m);\n"
     "    PT(b3);\n    PA(1, b2, b3);"),
    ("lz4_hc.cuh", "                             Lz4ttHcMatch* w) {\n",
     "                             Lz4ttHcMatch* w) {\n  PT(w0);\n"),
    ("lz4_hc.cuh", "  int32_t ref = lz4tt_hc_head_pos(z, head);\n  const int32_t lo",
     "  PT(w1);\n  PA(2, w0, w1);\n  int32_t ref = lz4tt_hc_head_pos(z, head);\n"
     "  const int32_t lo"),
    ("lz4_hc.cuh", "                        lo, start_limit, m);",
     "                        lo, start_limit, m);\n    PT(w3);\n    PA(3, w1, w3);"),
    ("lz4_hc.cuh", "  if (spec)\n    lz4tt_hc_index(",
     "  PT(x0);\n  if (spec)\n    lz4tt_hc_index("),
    ("lz4_hc.cuh", "                   z.rank(), z.rec());",
     "                   z.rank(), z.rec());\n  PT(x1);\n  PA(4, x0, x1);"),
    ("lz4_hc.cuh",
     "  if (!lz4tt_hc_sequences(t, z, src_len, dst, dest_cap, dst_width, d, anchor))\n",
     "  PT(q0);\n  const bool all = lz4tt_hc_sequences(t, z, src_len, dst, dest_cap,\n"
     "                                      dst_width, d, anchor);\n"
     "  PT(q1);\n  PA(5, q0, q1);\n  if (!all)\n"),
    ("lz4_hc.cu", "// Bytes of scratch a team needs.", """extern "C" int lz4tt_split_read(unsigned long long* h, int zero) {
  const unsigned long long none[16] = {};
  const cudaError_t e = cudaMemcpyFromSymbol(h, lz4tt_split, sizeof(none));
  return (int)(zero && e == cudaSuccess
                   ? cudaMemcpyToSymbol(lz4tt_split, none, sizeof(none))
                   : e);
}

// Bytes of scratch a team needs."""),
]


def _nvcc_copy(d, edits, source: str):
    """``csrc`` copied to ``d`` with ``edits``, and the nvcc process that
    builds ``source`` there."""
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(build.CSRC, d)
    for fname, old, new in edits:
        text = (d / fname).read_text()
        if old not in text:
            raise ValueError(f"{old!r} is not in {fname}")
        (d / fname).write_text(text.replace(old, new))
    so = d / f"lib{source}.so"
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(so),
           str(d / f"{source}.cu")]
    return so, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)


def hc_split() -> dict:
    """Cycles of each part of K6's searches (``_SPLIT_PARTS``) at level 9
    in the first team's lane 0: one a4 row alone, then team 0 of 4,096 a4
    rows; each part's total cycles, calls and cycles a call."""
    so, proc = _nvcc_copy(build.build_dir().parent / "variants" / "split",
                          _SPLIT_EDITS, "lz4_hc")
    log, _ = proc.communicate()
    if proc.returncode:
        raise build.KernelBuildError(log)
    lib = ctypes.CDLL(str(so))
    fn = lib.lz4tt_compress_hc
    fn.argtypes, fn.restype = SYMBOLS["lz4_hc"][1], ctypes.c_int
    rows = _Rows(torch.device("cuda"))
    a4 = rows.sets["a4"]
    teams = hc.resident_teams(rows.src.device.index or 0)
    scratch = torch.empty((teams * hc.team_bytes(),), dtype=torch.uint8,
                          device=rows.src.device)
    stream = torch.cuda.current_stream().cuda_stream
    counts = (ctypes.c_ulonglong * 16)()
    out = {}
    for name, pick in (("1 a4 row", a4[:1]),
                       ("4096 a4 rows, team 0", a4.repeat(2)[:N_BLOCKS])):
        src, lens = rows.src[pick].contiguous(), rows.lens[pick].contiguous()
        want = hc.compress_hc_batch(src, lens, rows.cap, 9)
        dest, out_lens, err = (torch.empty_like(x) for x in want)
        lib.lz4tt_split_read(counts, 1)
        n = src.shape[0]
        if fn(src.data_ptr(), src.stride(0), lens.data_ptr(), dest.data_ptr(),
              dest.stride(0), rows.cap, 9, scratch.data_ptr(), min(n, teams),
              out_lens.data_ptr(), err.data_ptr(), n, stream):
            raise RuntimeError("CUDA error")
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in
                   zip((dest, out_lens, err), want)):
            raise SystemExit(f"design_variants: the split build differs on {name}")
        lib.lz4tt_split_read(counts, 0)
        out[name] = {part: {"cycles": counts[i], "calls": counts[i + 8],
                            "a call": round(counts[i] / max(counts[i + 8], 1), 1)}
                     for i, part in enumerate(_SPLIT_PARTS)}
        print(f"K6 split, {name}: {json.dumps(out[name])}", flush=True)
    return out


def build_variants(sources: set[str]) -> dict:
    """name -> (source, .so path, nvcc's register lines) of the variants of
    ``sources``; all at once."""
    root = build.build_dir().parent / "variants"
    procs = []
    for i, (name, (source, edits)) in enumerate(VARIANTS.items()):
        if source not in sources:
            continue
        try:
            so, proc = _nvcc_copy(root / str(i), edits, source)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from None
        procs.append((name, source, so, proc))
    out = {}
    for name, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}:\n{log}")
        out[name] = (source, so, [ln.split(":", 1)[1].strip()
                                  for ln in log.splitlines() if "Used" in ln])
    return out


def _time(call, reps: int = REPS) -> float:
    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


class _Rows:
    """The main path's rows on the card, what each source is timed on."""

    def __init__(self, dev):
        self.src, self.lens = sharded.upload_blocks(
            sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED), dev)
        self.cap = max_compressed_length(BLOCK_LEN)
        self.comp, self.clens, _ = codec.compress_fast_batch(
            self.src, self.lens, self.cap)
        self.tables, self.n_seq, self.total = sequences.parse_sequences(
            self.comp, self.clens)
        kinds = torch.from_numpy(sharded.block_kinds(N_BLOCKS, SEED)).to(dev)
        self.sets = {"all": torch.arange(N_BLOCKS, device=dev),
                     "a4": torch.nonzero(kinds == 0).flatten(),
                     "text": torch.nonzero(kinds == 1).flatten(),
                     "256 rows": torch.arange(256, device=dev)}
        # one stream batch: 256 blocks, 16 MiB, also hashed as one row
        self.batch = self.src[:256, :BLOCK_LEN].contiguous().view(-1)
        self.one = self.batch.view(1, -1)
        self.one_len = torch.tensor([self.batch.numel()], dtype=torch.int32,
                                    device=dev)
        self.hashes = {}
        self.hc = {}

    def hc_sets(self) -> dict:
        """set name -> (level, rows, lens, the shipped K6's output) of the
        K6 launches, and one scratch for all of them."""
        if not self.hc:
            a4 = self.sets["a4"]
            for level in HC_ALL_LEVELS:
                self.hc[f"level {level}, 4096 rows"] = (level, self.src,
                                                        self.lens)
            for level in HC_A4_LEVELS:
                for n in HC_A4_ROWS:
                    pick = a4.repeat(-(-n // a4.numel()))[:n]
                    self.hc[f"level {level}, {n} a4 rows"] = (
                        level, self.src[pick].contiguous(),
                        self.lens[pick].contiguous())
            for name, (level, src, lens) in self.hc.items():
                self.hc[name] = (level, src, lens, hc.compress_hc_batch(
                    src, lens, self.cap, level))
            dev = self.src.device
            self.teams = hc.resident_teams(dev.index or 0)
            self.hc_scratch = torch.empty(
                (min(N_BLOCKS, self.teams) * hc.team_bytes(),),
                dtype=torch.uint8, device=dev)
        return self.hc

    def hash_sets(self, bits: int) -> dict:
        """set name -> (input, the shipped kernel's output) of the XXH
        ``bits`` launches; the update's input is its starting lanes."""
        if bits not in self.hashes:
            batch, state, absorb = (
                (xxhash.xxh32_batch, xxhash_stream.StreamState32,
                 xxhash_stream.absorb32) if bits == 32 else
                (xxhash.xxh64_batch, xxhash_stream.StreamState64,
                 xxhash_stream.absorb64))
            lanes = state(SEED, self.src.device).lanes
            after = lanes.clone()
            absorb(after, self.batch)
            self.hashes[bits] = {
                "4096 rows": ((self.src, self.lens),
                              batch(self.src, self.lens, SEED)),
                "one 16 MiB row": ((self.one, self.one_len),
                                   batch(self.one, self.one_len, SEED)),
                "update, 16 MiB": (lanes, after)}
        return self.hashes[bits]


def _hash_calls(lib, source: str, rows: _Rows, set_name: str, stream):
    """(call, check) of one hash variant's launch ``set_name`` (one of
    ``HASH_SETS``), as :func:`_calls`."""
    bits = 32 if source == "xxh32" else 64
    arg, want = rows.hash_sets(bits)[set_name]
    if set_name.startswith("update"):
        fn = getattr(lib, f"lz4tt_xxh{bits}_stream_update")
        fn.argtypes, fn.restype = [_P, _I64, _P, _P], ctypes.c_int
        lanes = arg.clone()
        n_stripes = rows.batch.numel() * 2 // bits

        def call():
            if fn(rows.batch.data_ptr(), n_stripes, lanes.data_ptr(), stream):
                raise RuntimeError("CUDA error")

        def check():
            lanes.copy_(arg)
            call()
            return torch.equal(lanes, want)
        return call, check
    symbol, argtypes = SYMBOLS[source]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    data, lens = arg
    out = torch.empty_like(want)

    def call():
        if fn(data.data_ptr(), data.stride(0), lens.data_ptr(), SEED,
              out.data_ptr(), data.shape[0], stream):
            raise RuntimeError("CUDA error")

    def check():
        out.zero_()
        call()
        return torch.equal(out, want)
    return call, check


def _hc_calls(fn, rows: _Rows, set_name: str, stream):
    """(call, check) of one K6 variant's launch ``set_name`` (one of
    ``rows.hc_sets()``), as :func:`_calls`."""
    level, src, lens, want = rows.hc_sets()[set_name]
    n = src.shape[0]
    teams = min(n, rows.teams)
    dest, out_lens, err = (torch.empty_like(x) for x in want)

    def call():
        rc = fn(src.data_ptr(), src.stride(0), lens.data_ptr(),
                dest.data_ptr(), dest.stride(0), rows.cap, level,
                rows.hc_scratch.data_ptr(), teams, out_lens.data_ptr(),
                err.data_ptr(), n, stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    def check():   # the scratch poisoned: no table may need a reset
        dest.zero_()
        rows.hc_scratch.fill_(0x5A)
        call()
        return all(torch.equal(x, y) for x, y in
                   zip((dest, out_lens, err), want))
    return call, check


def _calls(fn, source: str, rows: _Rows, idx, stream):
    """(call, check) of one variant's entry point on the rows ``idx``:
    ``call`` launches it once; ``check`` runs it on fresh buffers and says
    whether its output equals the shipped kernel's."""
    dev = rows.src.device

    def launch(*args):
        rc = fn(*args)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")

    n = idx.numel()
    if source == "lz4_parse":
        c, cl = rows.comp[idx].contiguous(), rows.clens[idx].contiguous()
        s = rows.tables.shape[2]
        tables = torch.empty((6, n, s), dtype=torch.int32, device=dev)
        ns, total = (torch.empty((n,), dtype=torch.int32, device=dev)
                     for _ in range(2))

        def call():
            launch(c.data_ptr(), c.stride(0), cl.data_ptr(), s,
                   tables.data_ptr(), ns.data_ptr(), total.data_ptr(), n,
                   stream)

        def check():   # garbage first: every entry must be written
            tables.fill_(0x5A5A5A5A)
            call()
            return torch.equal(ns, rows.n_seq[idx]) and \
                torch.equal(total, rows.total[idx]) and \
                torch.equal(tables, rows.tables[:, idx])
        return call, check
    if source == "frame_pack":
        s, sl = rows.src[idx].contiguous(), rows.lens[idx].contiguous()
        c, cl = rows.comp[idx].contiguous(), rows.clens[idx].contiguous()
        want, total = sharded.frame_body_packed(s, sl, c, cl)
        use_raw = cl >= sl
        emit = torch.where(sl > 0, torch.where(use_raw, sl, cl) + 4, 0)
        offs = (torch.cumsum(emit, 0) - emit).to(torch.int32)
        body = torch.empty_like(want)

        def call():
            launch(s.data_ptr(), s.stride(0), sl.data_ptr(), c.data_ptr(),
                   c.stride(0), cl.data_ptr(), offs.data_ptr(),
                   body.data_ptr(), n, stream)

        def check():
            body.fill_(0xA5)
            call()
            return torch.equal(body, want)
        return call, check
    if source == "segment_decode":
        c, cl = rows.comp[idx].contiguous(), rows.clens[idx].contiguous()
        ns, t = rows.n_seq[idx].contiguous(), rows.tables[:, idx].contiguous()
        out = torch.zeros((n, BLOCK_LEN), dtype=torch.uint8, device=dev)
        err = torch.empty((n,), dtype=torch.int32, device=dev)

        def call():
            launch(c.data_ptr(), c.stride(0), cl.data_ptr(), ns.data_ptr(),
                   t.data_ptr(), t.shape[2], out.data_ptr(), out.stride(0),
                   BLOCK_LEN, err.data_ptr(), n, stream)

        def check():
            out.zero_()
            call()
            return not bool(err.any()) and torch.equal(
                out, rows.src[idx][:, :BLOCK_LEN])
        return call, check
    compress = source == "lz4_compress"
    a, la = (rows.src, rows.lens) if compress else (rows.comp, rows.clens)
    a, la = a[idx].contiguous(), la[idx].contiguous()
    width = rows.comp.shape[1] if compress else rows.src.shape[1]
    out = torch.zeros((n, width), dtype=torch.uint8, device=dev)
    ol = torch.empty((n,), dtype=torch.int32, device=dev)
    err = torch.empty_like(ol)
    w = rows.cap if compress else BLOCK_LEN

    def call():
        launch(a.data_ptr(), a.stride(0), la.data_ptr(), out.data_ptr(),
               out.stride(0), w, ol.data_ptr(), err.data_ptr(), n, stream)

    def check():
        call()
        want = (rows.comp[idx], rows.clens[idx]) if compress else \
            (rows.src[idx], rows.lens[idx])
        return not bool(err.any()) and torch.equal(ol, want[1]) and \
            torch.equal(out[:, :w], want[0][:, :w])
    return call, check


def main(argv: list[str]) -> int:
    """Build and time every variant, or those of the sources named in
    ``argv`` (``lz4_compress``, ``lz4_decode``, ``segment_decode``,
    ``lz4_parse``, ``frame_pack``, ``xxh32``, ``xxh64``, ``lz4_hc``)."""
    if not torch.cuda.is_available():
        print("design_variants: CUDA is not available", file=sys.stderr)
        return 1
    if argv == ["--hc-split"]:
        print(json.dumps(hc_split()))
        return 0
    dev = torch.device("cuda")
    libs = build_variants(set(argv) or set(SYMBOLS))
    rows = _Rows(dev)
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for rnd in range(2):            # two rounds, every variant in each
        for name, (source, so, regs) in libs.items():
            lib = ctypes.CDLL(str(so))
            hashed = source in ("xxh32", "xxh64")
            sets = HASH_SETS if hashed else rows.hc_sets() \
                if source == "lz4_hc" else rows.sets
            for set_name in sets:
                reps = REPS
                if hashed:
                    call, check = _hash_calls(lib, source, rows, set_name,
                                              stream)
                elif source == "lz4_hc":
                    symbol, argtypes = SYMBOLS[source]
                    fn = getattr(lib, symbol)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    call, check = _hc_calls(fn, rows, set_name, stream)
                    reps = HC_REPS
                else:
                    symbol, argtypes = SYMBOLS[source]
                    fn = getattr(lib, symbol)
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    call, check = _calls(fn, source, rows,
                                         rows.sets[set_name], stream)
                if not check():
                    raise SystemExit(f"design_variants: {name} differs from "
                                     f"the shipped kernel on {set_name}")
                ms = _time(call, reps)
                result.setdefault(name, {"registers": regs}).setdefault(
                    set_name, []).append(ms)
                print(f"round {rnd}: {name}, {set_name}: {ms:.3f} ms",
                      flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
