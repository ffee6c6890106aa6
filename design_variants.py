"""Time design variants of block compress (K2), block decode (K1),
segment decode (K5), the hashes (K3, K4 and their streaming updates), the
sequence parser, frame-body packing, LZ4 HC (K6), the parallel compressor
(K7) and the gather decode (K8) against the shipped kernels, on the card.

Each variant is the shipped ``csrc`` with a few text replacements: the
design options ``PERF.md`` reports as tried and lost. Every variant is
built with ``nvcc`` (in parallel, into ``build/lz4_tpu_torch/variants/``)
and timed with CUDA events on the main path's rows (``make_blocks(4096,
65536, 1234)``, its K2 output for K1, the parser and pack, and the
parser's tables of that for K5, with sentinel tails for K8 at max_depth
32): all rows, the a4 and the text rows apart, then the first 256 rows (a
stream batch). A hash variant is timed
on three launches: the one-shot entry point on the 4096 rows and on one
16 MiB row (the first 256 rows end to end), and the update on the same 16
MiB, a stream batch. K6 is timed at levels 1-6, 9 and 17 on the 4096
rows (where the speculated walk starts to pay) and at levels 1, 9 and 17
on 1, 132, 1,056 and 4,096 of their a4 rows (its slowest kind). Each
variant's output is held against the shipped kernel's. A script beside
the package, not part of it: run it from the root of a checkout, on a
machine with a card, for all of them or those of some sources, or for
one of the other modes below::

    python3 design_variants.py [lz4_compress lz4_decode segment_decode lz4_parse frame_pack xxh32 xxh64 lz4_hc parallel_compress gather_decode]
    python3 design_variants.py linked_decode|--resolve|--dict-split|--walk-split|--hc-split|--k7-split|--k1-crossover
    python3 design_variants.py --hc-crossover [rows ...]

K1 is also timed on ``HC9_SET`` (the LZ4 rows of 512 main-path rows at HC
level 9, a read batch of the ``block64k_hc9`` cell), and its variants
include the CTA-a-row kernel's (``lz4tt_decompress_safe_smem``): as
shipped (a walker warp and a copier warp), with 2 or 8 slots, with a
third, idle warp, without the four-token run right after literals, and
with one warp walking and copying in turn, the row's whole output or the
warp kernel's 4 KiB ring in shared memory.
``--k1-crossover`` times both safe kernels at ``CROSSOVER_ROWS`` rows on
the HC-9 and the fast LZ4 rows.

K6's variants include its wide kernel (``lz4tt_compress_hc_wide``, a CTA
a row, at the levels that speculate): as shipped, with 8 warps, and the
control, one warp a row with a wave of four slices in flight.
``--hc-crossover`` times the warp kernel and the wide builds at
``HC_CROSSOVER_ROWS`` rows of a4 rows and of the ``block64k_hc9`` cell's
mix, at level 9.

``--hc-split`` instead builds K6 with ``clock64`` counters in its first
team's lane 0 and prints the cycles of each part of its searches: on one
a4 row alone and on team 0 of 4,096 a4 rows and of 512 rows of the cell's
mix, at level 9, by the warp kernel, and by the wide kernel alone and at
512 rows. ``--k7-split``
does the same for the parts of K7's window kernel, in its first CTA's
thread 0 over its windows, on the main path's rows; ``--dict-split`` for
the parts of one row of K2 with a dictionary (the formats path's rows,
``_DictRows``), beside the dictionary compress's designs.

``linked_decode`` times the linked walk's designs (``LINKED_VARIANTS``:
chunk sizes, the threshold, the one-kernel look-back, the first design)
on the formats path's linked frames at 64 KiB, 256 KiB, 1 MiB and 4 MiB
blocks, each held against the shipped walk, then the linked resolve's
(``resolve_variants``: its first design, rooms for open exits, segments
of 8 and 32 KiB, its parts cumulatively and options tried, on those
frames and on 16 x 4 MiB of far matches; ``--resolve`` alone);
``--walk-split`` the walk's launches one after another.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import numpy as np
import torch

from lz4_tpu_torch import testing
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.kernels import (
    build, codec, gather_decode, hc, layout, linked_decode, parallel_compress,
    sequences, xxhash, xxhash_stream)

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
# FIND's probes in turn, as K2's first design read them: each probe's
# word read after the probe before it (the shipped scan reads it ahead)
_PROBES_IN_TURN = [
    ("lz4_compress.cuh", """        bool found = false;
        // each probe's word read while the probe before it takes its
        // table entry
        uint32_t next = fwd <= mflimit ? w.read32(fwd) : 0u;
        for (;;) {
          s = fwd;
          const uint32_t cur = next;
          fwd += step;
          step = nb >> LZ4TT_SKIP_STRENGTH;
          nb++;
          if (fwd > mflimit) break;
          next = w.read32(fwd);
""", """        bool found = false;
        for (;;) {
          s = fwd;
          fwd += step;
          step = nb >> LZ4TT_SKIP_STRENGTH;
          nb++;
          if (fwd > mflimit) break;
          const uint32_t cur = w.read32(s);
""")]
# K2's scan with the 12-bit table (int32 entries, the window test) on rows
# of 64 KiB too, as the dictionary compress must scan: other bytes, timed
# only, for what the table itself costs
_TABLE_12 = [("lz4_compress.cuh", "  if (src_len < LZ4TT_64K_LIMIT)\n",
              "  if (false)\n")]
# the dictionary compress's first design: a dictionary row's reads branch
# on the position, and the word at a table entry is read only inside the
# window
_DICT_FIRST_READS = [
    ("lz4_compress.cuh",
     "  LZ4TT_HD uint32_t byte(int32_t p) const { return (p < 0 ? dict_end : src)[p]; }\n"
     "  LZ4TT_HD uint32_t read32(int32_t p) const {\n"
     "    return byte(p) | (byte(p + 1) << 8) | (byte(p + 2) << 16) | (byte(p + 3) << 24);\n"
     "  }",
     "  LZ4TT_HD uint32_t byte(int32_t p) const { return p < 0 ? dict_end[p] : src[p]; }\n"
     "  LZ4TT_HD uint32_t read32(int32_t p) const {\n"
     "    if (p >= 0) return lz4tt_read32(src, p);\n"
     "    if (p <= -4) return lz4tt_read32(dict_end, p);\n"
     "    return byte(p) | (byte(p + 1) << 8) | (byte(p + 2) << 16) | (byte(p + 3) << 24);\n"
     "  }"),
    ("lz4_compress.cuh",
     "  const bool same = w.read32(ref) == cur;\n"
     "  return (kSmall || (s - ref < LZ4TT_MAX_DISTANCE && (!W::kDict || s != ref))) &&\n"
     "         same;",
     "  return (kSmall || (s - ref < LZ4TT_MAX_DISTANCE && (!W::kDict || s != ref))) &&\n"
     "         w.read32(ref) == cur;")]
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
# K1 a CTA a row: its ring and capacity check, its threads, the row's call,
# the walk of its walker
_SMEM_RING = "using SmemRing = Lz4ttWhole;"
_SMEM_CHECK = "  if (out_max > SmemRing::kBytes) return (int)cudaErrorInvalidValue;\n"
_SMEM_THREADS = "constexpr int kSmemThreads = 64;"
_SMEM_SPLIT = """  lz4tt_split_row(t, walker, NamedPipe(), comp + b * comp_stride,
                  comp_stride, lens[b], out + b * out_stride, out_max, smem,
                  slots, &len, &e);
  if (!walker && t.leader()) {"""
# one warp walks and copies in turn (K1's body, lz4tt_decode_row, with the
# CTA's ring and the first slot's queue)
_SMEM_ONE_WARP = [
    ("lz4_decode.cu", _SMEM_THREADS, "constexpr int kSmemThreads = 32;"),
    ("lz4_decode.cu", _SMEM_SPLIT, """  int32_t read = 0;
  lz4tt_decode_row<false, false, SmemRing>(
      t, comp + b * comp_stride, comp_stride, lens[b], out + b * out_stride,
      out_max, smem, slots[0].q, &len, &read, &e);
  if (walker && t.leader()) {""")]
# the four-token run tried only after a sequence without literals
_PROBE_AFTER_LITERALS = [
    ("lz4_decode.cuh", "  const int32_t d0 = d;\n",
     "  const int32_t d0 = d;\n  bool probe = true;\n"),
    ("lz4_decode.cuh", "      while (n <= LZ4TT_BATCH - 4 &&",
     "      while (probe && n <= LZ4TT_BATCH - 4 &&"),
    ("lz4_decode.cuh", "      s += n_lit;\n      d += n_lit;\n      if (last) continue;",
     "      s += n_lit;\n      d += n_lit;\n      probe = n_lit == 0;\n"
     "      if (last) continue;")]

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
  if (left == 0 || next < lo || next > off) return z.max_attempts - left;
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
# K7's candidates without the hash sort and walks: the exact sort of
# (word, position) in every window
_K7_HASH = """  t.sort_pass(A, nullptr, B, nullptr, m, LZ4TT_PC_POS_BITS, 0x1Fu);
  t.sort_pass(B, nullptr, A, nullptr, m, LZ4TT_PC_POS_BITS + 5, 0x1Fu);
  t.sort_pass(A, nullptr, B, nullptr, m, LZ4TT_PC_POS_BITS + 10, 0x1Fu);
  bool over = false;
  for (int32_t k = r; k < m; k += T) {"""
_K7_SORT = """  bool over = true;
  for (int32_t k = r; k < 0; k += T) {"""
_HC_GRID = "    const int grid = n < teams ? n : teams;"
_HC_BOUNDS = "__global__ void __launch_bounds__(32, 32)"
_HC_ROW_WARPS = "  LZ4TT_HC_ROW_WARPS = 4,"
_HC_ROW_BOUNDS = "__global__ void __launch_bounds__(32 * kW, 16 / kW)"
_HC_CREW_HINT = "    t.hint = (t.hint && t.row().warps() > 1"
_HC_SLICE_HEAD = "LZ4TT_HD Lz4ttHcWave lz4tt_hc_slice("
# the lead and its crew load the next wave's slices while a wave is
# checked (a walk's first wave and one that follows a failed link excepted)
_HC_WAVE_AHEAD = [
    ("lz4_hc.cuh", """  // no slice is loaded ahead for a next wave: most walks end in one
  Lz4ttHcRec x = lz4tt_hc_rec(z, q.r - lane);
  for (;;) {""", """  Lz4ttHcRec x = lz4tt_hc_rec(z, q.r - lane), x2 = lz4tt_hc_rec(z, q.r - wave - lane);
  for (;;) {"""),
    ("lz4_hc.cuh", """    if (!failed) {  // every link held: c is the next wave's first
      q.r -= wave;
    } else {  // a link failed: speculate afresh from c
      if (t.leader()) LZ4TT_HC_FOLLOWED();
      q.r = z.rank()[c];
    }
    x = lz4tt_hc_rec(z, q.r - lane);
  }""", """    if (!failed) {  // every link held: c is the next wave's first
      q.r -= wave;
      x = x2;
    } else {  // a link failed: speculate afresh from c
      if (t.leader()) LZ4TT_HC_FOLLOWED();
      q.r = z.rank()[c];
      x = lz4tt_hc_rec(z, q.r - lane);
    }
    x2 = lz4tt_hc_rec(z, q.r - wave - lane);
  }"""),
    ("lz4_hc.cuh", """  const int k = row.warp_id(), lane = w.lane(), size = w.size();
  for (;;) {""", """  const int k = row.warp_id(), lane = w.lane(), size = w.size();
  const int32_t wave = row.warps() * size;
  int32_t ahead = -1;  // the wave's first record the slice x2 is of
  Lz4ttHcRec x2 = {0u, 0u, 0u, -1, 0};
  for (;;) {"""),
    ("lz4_hc.cuh", """    const Lz4ttHcRec x = lz4tt_hc_rec(z, at - lane);
    const int32_t succ""", """    const Lz4ttHcRec x = q.left < z.max_attempts && q.r == ahead
                             ? x2 : lz4tt_hc_rec(z, at - lane);
    const int32_t succ"""),
    ("lz4_hc.cuh", """    if (lane == 0) row.waves()[k] = a;
    row.sync();  // this warp's account is in""", """    if (lane == 0) row.waves()[k] = a;
    ahead = q.r - wave;
    x2 = lz4tt_hc_rec(z, at - wave - lane);
    row.sync();  // this warp's account is in"""),
]
# the lead the warp whose place in its CTA is the CTA's slot on its SM
# modulo the warps (%warpid of warp 0 over kW), so that the leads of an
# SM's CTAs spread over its four schedulers; warp_id() and lane() count
# from the lead
_HC_CTA_IDS = """  LZ4TT_HD int lane() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }"""
_HC_CTA_IDS_SLOTS = """  int lead_;
  LZ4TT_HD int lane() const {
#ifdef __CUDA_ARCH__
    return warp_id() * 32 + (threadIdx.x & 31);
#else
    return 0;
#endif
  }
  LZ4TT_HD int phys() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x >> 5;
#else
    return 0;
#endif
  }"""
_HC_CTA_INIT = """  t.waves_ = waves;
"""
_HC_CTA_INIT_SLOTS = """  t.waves_ = waves;
  __shared__ int lead_s;
  if (threadIdx.x == 0) {
    unsigned wid;
    asm volatile("mov.u32 %0, %%warpid;" : "=r"(wid));
    lead_s = (int)(wid / kW % kW);
  }
  __syncthreads();
  t.lead_ = lead_s;
"""
_HC_HEAD_AHEAD = """  if constexpr (lz4tt_hc_lead_v<Team>) lz4tt_hc_head_ahead(t, z, off);
"""
_HC_LEAD_WALK = """template <bool kWide, class Team>
LZ4TT_HD int32_t lz4tt_hc_walk_lead("""
# The wide kernel's control: one warp a row, a wave of four slices of 32
# candidates, all loaded at once and checked one slice after the other in
# registers (the shipped lead's walk stays in the source, renamed, unused)
_HC_ONE_WARP_WALK = """// The control: one warp, a wave of four slices, all in flight at once.
template <bool kWide, class Team>
LZ4TT_HD int32_t lz4tt_hc_walk_lead(const Team& t, const Lz4ttHc& z, int32_t off,
                                    uint32_t cur, int32_t c, int32_t rc,
                                    int32_t lo, int32_t start_limit,
                                    Lz4ttHcMatch& m) {
  constexpr int kS = 4;
  if (c < lo || c > off) return 0;
  const uint8_t* src = z.src;
  const Team& w = t;
  const int lane = w.lane(), size = w.size();
  const int32_t wave = kS * size;
  const bool ahead = off + 2 * LZ4TT_MIN_MATCH <= z.match_limit;
  const uint32_t cur_ahead = ahead ? lz4tt_read32(src, off + LZ4TT_MIN_MATCH) : 0u;
  const uint32_t cur_back = kWide ? lz4tt_hc_word_in(src, off - 4, off) : 0u;
  const int32_t back_max = off - start_limit > 0 ? off - start_limit : 0;
  int32_t left = z.max_attempts;
  int32_t r = rc >= 0 ? rc : z.rank()[c];
  Lz4ttHcRec x[kS];
#pragma unroll
  for (int j = 0; j < kS; j++) x[j] = lz4tt_hc_rec(z, r - j * size - lane);
  int32_t succ = lane + 1 == size ? lz4tt_hc_rec_pos(z, r - wave) : 0;
  for (;;) {
    bool failed = false, fail_in = false;
    int32_t n_true = wave, c_next = -1, top_s = 0, top_b = 0;
    uint32_t top = 0;
#pragma unroll
    for (int j = 0; j < kS; j++) {
      if (failed) break;
      const int32_t s = x[j].pos;
      const bool in = s >= lo && s <= off;
      int32_t next = -1, fwd = 0, bwd = 0;
      bool more = false;
      if (in) {
        LZ4TT_HC_CHECK_COPY(x[j].delta, z.chain()[s & LZ4TT_HC_MASK]);
        next = s - x[j].delta;
        if (x[j].word == cur) {
          const uint32_t d = x[j].ahead ^ cur_ahead;
          fwd = LZ4TT_MIN_MATCH +
                (ahead && d ? (lz4tt_ffs(d) - 1) >> 3
                            : lz4tt_common_words(src, s + LZ4TT_MIN_MATCH,
                                                 off + LZ4TT_MIN_MATCH,
                                                 z.match_limit, ahead ? 4 : 0));
          more = fwd == LZ4TT_MIN_MATCH + LZ4TT_SHORT_MATCH;
          if (kWide) {
            const uint32_t e = x[j].back ^ cur_back;
            const int32_t most = s < back_max ? s : back_max;
            bwd = e ? (31 - lz4tt_fls(e)) >> 3 : 4;
            if (bwd > most) bwd = most;
            if (bwd == 4) bwd = lz4tt_hc_back8(src, s, off, 0, start_limit, 4);
            more = more || bwd == 8;
          }
        }
      }
      const int32_t after = w.shfl(s, lane + 1 < size ? lane + 1 : 0);
      const int32_t first = w.shfl(x[j + 1 < kS ? j + 1 : j].pos, 0);
      const int32_t nx = lane + 1 < size ? after : j + 1 < kS ? first : succ;
      const bool holds = in && (next == nx || ((next < lo || next > off) &&
                                               (nx < lo || nx > off)));
      const unsigned fail = w.ballot(!holds), inside = w.ballot(in);
      const int kf = fail ? lz4tt_ffs(fail) - 1 : size;
      const bool kf_in = kf < size && ((inside >> kf) & 1u);
      int32_t p = kf == size ? size : kf + (kf_in ? 1 : 0);
      if (p > left - j * size) p = left - j * size;
      if (lane >= p) {
        fwd = bwd = 0;
        more = false;
      }
      for (unsigned ms = w.ballot(more); ms; ms &= ms - 1) {
        const int k = lz4tt_ffs(ms) - 1;
        const int32_t sk = w.shfl(s, k);
        const int32_t fk = w.shfl(fwd, k), bk = w.shfl(bwd, k);
        int32_t f = 0, g = 0;
        if (fk == LZ4TT_MIN_MATCH + LZ4TT_SHORT_MATCH)
          f = lz4tt_common_bytes(w, src, sk + fk, off + fk, z.match_limit);
        if (kWide && bk == 8)
          g = lz4tt_hc_back_team(w, src, sk, off, 0, start_limit, 8) - 8;
        if (lane == k) {
          fwd += f;
          bwd += g;
        }
      }
      const int32_t len = fwd + bwd;
      const uint32_t key = len > m.len
          ? ((uint32_t)len << 8) | (uint32_t)(255 - j * size - lane) : 0u;
      const uint32_t best = w.reduce_max(key);
      if (best > top) {
        const int wl = 255 - (int)(best & 255) - j * size;
        top = best;
        top_s = w.shfl(s, wl);
        top_b = w.shfl(bwd, wl);
      }
      if (kf < size) {
        failed = true;
        fail_in = kf_in;
        n_true = j * size + kf + (kf_in ? 1 : 0);
        c_next = w.shfl(next, kf);
      } else if (j + 1 == kS) {
        c_next = w.shfl(next, size - 1);
      }
    }
    bool last = failed && !fail_in;
    if (n_true >= left) {
      n_true = left;
      last = true;
    }
    if (top) {
      m.len = (int32_t)(top >> 8);
      m.ref = top_s - top_b;
      m.start = off - top_b;
    }
    if (last) return z.max_attempts - left + n_true;
    left -= n_true;
    c = c_next;
    if (c < lo || c > off) return z.max_attempts - left;
    if (!failed) {
      r -= wave;
    } else {
      if (t.leader()) LZ4TT_HC_FOLLOWED();
      r = z.rank()[c];
    }
#pragma unroll
    for (int j = 0; j < kS; j++) x[j] = lz4tt_hc_rec(z, r - j * size - lane);
    if (lane + 1 == size) succ = lz4tt_hc_rec_pos(z, r - wave);
  }
}

template <bool kWide, class Team>
LZ4TT_HD int32_t lz4tt_hc_walk_lead_shipped("""


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
    "K2, FIND's probes read in turn (the first design)": ("lz4_compress",
                                                          _PROBES_IN_TURN),
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
    "K1 a CTA a row": ("lz4_decode", []),
    "K1 a CTA a row, 2 slots": ("lz4_decode", [
        ("lz4_decode.cuh", "enum { LZ4TT_SLOTS = 4 };",
         "enum { LZ4TT_SLOTS = 2 };")]),
    "K1 a CTA a row, 8 slots": ("lz4_decode", [
        ("lz4_decode.cuh", "enum { LZ4TT_SLOTS = 4 };",
         "enum { LZ4TT_SLOTS = 8 };")]),
    "K1 a CTA a row, a third warp, idle": ("lz4_decode", [
        ("lz4_decode.cu", _SMEM_THREADS, "constexpr int kSmemThreads = 96;"),
        ("lz4_decode.cu", "  const bool walker = threadIdx.x < 32;",
         "  if (threadIdx.x >= 64) return;\n"
         "  const bool walker = threadIdx.x < 32;")]),
    "K1 a CTA a row, no four-token run right after literals": (
        "lz4_decode", _PROBE_AFTER_LITERALS),
    "K1, no four-token run right after literals": ("lz4_decode",
                                                   _PROBE_AFTER_LITERALS),
    "K1 a CTA a row, one warp walking and copying": ("lz4_decode",
                                                     _SMEM_ONE_WARP),
    "K1 a CTA a row, one warp walking and copying, the 4 KiB ring": (
        "lz4_decode", _SMEM_ONE_WARP + [
            ("lz4_decode.cu", _SMEM_RING, "using SmemRing = Lz4ttRing;"),
            ("lz4_decode.cu", _SMEM_CHECK, "")]),
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
    "K7": ("parallel_compress", []),
    "K7, candidates by the exact sort of (word, position) alone": (
        "parallel_compress", [("parallel_compress.cuh", _K7_HASH, _K7_SORT)]),
    "K8": ("gather_decode", []),
    "K8, synchronous rounds at every max_depth": ("gather_decode", [
        ("gather_decode.cuh",
         "  const bool in_place = lz4tt_gd_in_place(out_len, max_depth);",
         "  const bool in_place = false;")]),
    "K8, a CTA of 1,024 threads an SM": ("gather_decode", [
        ("gather_decode.cu", "constexpr int kThreads = 512;",
         "constexpr int kThreads = 1024;"),
        ("gather_decode.cu", "__launch_bounds__(kThreads, 2)",
         "__launch_bounds__(kThreads, 1)")]),
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
    "K6 a CTA a row": ("lz4_hc", []),
    "K6 a CTA a row, 8 warps (64 registers, 4 CTAs an SM)": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_ROW_WARPS, "  LZ4TT_HC_ROW_WARPS = 8,"),
        ("lz4_hc.cu", _HC_ROW_BOUNDS,
         "__global__ void __launch_bounds__(32 * kW, 32 / kW)")]),
    "K6 a CTA a row, one warp with four slices in flight (the control)": (
        "lz4_hc", [
            ("lz4_hc.cuh", _HC_ROW_WARPS, "  LZ4TT_HC_ROW_WARPS = 1,"),
            ("lz4_hc.cuh", _HC_CREW_HINT, "    t.hint = (true"),
            ("lz4_hc.cuh", _HC_LEAD_WALK, _HC_ONE_WARP_WALK)]),
    "K6 a CTA a row, 64 registers (8 CTAs an SM)": ("lz4_hc", [
        ("lz4_hc.cu", _HC_ROW_BOUNDS,
         "__global__ void __launch_bounds__(32 * kW, 32 / kW)")]),
    "K6 a CTA a row, the crew in every walk": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_CREW_HINT, "    t.hint = (t.row().warps() > 1")]),
    "K6 a CTA a row, no head-table line prefetched": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_HEAD_AHEAD, "")]),
    "K6 a CTA a row, the slices called, not inlined": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_SLICE_HEAD,
         "__host__ __device__ __noinline__ Lz4ttHcWave lz4tt_hc_slice(")]),
    "K6 a CTA a row, the lead walking alone (no crew)": ("lz4_hc", [
        ("lz4_hc.cuh", _HC_CREW_HINT, "    t.hint = (false")]),
    "K6 a CTA a row, the next wave's slices loaded ahead": (
        "lz4_hc", _HC_WAVE_AHEAD),
    "K6 a CTA a row, the lead warp by the CTA's warp slots": ("lz4_hc", [
        ("lz4_hc.cu", _HC_CTA_IDS, _HC_CTA_IDS_SLOTS),
        ("lz4_hc.cu", _HC_CTA_INIT, _HC_CTA_INIT_SLOTS),
        ("lz4_hc.cu", "  LZ4TT_HD int warp_id() const { return lane() >> 5; }",
         "  LZ4TT_HD int warp_id() const { return (phys() - lead_ + kW) % kW; }")]),
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
    "parallel_compress": ("lz4tt_compress_parallel",
                          [_P, _I64, _P, _P, _I64, _I32, _I64, _P, _I32, _I64,
                           _P, _I32, _P]),
    "gather_decode": ("lz4tt_gather_decode",
                      [_P, _I64, _I32] + [_P] * 6
                      + [_I32, _P, _I64, _I32, _I32, _P, _I32, _I32, _P]),
}
# variants timed through another entry point of their source than SYMBOLS'
VARIANT_SYMBOLS = {name: "lz4tt_decompress_safe_smem" for name in VARIANTS
                   if name.startswith("K1 a CTA a row")}
VARIANT_SYMBOLS.update({name: "lz4tt_compress_hc_wide" for name in VARIANTS
                        if name.startswith("K6 a CTA a row")})
# the wide K6 builds of --hc-crossover (the shipped one is hc.HC_WIDE)
HC_WIDE_BUILDS = tuple(name for name in VARIANTS
                       if name.startswith("K6 a CTA a row,"))
# K6's crossover (--hc-crossover): both kernels at these batch sizes of a4
# rows and of the cell's mix, and at the cell's of text and random rows
HC_CROSSOVER_ROWS = (128, 256, 384, 512, 528, 1056, 2048, 4096)
HC_CROSSOVER_SETS = {"a4": HC_CROSSOVER_ROWS, "mix": HC_CROSSOVER_ROWS,
                     "text": (512,), "random": (512,)}
# K1's extra set: the LZ4 rows (those HC shrinks) of the first 512 main-path
# rows at level 9, as a read batch of the block64k_hc9 cell has them
HC9_SET = "384 HC-9 rows"
# K1's crossover (--k1-crossover): both kernels at these batch sizes
CROSSOVER_ROWS = (128, 256, 384, 396, 397, 512, 1024, 3072)
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


# K7 with clock64 counters (--k7-split): the parts of its window kernel,
# timed by the first CTA's thread 0 over its windows
_K7_PARTS = ("keys", "hash sort", "hash walks", "exact sort", "stops past the "
             "window", "chunks' first stops", "positions", "walks and "
             "gather", "groups")
_K7_MARKS = (  # a mark before each: the part before it ends there
    "  // 1. candidates: keys sorted by hash",
    "  t.sort_pass(A, nullptr, B, nullptr, m, LZ4TT_PC_POS_BITS, 0x1Fu);",
    "  bool over = false;\n",
    "  if (t.any(over)) {  // the exact sort",
    "  int32_t after[4], stop[4];",
    "  const int W = t.warp_size(), n_warp = T / W, lane = r % W;",
    "  for (int32_t b = c0 + (c1 - c0 + W - 1) / W * W - W; b >= c0;",
    "  int32_t* m_pos = scratch + span;",
    "  int32_t G = 0;",
    "  if (r == 0) {\n    store[LZ4TT_PC_H] = G;",
)
_K7_SPLIT_EDITS = [
    ("parallel_compress.cuh", '#include "lz4tt_common.cuh"\n',
     """#include "lz4tt_common.cuh"
#ifdef __CUDACC__
__device__ unsigned long long lz4tt_split[16];
#endif
#ifdef __CUDA_ARCH__
#define PT(i) const long long pt##i = clock64(); \\
  if (i > 0 && blockIdx.x == 0 && threadIdx.x == 0) \\
    lz4tt_split[i - 1] += pt##i - pt_last; \\
  pt_last = pt##i
#define PW() if (blockIdx.x == 0 && threadIdx.x == 0) lz4tt_split[15] += 1
#else
#define PT(i)
#define PW()
#endif
"""),
    ("parallel_compress.cuh", "  const int T = t.size(), r = t.rank();\n  const int32_t ws = w * wl;\n"
     "  const int32_t we = ws + wl < n ? ws + wl : n;\n  const int32_t lo",
     "  const int T = t.size(), r = t.rank();\n  long long pt_last = 0;\n"
     "  (void)pt_last;\n  PW();\n  const int32_t ws = w * wl;\n"
     "  const int32_t we = ws + wl < n ? ws + wl : n;\n  const int32_t lo"),
] + [("parallel_compress.cuh", text, f"  PT({i});\n" + text)
     for i, text in enumerate(_K7_MARKS)] + [
    ("parallel_compress.cu", "// Int32 words of a team's scratch", """extern "C" int lz4tt_split_read(unsigned long long* h, int zero) {
  const unsigned long long none[16] = {};
  const cudaError_t e = cudaMemcpyFromSymbol(h, lz4tt_split, sizeof(none));
  return (int)(zero && e == cudaSuccess
                   ? cudaMemcpyToSymbol(lz4tt_split, none, sizeof(none))
                   : e);
}

// Int32 words of a team's scratch"""),
]


# K2 with a dictionary with clock64 counters (--dict-split): the parts of
# one row's compress, timed by the first CTA's lane 0
_DICT_PARTS = ("seed or zeroed table", "FIND probe loops", "the scan, all",
               "team jobs", "the row")
_DICT_SPLIT_EDITS = [
    ("lz4_compress.cuh", '#include "lz4tt_common.cuh"\n', """#include "lz4tt_common.cuh"
#ifdef __CUDACC__
__device__ unsigned long long lz4tt_split[16];
__device__ long long lz4tt_t0;
#endif
#ifdef __CUDA_ARCH__
#define PT(v) const long long v = clock64()
#define PA(i, a, b) if (blockIdx.x == 0 && threadIdx.x == 0) { \\
  lz4tt_split[i] += (b) - (a); lz4tt_split[(i) + 8] += 1; }
#define P0() if (blockIdx.x == 0 && threadIdx.x == 0) lz4tt_t0 = clock64()
#else
#define PT(v)
#define PA(i, a, b)
#define P0()
#endif
"""),
    ("lz4_compress.cuh", "        bool found = false;\n",
     "        bool found = false;\n        PT(f0);\n"),
    ("lz4_compress.cuh", "        if (!found) {\n",
     "        PT(f1);\n        PA(1, f0, f1);\n        if (!found) {\n"),
    ("lz4_compress.cuh", "  int32_t ext = 0;\n",
     "  int32_t ext = 0;\n  PT(v0);\n  PA(0, lz4tt_t0, v0);\n"),
    ("lz4_compress.cuh",
     "    if (t.leader()) j = lz4tt_scan<kSmall>(z, ext, w, src_len, dst, dest_cap,\n"
     "                                           dst_width, table);\n",
     "    PT(s0);\n"
     "    if (t.leader()) j = lz4tt_scan<kSmall>(z, ext, w, src_len, dst, dest_cap,\n"
     "                                           dst_width, table);\n"
     "    PT(s1);\n    PA(2, s0, s1);\n"),
    ("lz4_compress.cuh", "    if (j.kind == LZ4TT_JOB_COPY)\n",
     "    PT(j0);\n    if (j.kind == LZ4TT_JOB_COPY)\n"),
    ("lz4_compress.cuh", "      ext = lz4tt_common_bytes(t, w, j.a, j.b, j.c);\n",
     "      ext = lz4tt_common_bytes(t, w, j.a, j.b, j.c);\n"
     "    PT(j1);\n    PA(3, j0, j1);\n"),
    ("lz4_compress.cu", "  const int32_t dl = dict_lens[b];\n",
     "  P0();\n  const int32_t dl = dict_lens[b];\n"),
    ("lz4_compress.cu", "                            dest_cap, dst_stride, table, &len, &e, seeded);\n",
     "                            dest_cap, dst_stride, table, &len, &e, seeded);\n"
     "  PT(r1);\n  PA(4, lz4tt_t0, r1);\n"),
    ("lz4_compress.cu", "// Resident CTAs per SM and threads per CTA", """extern "C" int lz4tt_split_read(unsigned long long* h, int zero) {
  const unsigned long long none[16] = {};
  const cudaError_t e = cudaMemcpyFromSymbol(h, lz4tt_split, sizeof(none));
  return (int)(zero && e == cudaSuccess
                   ? cudaMemcpyToSymbol(lz4tt_split, none, sizeof(none))
                   : e);
}

// Resident CTAs per SM and threads per CTA"""),
]
# the formats path's rows: 64 MiB of make_blocks data (its first text
# block taken out as the shared dictionary), chip_smoke.py::_format_data
FORMAT_SEED, FORMAT_BLOCKS = SEED + 3, 1024
_DICT_ARGS = [_P, _I64, _P, _P, _I64, _P, _P, _I64, _I32, _P, _P, _I32, _P,
              _I32, _P]


class _DictRows:
    """The formats path's 1,024 rows of 64 KiB on the card, its shared
    dictionary, and its linked rows (each row's dictionary the 64 KiB of
    content before it, ``testing.linked_blocks``' strided view)."""

    def __init__(self, dev):
        blocks = sharded.make_blocks(FORMAT_BLOCKS + 1, BLOCK_LEN, FORMAT_SEED)
        kinds = sharded.block_kinds(FORMAT_BLOCKS + 1, FORMAT_SEED)
        t = int(np.flatnonzero(kinds == 1)[0])
        self.dictionary = blocks[t].tobytes()
        blocks, kinds = np.delete(blocks, t, axis=0), np.delete(kinds, t)
        self.kinds = kinds
        self.src, self.lens = sharded.upload_blocks(blocks, dev)
        self.n = self.src.shape[0]
        self.cap = max_compressed_length(BLOCK_LEN)
        self.win = layout.upload_bytes(self.dictionary, dev).view(1, -1)
        self.wl = torch.full((self.n,), BLOCK_LEN, dtype=torch.int32,
                             device=dev)
        w = codec.WINDOW
        buf = torch.zeros((w + self.n * BLOCK_LEN,), dtype=torch.uint8,
                          device=dev)
        buf[w:] = self.src[:, :BLOCK_LEN].reshape(-1)
        self.linked = buf[w:].view(self.n, BLOCK_LEN)
        self.linked_dicts = buf.as_strided((self.n, w), (BLOCK_LEN, 1))
        self.linked_copies = self.linked_dicts.contiguous()
        self.linked_lens = torch.tensor(
            [min(i * BLOCK_LEN, w) for i in range(self.n)], dtype=torch.int32,
            device=dev)
        self.seed = torch.empty((codec.SEED_WORDS,), dtype=torch.int32,
                                device=dev)

    def order(self, kind: int):
        """The rows with the first row of ``kind`` first (the split's CTA
        0 takes it)."""
        first = int(np.flatnonzero(self.kinds == kind)[0])
        idx = [first] + [i for i in range(self.n) if i != first]
        return torch.tensor(idx, device=self.src.device)

    def cases(self):
        """name -> (src, lens, dict end pointer, dict stride, dict lens,
        seed_len) of each launch: the shared dictionary seeded once (the
        shipped path) and seeded by each CTA (the first design), no
        dictionary (K2's path on the same kernel), the linked rows (their
        dictionaries a strided view of the content) and the same with
        their dictionaries copied."""
        out = {}
        zero = torch.zeros_like(self.wl)
        for kind, kname in ((0, "a4"), (1, "text")):
            idx = self.order(kind)
            s, sl = self.src[idx].contiguous(), self.lens[idx].contiguous()
            end = self.win.data_ptr() + self.win.shape[1]
            out[f"{kname}, shared dictionary, seeded once"] = (
                s, sl, end, 0, self.wl, BLOCK_LEN)
            out[f"{kname}, shared dictionary, seeded by each CTA"] = (
                s, sl, end, 0, self.wl, -1)
            out[f"{kname}, no dictionary"] = (s, sl, end, 0, zero, -1)
        w = codec.WINDOW
        out["linked rows, strided view"] = (
            self.linked, self.lens, self.linked_dicts.data_ptr() + w,
            BLOCK_LEN, self.linked_lens, -1)
        out["linked rows, copied dictionaries"] = (
            self.linked, self.lens, self.linked_copies.data_ptr() + w, w,
            self.linked_lens, -1)
        return out


def _dict_call(fn, rows: _DictRows, case, stream):
    """(call, output buffers) of one K2-dict launch of ``case``."""
    s, sl, end, stride, dl, seed_len = case
    n = s.shape[0]
    dst = torch.zeros((n, layout.row_stride(rows.cap)), dtype=torch.uint8,
                      device=s.device)
    ol, err = (torch.empty((n,), dtype=torch.int32, device=s.device)
               for _ in range(2))

    def call():
        rc = fn(s.data_ptr(), s.stride(0), sl.data_ptr(), end, stride,
                dl.data_ptr(), dst.data_ptr(), dst.stride(0), rows.cap,
                ol.data_ptr(), err.data_ptr(), n, rows.seed.data_ptr(),
                seed_len, stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc}")
    return call, (dst, ol, err)


def dict_split() -> dict:
    """Cycles of each part of one row's dictionary compress
    (``_DICT_PARTS``) in the first CTA's lane 0, on the formats path's
    first a4 and first text row with the shared dictionary (seeded once,
    and by each CTA), without one, and on a linked row (its dictionary a
    strided view, and copied); and each launch's time (CUDA events) on all 1,024 rows, the
    shipped build beside the counting one, every output held against the
    first case of its rows."""
    root = build.build_dir().parent / "variants"
    built = {}
    for name, edits in (("split", _DICT_SPLIT_EDITS),
                        ("probes in turn", _PROBES_IN_TURN),
                        ("first design", _DICT_FIRST_READS + _PROBES_IN_TURN),
                        ("12-bit table", _TABLE_12)):
        built[name] = _nvcc_copy(root / name.replace(" ", ""), edits,
                                 "lz4_compress")
    for name, (so, proc) in built.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(log)
        built[name] = ctypes.CDLL(str(so))
    split = built["split"]
    rows = _DictRows(torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    fns = {}
    for name, lib in (("shipped", build._library("lz4_compress")),
                      *built.items()):
        fn = lib.lz4tt_compress_dict
        fn.argtypes, fn.restype = _DICT_ARGS, ctypes.c_int
        fns[name] = fn
    split.lz4tt_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    counts = (ctypes.c_ulonglong * 16)()
    out, firsts = {}, {}
    for name, case in rows.cases().items():
        key = name.split(",")[0] + ("" if "no dictionary" not in name else
                                    " bare")
        res = {}
        for build_name, fn in fns.items():
            if build_name == "12-bit table":
                if "no dictionary" in name:   # other bytes: timed only
                    res[f"{build_name} ms"] = testing.cuda_ms(
                        _dict_call(fn, rows, case, stream)[0], REPS)
                continue
            call, bufs = _dict_call(fn, rows, case, stream)
            split.lz4tt_split_read(counts, 1)
            call()
            torch.cuda.synchronize()
            if build_name == "split":
                split.lz4tt_split_read(counts, 0)
                res["cycles"] = {
                    part: {"cycles": counts[i], "calls": counts[i + 8]}
                    for i, part in enumerate(_DICT_PARTS)}
            want = firsts.setdefault(key, tuple(x.clone() for x in bufs))
            if bool(bufs[2].any()) or not all(
                    torch.equal(x, y) for x, y in zip(bufs, want)):
                raise SystemExit(f"design_variants: K2 dict differs on {name}")
            res[f"{build_name} ms"] = testing.cuda_ms(call, REPS)
        out[name] = res
        print(f"K2 dict split, {name}: {json.dumps(res)}", flush=True)
    return out


# the chunked walk's launches timed cumulatively (--walk-split): builds
# that return after the tables, after the hops, after the emission
_HOPS = "  hops_kernel<<<by_block, kChunkThreads, 0, s>>>(lay, n, chunk, st);\n"
_EMIT = ("  emit_kernel<<<(n_chunks + kEmitWarps - 1) / kEmitWarps, "
         "32 * kEmitWarps,\n")
_FINISH = "  finish_kernel<<<by_block, kChunkThreads, 0, s>>>(\n"
_WALK_PARTS = {"tables": _HOPS, "+ hops": _EMIT, "+ emission": _FINISH}


def walk_split() -> dict:
    """The chunked walk's launches one after another, every block cut
    into chunks of 2, 4 and 8 KiB (the C entry point alone): the tables,
    then with the hops, then with the emission, then all four (the
    finish), on the formats path's linked frames."""
    root = build.build_dir().parent / "variants"
    libs = {}
    for i, (name, text) in enumerate(_WALK_PARTS.items()):
        so, proc = _nvcc_copy(root / f"walksplit{i}",
                              [("linked_decode.cu", text, "  return 0;\n" + text)],
                              "linked_decode")
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(log)
        libs[name] = getattr(ctypes.CDLL(str(so)), "lz4tt_linked_walk")
    libs["all"] = getattr(build._library("linked_decode"), "lz4tt_linked_walk")
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    out = {}
    for set_name, (c, cl, flags, bs, host) in _linked_rows(dev).items():
        n = c.shape[0]
        width = linked_decode.table_width(*host)
        for chunk in (2048, 4096, 8192):
            lay, n_chunks, n_tab = linked_decode.chunk_layout(*host, bs, chunk,
                                                              0)
            lay = torch.from_numpy(lay).to(dev)
            scratch = torch.empty((n_tab * 3 * chunk + 5 * n_chunks,),
                                  dtype=torch.int32, device=dev)
            tables = torch.empty((6, n, width), dtype=torch.int32, device=dev)
            res = torch.empty((4, n), dtype=torch.int32, device=dev)
            args = [c.data_ptr(), c.stride(0), cl.data_ptr(), flags.data_ptr(),
                    n, bs, tables.data_ptr(), width,
                    *(r.data_ptr() for r in res), lay.data_ptr(), n_chunks,
                    n_tab, chunk, scratch.data_ptr(), stream]
            got = {}
            for name, fn in libs.items():
                fn.argtypes, fn.restype = linked_decode.WALK.argtypes, ctypes.c_int

                def call():
                    if fn(*args):
                        raise RuntimeError("CUDA error")
                got[name] = testing.cuda_ms(call, REPS)
            out[f"{set_name}, chunks of {chunk}"] = got
            print(f"linked walk split, {set_name}, chunks of {chunk}: "
                  f"{json.dumps(got)}", flush=True)
    return out


def _linked_rows(dev) -> dict:
    """The formats path's linked frames (``testing.linked_blocks`` of its
    64 MiB at each of ``LINKED_SIZES``, LZ4F's 64 KiB, 256 KiB, 1 MiB and 4
    MiB blocks): name -> (payload rows, lengths, raw flags, block size,
    host lengths and flags)."""
    blocks = sharded.make_blocks(FORMAT_BLOCKS + 1, BLOCK_LEN, FORMAT_SEED)
    kinds = sharded.block_kinds(FORMAT_BLOCKS + 1, FORMAT_SEED)
    raw = np.delete(blocks, int(np.flatnonzero(kinds == 1)[0]), axis=0)
    raw = raw.tobytes()
    out = {}
    for bs in LINKED_SIZES:
        size = f"{bs >> 20} MiB" if bs >= 1 << 20 else f"{bs >> 10} KiB"
        name = f"{len(raw) // bs:,} x {size}"
        raws = [raw[i:i + bs] for i in range(0, len(raw), bs)]
        comps = testing.linked_blocks(raw, bs, dev)
        pays = testing.payloads(raws, comps)
        c, cl = layout.to_device_layout(pays, device=dev)
        flags = [len(p) >= len(r) for r, p in zip(raws, comps)]
        out[name] = (c, cl, torch.tensor(flags, device=dev), bs,
                     (cl.cpu().numpy(), np.array(flags)))
    return out


# the linked walk's designs: (entry point, chunk, whole_below); None for
# the shipped wrapper's own
LINKED_SIZES = (BLOCK_LEN, 256 << 10, 1 << 20, 4 << 20)
LINKED_VARIANTS = {
    "chunked walk (shipped)": ("launches", None, None),
    "chunked walk, 64 KiB blocks cut too": ("launches", None, 0),
    "chunked walk, blocks up to 256 KiB whole": ("launches", None, 256 << 10),
    "chunked walk, blocks up to 1 MiB whole": ("launches", None, 1 << 20),
    "chunked walk, chunks of 2 KiB": ("launches", 2048, 0),
    "chunked walk, chunks of 8 KiB": ("launches", 8192, 0),
    "chunked walk, chunks of 16 KiB": ("launches", 16384, 0),
    "chunked walk, one kernel with a look-back": ("lookback", None, 0),
    "warp walk (the first design)": ("launches", None, 1 << 31),
}
# the chunked walk in one kernel with a decoupled look-back, a variant of
# linked_decode.cu: a warp takes chunks in order by an atomic ticket,
# builds its tables in shared memory, waits for the chunk before it to
# publish its entry, publishes the next one and walks; then the finish
_LOOKBACK_KERNEL = """// The chunked walk in one kernel: a warp a chunk, taken in order by a
// ticket; the chunk's tables in shared memory (ff16, then exit, cnt, out);
// a chunk's entry published by the chunk before it (flag[g] set after
// st.ent/n0/d0[g]), the next one's published before the walk.
__global__ void __launch_bounds__(32)
    lookback_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                    const int32_t* __restrict__ lens,
                    const uint8_t* __restrict__ raw, int32_t n,
                    int32_t dest_cap, int32_t* tables, int32_t max_seq,
                    const int32_t* __restrict__ layout, int32_t n_chunks,
                    int32_t chunk, ChunkState st, int32_t* flag,
                    int32_t* ticket) {
  extern __shared__ __align__(16) int32_t tab[];  // 3 x chunk, ff16, stage
  const WarpTeam t{};
  int32_t g = 0;
  if (t.leader()) g = atomicAdd(ticket, 1);
  g = t.bcast(g);
  if (g >= n_chunks) return;
  const int32_t b = block_of(layout, n, g), c = g - layout[b];
  const int32_t nc = layout[b + 1] - layout[b];
  const uint8_t* src = comp + b * comp_stride;
  const int32_t c0 = c * chunk, c1 = c0 + chunk;
  if (c < nc - 1) {
    uint16_t* ff16 = (uint16_t*)(tab + 3 * chunk);
    uint8_t* stage = (uint8_t*)(ff16 + (chunk + 7) / 8 * 8);
    lz4tt_lw_tables(t, src, lens[b], c0, c1, tab, {ff16, stage, nullptr});
  }
  if (!t.leader()) return;
  int32_t e = 0, n0 = 0, d0 = 0;
  if (c > 0) {
    volatile int32_t* f = flag + g;
    while (*f == 0) __nanosleep(64);
    __threadfence();
    e = ((volatile int32_t*)st.ent)[g];
    n0 = ((volatile int32_t*)st.n0)[g];
    d0 = ((volatile int32_t*)st.d0)[g];
  }
  const bool here = e >= 0 && (c == nc - 1 || e < c1);
  if (c < nc - 1) {  // the next chunk's entry
    int32_t ne = e, nn = n0;
    int64_t nd = d0;
    if (here) {
      const int32_t* x = tab + 3 * (e - c0);
      if (x[0] == LZ4TT_LW_STOP) {
        ne = -1;
      } else {
        ne = x[0];
        nn += x[1];
        nd += x[2];
      }
    }
    st.ent[g + 1] = ne;
    st.n0[g + 1] = nn;
    st.d0[g + 1] = lz4tt_lw_sat(nd);
    __threadfence();
    atomicExch(flag + g + 1, 1);
  }
  const Lz4ttLwResult r = lz4tt_lw_chunk(
      src, lens[b], dest_cap, raw[b] != 0, row_tables(tables, n, max_seq, b),
      max_seq, c, nc, chunk, here ? e : -1, n0, d0);
  st.code[g] = r.code;
  st.n0[g] = r.n_seq;
  st.d0[g] = r.out_total;
  st.reach[g] = r.reach;
}

"""
_LOOKBACK_ENTRY = """// The same chunks by one kernel with a decoupled look-back, then the
// finish (lookback_kernel); scratch: int32[6 * n_chunks + 1].
extern "C" int lz4tt_linked_walk_lookback(
    const void* comp, long long comp_stride, const void* lens, const void* raw,
    int n, int dest_cap, void* tables, int max_seq, void* n_seq,
    void* out_total, void* code, void* reach, const void* layout,
    int n_chunks, int chunk, void* scratch, void* stream) {
  if (n < 0 || dest_cap < 0 || max_seq < 1 || chunk < 1 || chunk > 16384 ||
      n_chunks < n)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const int32_t* lay = (const int32_t*)layout;
  const ChunkState st = chunk_state((int32_t*)scratch, n_chunks, 0, chunk);
  int32_t* flag = (int32_t*)scratch + 5 * (int64_t)n_chunks;
  if (const cudaError_t e = cudaMemsetAsync(
          flag, 0, ((size_t)n_chunks + 1) * sizeof(int32_t), s))
    return (int)e;
  const size_t smem = 12 * (size_t)chunk + 2 * ((chunk + 7) / 8 * 8) +
                      chunk + LZ4TT_LW_MARGIN;
  if (smem > 48 * 1024) {
    if (const cudaError_t e = cudaFuncSetAttribute(
            lookback_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem))
      return (int)e;
  }
  lookback_kernel<<<n_chunks, 32, smem, s>>>(
      (const uint8_t*)comp, comp_stride, (const int32_t*)lens,
      (const uint8_t*)raw, n, dest_cap, (int32_t*)tables, max_seq, lay,
      n_chunks, chunk, st, flag, flag + n_chunks);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  finish_kernel<<<(n + kChunkThreads - 1) / kChunkThreads, kChunkThreads, 0,
                  s>>>(lay, n, st, (int32_t*)n_seq, (int32_t*)out_total,
                       (int32_t*)code, (int32_t*)reach);
  return (int)cudaGetLastError();
}
"""
_LOOKBACK = [
    ("linked_decode.cu", "}  // namespace\n",
     _LOOKBACK_KERNEL + "\n}  // namespace\n"),
    ("linked_decode.cu", "// The scratch of lz4tt_linked_resolve",
     _LOOKBACK_ENTRY + "\n// The scratch of lz4tt_linked_resolve")]


def _lookback_walk(fn, c, cl, flags, bs, width, host, chunk):
    """The look-back walk (``_LOOKBACK``'s C entry point ``fn``) of a
    batch, every block past ``chunk`` cut: what ``walk_linked`` returns."""
    n, dev = c.shape[0], c.device
    lay, n_chunks, _ = linked_decode.chunk_layout(*host, bs, chunk, 0)
    lay = torch.from_numpy(lay).to(dev)
    scratch = torch.empty((6 * n_chunks + 1,), dtype=torch.int32, device=dev)
    tables = torch.empty((6, n, width), dtype=torch.int32, device=dev)
    res = torch.empty((4, n), dtype=torch.int32, device=dev)
    if fn(c.data_ptr(), c.stride(0), cl.data_ptr(), flags.data_ptr(), n, bs,
          tables.data_ptr(), width, *(r.data_ptr() for r in res),
          lay.data_ptr(), n_chunks, chunk, scratch.data_ptr(),
          layout.cuda_stream(c)):
        raise RuntimeError("lz4tt_linked_walk_lookback: CUDA error")
    return (tables, *res)


def linked_variants() -> dict:
    """Each design of the linked walk (``LINKED_VARIANTS``) timed (CUDA
    events) on the formats path's linked frames, its output (every
    record of every block, the codes, lengths and reach) held against the
    shipped walk's."""
    so, proc = _nvcc_copy(build.build_dir().parent / "variants" / "lookback",
                          _LOOKBACK, "linked_decode")
    log, _ = proc.communicate()
    if proc.returncode:
        raise build.KernelBuildError(log)
    lookback = ctypes.CDLL(str(so)).lz4tt_linked_walk_lookback
    lookback.argtypes = linked_decode.WALK.argtypes[:13] + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    lookback.restype = ctypes.c_int
    dev = torch.device("cuda")
    sets = _linked_rows(dev)
    out = {}
    for name, (kind, chunk, whole) in LINKED_VARIANTS.items():
        res = {}
        for set_name, (c, cl, flags, bs, host) in sets.items():
            want = linked_decode.walk_linked(c, cl, flags, bs, None, host)
            width = want[0].shape[2]
            ck = chunk or linked_decode.CHUNK
            if kind == "launches":
                wb = linked_decode.WHOLE_BELOW if whole is None else whole

                def call():
                    return linked_decode._walk_cuda(c, cl, flags, bs, width,
                                                    host, ck, wb)
            else:
                def call():
                    return _lookback_walk(lookback, c, cl, flags, bs, width,
                                          host, ck)
            got = call()
            n_seq = want[1].long()
            used = torch.arange(width, device=dev) < n_seq[:, None]
            if not all(torch.equal(x, y) for x, y in zip(got[1:], want[1:])) \
                    or not torch.equal(got[0][:, used], want[0][:, used]):
                raise SystemExit(f"design_variants: {name} differs on "
                                 f"{set_name}")
            res[set_name] = testing.cuda_ms(call, REPS)
            print(f"linked walk, {name}, {set_name}: {res[set_name]:.3f} ms",
                  flush=True)
        out[name] = res
    out["scratch_bytes"] = linked_decode.SCRATCH.last_nbytes
    return out


# The linked resolve's first design, spliced into a copy of
# csrc for timing beside the shipped one: a node for every byte of the
# batch in device memory, its parent the periodic source base + (x mod d)
# with base = m_out - d; a fill, rounds over all nodes in place, a gather.
# FIRST_RESOLVE_CUH holds its bodies (the tests build them with g++ too).
FIRST_RESOLVE_CUH = """// A literal run and match that write more nodes than this go to the whole
// CTA in the first design's fill, shorter ones to one thread.
enum { LZ4TT_LR_LONG = 64 };

// Whether record k writes more than LZ4TT_LR_LONG nodes.
LZ4TT_HD bool lz4tt_lr_long(const Lz4ttLwTables& t, int32_t k) {
  return (int64_t)t.lit_len[k] + t.m_len[k] > LZ4TT_LR_LONG;
}

// The nodes of record k of a block whose output starts at node base; comp
// is the block's row. Its bytes from, from + step, ...
LZ4TT_HD void lz4tt_lr_fill(const uint8_t* comp, const Lz4ttLwTables& t,
                            int32_t k, int32_t* nodes, int64_t base,
                            int32_t from, int32_t step) {
  const int64_t lo = base + t.lit_out[k];
  const int32_t ls = t.lit_src[k], ll = t.lit_len[k];
  for (int32_t x = from; x < ll; x += step)
    nodes[lo + x] = lz4tt_lr_known(comp[ls + x]);
  const int64_t mo = base + t.m_out[k];
  const int32_t md = t.m_dist[k], ml = t.m_len[k];
  if (md == 0) {
    for (int32_t x = from; x < ml; x += step) nodes[mo + x] = lz4tt_lr_known(0);
  } else {
    // byte x of the match is byte (x mod md) of the period before it
    int32_t q = from % md;
    const int32_t adv = step % md;
    for (int32_t x = from; x < ml; x += step) {
      nodes[mo + x] = (int32_t)(mo - md + q);
      q += adv;
      if (q >= md) q -= md;
    }
  }
}

// One round's step of node j, in place; whether it is still open.
LZ4TT_HD bool lz4tt_lr_step(int32_t* nodes, int64_t j) {
  const int32_t v = nodes[j];
  if (v < 0) return false;
  const int32_t w = nodes[v];
  nodes[j] = w;
  return w >= 0;
}
"""
_FIRST_RESOLVE_KERNELS = """constexpr int kFill = 256, kRound = 256;

// Grid (x, n + 1): CTA (x, b < n) fills records [x * kFill, +kFill) of
// block b, if b is below *n_ok; the row b = n fills the window's nodes.
__global__ void __launch_bounds__(kFill)
    fill_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                const int32_t* tables, int32_t max_seq, int32_t n,
                const int32_t* __restrict__ n_seq,
                const int64_t* __restrict__ block_at,
                const int64_t* __restrict__ n_ok,
                const uint8_t* __restrict__ window, int32_t w,
                int32_t* nodes) {
  __shared__ int32_t longs[kFill];
  __shared__ int32_t n_long;
  const int32_t b = blockIdx.y;
  if (b == n) {
    for (int64_t j = (int64_t)blockIdx.x * kFill + threadIdx.x; j < w;
         j += (int64_t)gridDim.x * kFill)
      nodes[j] = lz4tt_lr_known(window[j]);
    return;
  }
  const int32_t k0 = blockIdx.x * kFill;
  if (b >= *n_ok || k0 >= n_seq[b]) return;  // the same for the whole CTA
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int64_t plane = (int64_t)n * max_seq;
  int32_t* row = const_cast<int32_t*>(tables) + (int64_t)b * max_seq;
  const Lz4ttLwTables t = {row,             row + plane,     row + 2 * plane,
                           row + 3 * plane, row + 4 * plane, row + 5 * plane};
  const uint8_t* src = comp + b * comp_stride;
  const int64_t base = w + block_at[b];
  const int32_t k = k0 + threadIdx.x;
  if (k < n_seq[b]) {
    if (lz4tt_lr_long(t, k))
      longs[atomicAdd(&n_long, 1)] = k;
    else
      lz4tt_lr_fill(src, t, k, nodes, base, 0, 1);
  }
  __syncthreads();
  for (int32_t q = 0; q < n_long; q++)
    lz4tt_lr_fill(src, t, longs[q], nodes, base, threadIdx.x, kFill);
}

// Round r over nodes [0, *n_nodes): open[r] counts the nodes it leaves
// open; nothing to do once round r - 1 left none.
__global__ void __launch_bounds__(kRound)
    round_kernel(int32_t* nodes, const int64_t* __restrict__ n_nodes,
                 int32_t* open, int32_t r) {
  if (r > 0 && open[r - 1] == 0) return;
  const int64_t total = *n_nodes;
  int32_t mine = 0;
  for (int64_t j = (int64_t)blockIdx.x * kRound + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * kRound)
    mine += lz4tt_lr_step(nodes, j);
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(open + r, mine);
}

__global__ void __launch_bounds__(kRound)
    gather_kernel(const int32_t* __restrict__ nodes,
                  const int64_t* __restrict__ n_nodes, uint8_t* out) {
  const int64_t total = *n_nodes;
  for (int64_t j = (int64_t)blockIdx.x * kRound + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * kRound)
    out[j] = (uint8_t)nodes[j];
}
"""
_FIRST_RESOLVE_ENTRY = """// The resolve's first design: a node for every byte of the batch (nodes:
// int32[>= *n_nodes]), the fill, `rounds` round kernels over all of them
// in place (each returns at once when the round before left no node open;
// open: int32[rounds], zeroed), and the gather into out. grid: CTAs of
// each round and of the gather.
extern "C" int lz4tt_linked_resolve_rounds(
    const void* comp, long long comp_stride, const void* tables, int max_seq,
    int n, const void* n_seq, const void* block_at, const void* n_ok,
    const void* window, int w, const void* n_nodes, void* nodes, void* out,
    void* open, int rounds, int grid, void* stream) {
  if (n < 0 || n >= 65535 || w < 0 || max_seq < 1 || rounds < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 fill_grid((max_seq + kFill - 1) / kFill, n + 1);
  fill_kernel<<<fill_grid, kFill, 0, s>>>(
      (const uint8_t*)comp, comp_stride, (const int32_t*)tables, max_seq, n,
      (const int32_t*)n_seq, (const int64_t*)block_at, (const int64_t*)n_ok,
      (const uint8_t*)window, w, (int32_t*)nodes);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  for (int r = 0; r < rounds; r++) {
    round_kernel<<<grid, kRound, 0, s>>>((int32_t*)nodes,
                                         (const int64_t*)n_nodes,
                                         (int32_t*)open, r);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
  }
  gather_kernel<<<grid, kRound, 0, s>>>((const int32_t*)nodes,
                                        (const int64_t*)n_nodes,
                                        (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the first design's round.
extern "C" int lz4tt_linked_rounds_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kRound;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, round_kernel, kRound, 0);
}

"""
_RESOLVE_OCC = "// Resident CTAs per SM and threads per CTA of the rounds."
_FIRST_RESOLVE = [
    ("linked_decode.cuh", "// The exit of open node j: s0 - off[j].",
     FIRST_RESOLVE_CUH + "\n// The exit of open node j: s0 - off[j]."),
    ("linked_decode.cu", "}  // namespace\n",
     _FIRST_RESOLVE_KERNELS + "\n}  // namespace\n"),
    ("linked_decode.cu", _RESOLVE_OCC, _FIRST_RESOLVE_ENTRY + _RESOLVE_OCC)]
_FIRST_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
               ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4 + [
    ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]

# The shipped resolve's other builds (file, text, its replacement): its
# segments at 8 and 32 KiB (16 KiB: linked_decode.SEGMENT), its launches
# cut after a part (the segment kernel returning after its searches, its
# fill, its pass; the launches up to the segments, the exits' ranks, the
# rounds and their bytes) and options tried. True: its bytes held against
# the shipped ones (the cut ones write part of them).
_SEG = "constexpr int kSeg = 16384, kSegThreads = 512, kSegCtas = 3;"
_PASS = ("  // the pass in output order, a tile of 2 T nodes at a time (a "
         "thread's\n")
_OUTPUT = ("  // known bytes to out; open nodes, their offsets and exits; size() "
           "nodes\n")
_RECORDS = ("      // size() records at a time: a thread each, the long ones by "
            "the team;\n")
_AFTER = {"segments": "  count_kernel<<<n_chunks, kScan, 0, s>>>(",
          "ranks": "  void* args[] = {(void*)&m,",
          "rounds": "  const int64_t per = (int64_t)kFinish * kResolve;"}


def _cut(after: str, *cuh) -> list:
    """The entry point returning before the launch after ``after`` (and
    the segment kernel's body returning before each text of ``cuh``)."""
    return [("linked_decode.cu", _AFTER[after], "  return 0;\n" + _AFTER[after]),
            *(("linked_decode.cuh", t, "  return;\n" + t) for t in cuh)]


_ENTRIES = ("    for (int64_t i0 = me; i0 < len; i0 += kBatch * lanes) {\n"
            "      int32_t q[kBatch], k[kBatch];")
_ROUNDS = ("    const int32_t left = lz4tt_rs_rounds(grid, m, len,\n"
           "                                         lz4tt_rs_rounds_for(len), "
           "tally,\n                                         turn, rounds);\n")
_BYTES = ("    for (int64_t i = me; i < len; i += lanes)\n"
          "      m.out[m.pos[i]] = (uint8_t)m.list[i];\n")
_NO_ROUNDS = ("linked_decode.cu", _ROUNDS, "    const int32_t left = 0;\n")
RESOLVE_BUILDS = {
    "segments of 8 KiB": ([("linked_decode.cu", _SEG, _SEG.replace(
        "16384", "8192"))], True),
    "segments of 32 KiB": ([("linked_decode.cu", _SEG, _SEG.replace(
        "16384, kSegThreads = 512, kSegCtas = 3",
        "32768, kSegThreads = 1024, kSegCtas = 1"))], True),
    "split: the segments' searches": ([
        ("linked_decode.cuh", _RECORDS, "      continue;\n" + _RECORDS),
        *_cut("segments", _PASS)], False),
    "split: the segments' fill": (_cut("segments", _PASS), False),
    "split: + their pass": (_cut("segments", _OUTPUT), False),
    "split: the segments": (_cut("segments"), False),
    "split: + the exits' ranks": (_cut("ranks"), False),
    "split: + the rounds and the exits' bytes": (_cut("rounds"), False),
    # the list's kernel in parts: the scans for each chunk's positions;
    # with the entries; with the bytes; all (with the rounds)
    "split: the list's scans": ([
        ("linked_decode.cu", _ENTRIES, _ENTRIES.replace("i0 < len", "i0 < 0")),
        _NO_ROUNDS, ("linked_decode.cu", _BYTES, "")], False),
    "split: + the entries": ([_NO_ROUNDS, ("linked_decode.cu", _BYTES, "")],
                             False),
    "split: + the bytes (no rounds)": ([_NO_ROUNDS], False),
    "tried: every chunk scanning every word": (
        [("linked_decode.cu", "  const int64_t lo = word_past(m, words, base);",
          "  const int64_t lo = 0;"),
         ("linked_decode.cu", "  if (hi > words) hi = words;",
          "  hi = words;")], True),
    "tried: the list's kernel at 6 CTAs an SM": ([(
        "linked_decode.cu",
        "__launch_bounds__(kResolve)\n    resolve_kernel(",
        "__launch_bounds__(kResolve, 6)\n    resolve_kernel(")], True),
    "tried: the list's kernel at 8 CTAs an SM": ([(
        "linked_decode.cu",
        "__launch_bounds__(kResolve)\n    resolve_kernel(",
        "__launch_bounds__(kResolve, 8)\n    resolve_kernel(")], True),
    "tried: 16 list entries a thread at once": (
        [("linked_decode.cuh", "  LZ4TT_RS_BATCH = 8,", "  LZ4TT_RS_BATCH = 16,"),
         ("linked_decode.cu", "constexpr int kBatch = 8;",
          "constexpr int kBatch = 16;")], True),
    "tried: searches of size() probes a level": (
        [("linked_decode.cuh", "4 * t.size() > LZ4TT_RS_PROBES ? 4 * t.size()",
          "t.size() > LZ4TT_RS_PROBES ? t.size()")], True),
    "tried: records of more than 16 nodes by the team": (
        [("linked_decode.cuh", "  LZ4TT_RS_LONG = 64,", "  LZ4TT_RS_LONG = 16,")],
        True),
}


def _resolve_libs() -> dict:
    """The libraries of the first design's build (``"first design"``) and
    of each of ``RESOLVE_BUILDS``, built at once."""
    builds = {"first design": _FIRST_RESOLVE,
              **{k: v[0] for k, v in RESOLVE_BUILDS.items()}}
    root = build.build_dir().parent / "variants"
    procs = []
    try:
        for i, (name, edits) in enumerate(builds.items()):
            procs.append((name, *_nvcc_copy(root / f"resolve{i}", edits,
                                            "linked_decode")))
        logs = [proc.communicate()[0] for _, _, proc in procs]
    finally:
        for _, _, proc in procs:     # none left running on an error
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    libs = {}
    for (name, so, proc), log in zip(procs, logs):
        if proc.returncode:
            raise build.KernelBuildError(log)
        libs[name] = ctypes.CDLL(str(so))
        fn = libs[name].lz4tt_linked_resolve
        fn.argtypes, fn.restype = linked_decode.RESOLVE.argtypes, ctypes.c_int
    return libs


def _own_resolve(lib):
    """``lib``'s ``lz4tt_linked_resolve`` called as
    :func:`linked_decode.resolve_linked` calls the shipped one (room for
    ``node_cap / LIST_SHARE`` open exits), its cooperative kernel on the
    CTAs its own build holds at once (its registers may differ from the
    shipped build's): a function of ``resolve_linked``'s arguments
    returning (out, counters)."""
    ctas, threads = ctypes.c_int(), ctypes.c_int()
    if lib.lz4tt_linked_occupancy(ctypes.byref(ctas), ctypes.byref(threads)):
        raise RuntimeError("lz4tt_linked_occupancy: CUDA error")
    grid = ctas.value * torch.cuda.get_device_properties(
        torch.cuda.current_device()).multi_processor_count

    def fn(comp, tables, n_seq, block_at, n_ok, n_nodes, window, node_cap):
        dev = comp.device
        list_cap = -(-node_cap // linked_decode.LIST_SHARE)
        out = torch.empty((node_cap,), dtype=torch.uint8, device=dev)
        off = torch.empty((node_cap,), dtype=torch.int16, device=dev)
        scratch = torch.empty(
            (linked_decode.resolve_scratch(node_cap, list_cap),),
            dtype=torch.int32, device=dev)
        counters = torch.empty((4,), dtype=torch.int32, device=dev)
        if lib.lz4tt_linked_resolve(
                comp.data_ptr(), comp.stride(0), tables.data_ptr(),
                tables.shape[2], comp.shape[0], n_seq.data_ptr(),
                block_at.data_ptr(), n_ok.data_ptr(), window.data_ptr(),
                window.numel(), n_nodes.data_ptr(), node_cap, out.data_ptr(),
                off.data_ptr(), scratch.data_ptr(), list_cap,
                counters.data_ptr(), grid, layout.cuda_stream(comp)):
            raise RuntimeError("lz4tt_linked_resolve: CUDA error")
        return out, counters
    return fn


def _resolve_first(lib, comp, tables, n_seq, block_at, n_ok, n_nodes,
                   window, node_cap: int, rounds: int | None = None):
    """The first design (``lib``, the build of ``_FIRST_RESOLVE``) on a
    walked batch: ``rounds`` round kernels (by default
    ``linked_decode.rounds_for(node_cap)``); (out, each round's open
    nodes)."""
    rounds = linked_decode.rounds_for(node_cap) if rounds is None else rounds
    dev = comp.device
    out = torch.empty((node_cap,), dtype=torch.uint8, device=dev)
    nodes = torch.empty((node_cap,), dtype=torch.int32, device=dev)
    open_ = torch.zeros((rounds,), dtype=torch.int32, device=dev)
    ctas, threads = ctypes.c_int(), ctypes.c_int()
    if lib.lz4tt_linked_rounds_occupancy(ctypes.byref(ctas),
                                         ctypes.byref(threads)):
        raise RuntimeError("lz4tt_linked_rounds_occupancy: CUDA error")
    fn = lib.lz4tt_linked_resolve_rounds
    fn.argtypes, fn.restype = _FIRST_ARGS, ctypes.c_int
    if fn(comp.data_ptr(), comp.stride(0), tables.data_ptr(),
          tables.shape[2], comp.shape[0], n_seq.data_ptr(),
          block_at.data_ptr(), n_ok.data_ptr(), window.data_ptr(),
          window.numel(), n_nodes.data_ptr(), nodes.data_ptr(),
          out.data_ptr(), open_.data_ptr(), rounds,
          ctas.value * torch.cuda.get_device_properties(
              dev).multi_processor_count,
          layout.cuda_stream(comp)):
        raise RuntimeError("lz4tt_linked_resolve_rounds: CUDA error")
    return out, open_


def _peak_gib(call) -> float:
    """The device memory a call allocates at its peak, GiB."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    call()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 30


def _far_rows(dev) -> tuple:
    """``testing.far_match_frame`` at 16 x 4 MiB (64 MiB of matches at
    distances up to 65,535 after a 64 KiB window): (payload rows,
    lengths, raw flags, block size, host lengths and flags, window)."""
    window, raws, comps, bs, _ = testing.far_match_frame(
        np.random.default_rng(FORMAT_SEED), 16)
    c, cl = layout.to_device_layout(testing.payloads(raws, comps),
                                    device=dev)
    flags = [len(p) >= len(r) for r, p in zip(raws, comps)]
    return (c, cl, torch.tensor(flags, device=dev), bs,
            (cl.cpu().numpy(), np.array(flags)),
            layout.upload_bytes(window, dev))


def resolve_variants() -> dict:
    """The linked resolve's designs (CUDA events) on the formats path's
    linked frames at ``LINKED_SIZES`` and on 16 x 4 MiB of far matches
    (``_far_rows``: most bytes open exits, the list in chunks), each walked
    once: its first design (and its fill and gather alone), the shipped
    one, with room for every open exit (one chunk), at segments of 8 and
    32 KiB, options tried and its parts cumulatively (``RESOLVE_BUILDS``),
    each complete output held against the shipped one's; its kernels'
    device times; the open nodes, open exits, rounds and list chunks; the
    peak memory of each design's call."""
    dev = torch.device("cuda")
    libs = _resolve_libs()
    sets = {name: (*row, torch.empty((0,), dtype=torch.uint8, device=dev))
            for name, row in _linked_rows(dev).items()}
    sets["16 x 4 MiB of far matches"] = _far_rows(dev)
    out = {}
    for set_name, (c, cl, flags, bs, host, win) in sets.items():
        walk = linked_decode.walk_linked(c, cl, flags, bs, None, host)
        block_at, _, n_ok, n_nodes = linked_decode.frame_plan(
            walk[2], walk[3], walk[4], win.numel())
        cap = win.numel() + c.shape[0] * bs
        args = (c, walk[0], walk[1], block_at, n_ok, n_nodes, win, cap)
        want, opened = linked_decode.resolve_linked(*args)
        n = int(n_nodes)
        if int(n_ok) != c.shape[0] or int(opened[3]):
            raise SystemExit(f"design_variants: {set_name} did not resolve")
        room = -(-cap // linked_decode.LIST_SHARE)
        res = dict(zip(("open after the pass", "open exits", "rounds"),
                       opened.tolist()[:3]))
        res["list chunks"] = -(-int(opened[1]) // room)
        first = libs["first design"]
        calls = {
            "shipped": lambda: linked_decode.resolve_linked(*args),
            "first design": lambda: _resolve_first(first, *args),
            "first design: fill and gather": lambda: _resolve_first(
                first, *args, rounds=0),
            "room for every open exit": lambda: linked_decode._resolve_cuda(
                *args, max(1, int(opened[1]))),
            "room node_cap / 4": lambda: linked_decode._resolve_cuda(
                *args, -(-cap // 4)),
            "room node_cap / 64": lambda: linked_decode._resolve_cuda(
                *args, -(-cap // 64))}
        for name in RESOLVE_BUILDS:
            calls[name] = lambda fn=_own_resolve(libs[name]): fn(*args)
        for name, call in calls.items():
            check = RESOLVE_BUILDS[name][1] if name in RESOLVE_BUILDS else \
                name != "first design: fill and gather"
            if check and not torch.equal(call()[0][:n], want[:n]):
                raise SystemExit(f"design_variants: the resolve's {name} "
                                 f"differs on {set_name}")
            res[name] = testing.cuda_ms(call, REPS)
        for name in ("shipped", "first design", "room for every open exit"):
            res[f"peak GiB: {name}"] = _peak_gib(calls[name])
        res["kernels (torch.profiler, us a call)"] = testing.kernel_us(
            calls["shipped"])
        out[set_name] = res
        print(f"linked resolve, {set_name}: {json.dumps(res)}", flush=True)
    return out


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


def _cell_mix(rows: "_Rows", n: int, kind: str = "a4"):
    """The first ``n`` main-path rows (the ``block64k_hc9`` cell's mix of
    kinds) with the first row of ``kind`` first, so that team 0 takes it."""
    kinds = sharded.block_kinds(N_BLOCKS, SEED)
    first = int(np.flatnonzero(kinds == ("a4", "text", "random").index(kind))[0])
    idx = [first] + [i for i in range(n + 1) if i != first][:n - 1]
    return torch.tensor(idx, device=rows.src.device)


def hc_split() -> dict:
    """Cycles of each part of K6's searches (``_SPLIT_PARTS``) at level 9
    in the first team's lane 0: the warp kernel on one a4 row alone, on
    team 0 of 4,096 a4 rows and of 512 rows of the cell's mix (an a4 or a
    random row first); the wide kernel on the same a4 row alone and on the
    same 512 rows; each part's total cycles, calls and cycles a call."""
    so, proc = _nvcc_copy(build.build_dir().parent / "variants" / "split",
                          _SPLIT_EDITS, "lz4_hc")
    log, _ = proc.communicate()
    if proc.returncode:
        raise build.KernelBuildError(log)
    lib = ctypes.CDLL(str(so))
    fns = {}
    for kernel, symbol in (("warp", "lz4tt_compress_hc"),
                           ("wide", "lz4tt_compress_hc_wide")):
        fns[kernel] = getattr(lib, symbol)
        fns[kernel].argtypes = SYMBOLS["lz4_hc"][1]
        fns[kernel].restype = ctypes.c_int
    rows = _Rows(torch.device("cuda"))
    a4 = rows.sets["a4"]
    dev = rows.src.device.index or 0
    teams = {"warp": hc.resident_teams(dev), "wide": hc.wide_capacity(dev)}
    scratch = torch.empty((max(teams.values()) * hc.team_bytes(),),
                          dtype=torch.uint8, device=rows.src.device)
    stream = torch.cuda.current_stream().cuda_stream
    counts = (ctypes.c_ulonglong * 16)()
    out = {}
    mix, mix_random = _cell_mix(rows, 512), _cell_mix(rows, 512, "random")
    for name, kernel, pick in (
            ("1 a4 row", "warp", a4[:1]),
            ("4096 a4 rows, team 0", "warp", a4.repeat(2)[:N_BLOCKS]),
            ("512 rows of the cell's mix, team 0 (a4)", "warp", mix),
            ("512 rows of the cell's mix, team 0 (random)", "warp",
             mix_random),
            ("wide kernel, 1 a4 row", "wide", a4[:1]),
            ("wide kernel, 512 rows of the cell's mix, team 0 (a4)", "wide",
             mix),
            ("wide kernel, 512 rows of the cell's mix, team 0 (random)",
             "wide", mix_random)):
        src, lens = rows.src[pick].contiguous(), rows.lens[pick].contiguous()
        want = hc.compress_hc_batch(src, lens, rows.cap, 9)
        dest, out_lens, err = (torch.zeros_like(x) for x in want)
        lib.lz4tt_split_read(counts, 1)
        n = src.shape[0]
        if fns[kernel](src.data_ptr(), src.stride(0), lens.data_ptr(),
                       dest.data_ptr(), dest.stride(0), rows.cap, 9,
                       scratch.data_ptr(), min(n, teams[kernel]),
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


def hc_crossover(only: list[int] | None = None) -> dict:
    """K6's kernels at level 9 on the same batches of
    ``HC_CROSSOVER_SETS``' rows: a4, text or random rows (the main path's,
    taken in turn) and the cell's mix (the first main-path rows, an a4 row
    first): the
    warp kernel, the shipped wide kernel (``hc.HC_WIDE``) and the builds of
    ``HC_WIDE_BUILDS``, each launched with its resident CTAs at most
    (more rows take more rounds), each output held to the warp kernel's.
    ``only``: these batch sizes of each set alone. Returns mix -> rows ->
    kernel -> ms (three timings of two launches), with each kernel's
    resident CTAs."""
    dev = torch.device("cuda")
    index = dev.index or 0
    root = build.build_dir().parent / "variants"
    procs = {name: _nvcc_copy(root / f"crossover{i}", VARIANTS[name][1],
                              "lz4_hc")
             for i, name in enumerate(HC_WIDE_BUILDS)}
    symbol, argtypes = SYMBOLS["lz4_hc"]
    fns = {"warp kernel": build.c_function("lz4_hc", symbol, argtypes, index),
           "a CTA a row": build.c_function("lz4_hc", "lz4tt_compress_hc_wide",
                                           argtypes, index)}
    capacity = {"warp kernel": hc.resident_teams(index),
                "a CTA a row": hc.wide_capacity(index)}
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        fns[name] = lib.lz4tt_compress_hc_wide
        fns[name].argtypes, fns[name].restype = argtypes, ctypes.c_int
        occ = lib.lz4tt_hc_wide_occupancy
        ctas, threads = ctypes.c_int(0), ctypes.c_int(0)
        occ.argtypes = [ctypes.POINTER(ctypes.c_int)] * 2
        if occ(ctypes.byref(ctas), ctypes.byref(threads)):
            raise RuntimeError(f"{name}: occupancy")
        capacity[name] = ctas.value * sms
    rows = _Rows(dev)
    scratch = torch.empty((N_BLOCKS * hc.team_bytes(),), dtype=torch.uint8,
                          device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    out = {"capacity": capacity}
    kinds = torch.from_numpy(sharded.block_kinds(N_BLOCKS, SEED)).to(dev)
    for mix, sizes in HC_CROSSOVER_SETS.items():
        out[mix] = {}
        of_kind = torch.nonzero(kinds == ("a4", "text", "random").index(
            mix)).flatten() if mix != "mix" else None
        for n in [n for n in sizes if not only or n in only]:
            pick = (of_kind.repeat(-(-n // of_kind.numel()))[:n]
                    if of_kind is not None else _cell_mix(rows, n))
            src, lens = rows.src[pick].contiguous(), rows.lens[pick].contiguous()
            want = None
            times = {}
            for name, fn in fns.items():
                dest = torch.zeros((n, layout.row_stride(rows.cap)),
                                   dtype=torch.uint8, device=dev)
                ol, err = (torch.empty((n,), dtype=torch.int32, device=dev)
                           for _ in range(2))

                def call(fn=fn, name=name):
                    if fn(src.data_ptr(), src.stride(0), lens.data_ptr(),
                          dest.data_ptr(), dest.stride(0), rows.cap, 9,
                          scratch.data_ptr(), min(n, capacity[name]),
                          ol.data_ptr(), err.data_ptr(), n, stream):
                        raise RuntimeError(f"{name}: CUDA error")
                call()
                got = (dest, ol, err)
                if want is None:
                    want = tuple(x.clone() for x in got)
                elif not all(torch.equal(x, y) for x, y in zip(got, want)):
                    raise SystemExit(f"hc_crossover: {name} at {n} {mix} "
                                     "rows differs from the warp kernel")
                times[name] = [testing.cuda_ms(call, HC_REPS)
                               for _ in range(3)]
            out[mix][n] = times
            print(f"K6 crossover, {mix}, {n} rows: {json.dumps(times)}",
                  flush=True)
    return out


def k7_split() -> dict:
    """Cycles of each part of K7's window kernel (``_K7_PARTS``) in the
    first CTA's thread 0, summed over its windows, on the main path's rows
    (all, a4, text, the first 256), with the windows it took."""
    so, proc = _nvcc_copy(build.build_dir().parent / "variants" / "k7split",
                          _K7_SPLIT_EDITS, "parallel_compress")
    log, _ = proc.communicate()
    if proc.returncode:
        raise build.KernelBuildError(log)
    lib = ctypes.CDLL(str(so))
    symbol, argtypes = SYMBOLS["parallel_compress"]
    fn = getattr(lib, symbol)
    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    lib.lz4tt_split_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    rows = _Rows(torch.device("cuda"))
    stream = torch.cuda.current_stream().cuda_stream
    counts = (ctypes.c_ulonglong * 16)()
    out = {}
    for name, idx in rows.sets.items():
        call, check = _calls(fn, "parallel_compress", rows, idx, stream)
        if not check():
            raise SystemExit(f"design_variants: the K7 split build differs "
                             f"on {name}")
        torch.cuda.synchronize()
        lib.lz4tt_split_read(counts, 1)
        call()
        torch.cuda.synchronize()
        lib.lz4tt_split_read(counts, 0)
        out[name] = {"windows": counts[15],
                     **{part: counts[i] for i, part in enumerate(_K7_PARTS)}}
        print(f"K7 split, {name}: {json.dumps(out[name])}", flush=True)
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
        self.gtables = sequences.parse_sequences(self.comp, self.clens,
                                                 sentinel_tails=True)[0]
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
        self.hc9 = None

    def hc9_rows(self):
        """(comp, clens, raw rows) of ``HC9_SET``: the LZ4 rows of the
        first 512 rows compressed by K6 at level 9."""
        if self.hc9 is None:
            src, lens = self.src[:512], self.lens[:512]
            comp, clens, err = hc.compress_hc_batch(src, lens, self.cap, 9)
            keep = torch.nonzero((err == 0) & (clens < lens)).flatten()
            self.hc9 = (comp[keep].contiguous(), clens[keep].contiguous(),
                        src[keep].contiguous())
        return self.hc9

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

    if idx is HC9_SET:   # K1 alone takes it
        a, la, raw = rows.hc9_rows()
        return _codec_calls(launch, a, la, (raw, torch.full(
            (a.shape[0],), BLOCK_LEN, dtype=torch.int32, device=dev)),
            rows.src.shape[1], BLOCK_LEN, stream)
    n = idx.numel()
    if source == "parallel_compress":
        s, sl = rows.src[idx].contiguous(), rows.lens[idx].contiguous()
        width = s.shape[1]
        teams = min(n * parallel_compress.windows(width),
                    parallel_compress.resident_teams(dev.index or 0))
        scratch = torch.empty((parallel_compress.scratch_words(
            width, n, teams),), dtype=torch.int32, device=dev)
        want = parallel_compress.compress_parallel_batch(s, sl, rows.cap)
        out, ol = torch.zeros_like(want[0]), torch.empty_like(want[1])

        def call():
            launch(s.data_ptr(), s.stride(0), sl.data_ptr(), out.data_ptr(),
                   out.stride(0), rows.cap, width, scratch.data_ptr(), teams,
                   parallel_compress.wave_rows(width), ol.data_ptr(), n,
                   stream)

        def check():   # the scratch poisoned: nothing may need a reset
            out.zero_()
            scratch.fill_(0x5A5A5A5A)
            call()
            return torch.equal(out, want[0]) and torch.equal(ol, want[1])
        return call, check
    if source == "gather_decode":
        c = rows.comp[idx].contiguous()
        t = rows.gtables[:, idx].contiguous()
        s_max = t.shape[2]
        teams = min(n, gather_decode.resident_teams(dev.index or 0))
        scratch = torch.empty((teams * gather_decode.team_words(
            BLOCK_LEN, s_max),), dtype=torch.int32, device=dev)
        out = torch.empty((n, BLOCK_LEN), dtype=torch.uint8, device=dev)

        def call():
            launch(c.data_ptr(), c.stride(0), c.shape[1],
                   *(x.data_ptr() for x in t), s_max, out.data_ptr(),
                   out.stride(0), BLOCK_LEN, 32, scratch.data_ptr(), teams, n,
                   stream)

        def check():
            scratch.fill_(0x5A5A5A5A)
            call()
            return torch.equal(out, rows.src[idx][:, :BLOCK_LEN])
        return call, check
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
    want = (rows.comp[idx], rows.clens[idx]) if compress else \
        (rows.src[idx], rows.lens[idx])
    width = rows.comp.shape[1] if compress else rows.src.shape[1]
    return _codec_calls(launch, a, la, want, width,
                        rows.cap if compress else BLOCK_LEN, stream,
                        guard=not compress)


def _codec_calls(launch, a, la, want, width: int, w: int, stream,
                 guard: bool = True):
    """(call, check) of K2's or K1's safe entry point on rows ``a`` of
    lengths ``la`` into rows of ``width`` bytes, capacity ``w``; ``want``
    the output rows and lengths. With ``guard``, nothing may be written at
    or past ``w``."""
    n = a.shape[0]
    out = torch.zeros((n, width), dtype=torch.uint8, device=a.device)
    ol = torch.empty((n,), dtype=torch.int32, device=a.device)
    err = torch.empty_like(ol)

    def call():
        launch(a.data_ptr(), a.stride(0), la.data_ptr(), out.data_ptr(),
               out.stride(0), w, ol.data_ptr(), err.data_ptr(), n, stream)

    def check():
        if guard:
            out.fill_(0xA5)
        call()
        return not bool(err.any()) and torch.equal(ol, want[1]) and \
            torch.equal(out[:, :w], want[0][:, :w]) and \
            (not guard or bool((out[:, w:] == 0xA5).all()))
    return call, check


def k1_crossover() -> dict:
    """K1's two safe kernels, the warp a row and the CTA a row, timed on
    the same batches of ``CROSSOVER_ROWS`` rows: the LZ4 rows of the main
    path's rows at HC level 9 (``HC9_SET``'s kind, about 3,072 of 4,096),
    and its fast (K2) LZ4 rows, each taken in turn to the batch's size;
    each output held to the raw rows. Returns mix -> rows -> kernel -> ms,
    with the CTA-a-row kernel's resident CTAs."""
    dev = torch.device("cuda")
    src, lens = sharded.upload_blocks(
        sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED), dev)
    cap = max_compressed_length(BLOCK_LEN)
    capacity = codec.smem_capacity(dev.index or 0)
    out = {"smem_capacity": capacity}
    kernels = {"warp a row": codec.DECODE, "CTA a row": codec.DECODE_SMEM}
    for mix, compress in (("hc9", lambda: hc.compress_hc_batch(src, lens, cap,
                                                                9)),
                          ("fast", lambda: codec.compress_fast_batch(
                              src, lens, cap))):
        comp, clens, err = compress()
        keep = torch.nonzero((err == 0) & (clens < lens)).flatten()
        out[mix] = {"lz4_rows": keep.numel()}
        for n in CROSSOVER_ROWS:
            pick = keep.repeat(-(-n // keep.numel()))[:n]
            c, cl = comp[pick].contiguous(), clens[pick].contiguous()
            raw = src[pick][:, :BLOCK_LEN]
            o = torch.empty((n, src.shape[1]), dtype=torch.uint8, device=dev)
            ol = torch.empty((n,), dtype=torch.int32, device=dev)
            e = torch.empty_like(ol)
            times = {}
            for name, k in kernels.items():
                def call(k=k):
                    k(c.data_ptr(), c.stride(0), cl.data_ptr(), o.data_ptr(),
                      o.stride(0), BLOCK_LEN, ol.data_ptr(), e.data_ptr(), n,
                      torch.cuda.current_stream().cuda_stream,
                      device=dev.index or 0)
                o.zero_()
                call()
                if bool(e.any()) or not torch.equal(o[:, :BLOCK_LEN], raw):
                    raise SystemExit(f"k1_crossover: {name} at {n} {mix} "
                                     "rows differs from the raw rows")
                times[name] = [testing.cuda_ms(call, REPS) for _ in range(3)]
            out[mix][n] = times
            print(f"K1 crossover, {mix}, {n} rows: {json.dumps(times)}",
                  flush=True)
    return out


def main(argv: list[str]) -> int:
    """Build and time every variant, or those of the sources named in
    ``argv`` (``lz4_compress``, ``lz4_decode``, ``segment_decode``,
    ``lz4_parse``, ``frame_pack``, ``xxh32``, ``xxh64``, ``lz4_hc``,
    ``parallel_compress``, ``gather_decode``)."""
    if not torch.cuda.is_available():
        print("design_variants: CUDA is not available", file=sys.stderr)
        return 1
    if argv == ["--hc-split"]:
        print(json.dumps(hc_split()))
        return 0
    if argv == ["--k7-split"]:
        print(json.dumps(k7_split()))
        return 0
    if argv == ["--dict-split"]:
        print(json.dumps(dict_split()))
        return 0
    if argv == ["linked_decode"]:
        print(json.dumps({"walk": linked_variants(),
                          "resolve": resolve_variants()}))
        return 0
    if argv == ["--resolve"]:
        print(json.dumps(resolve_variants()))
        return 0
    if argv == ["--walk-split"]:
        print(json.dumps(walk_split()))
        return 0
    if argv == ["--k1-crossover"]:
        print(json.dumps(k1_crossover()))
        return 0
    if argv[:1] == ["--hc-crossover"]:
        print(json.dumps(hc_crossover([int(n) for n in argv[1:]])))
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
            if source == "lz4_decode":
                sets = [HC9_SET, *sets]
            for set_name in sets:
                if name in VARIANT_SYMBOLS and source == "lz4_hc" and \
                        not hc.speculates(rows.hc_sets()[set_name][0]):
                    continue        # the wide kernel takes no such level
                reps = REPS
                if hashed:
                    call, check = _hash_calls(lib, source, rows, set_name,
                                              stream)
                elif source == "lz4_hc":
                    symbol, argtypes = SYMBOLS[source]
                    fn = getattr(lib, VARIANT_SYMBOLS.get(name, symbol))
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    call, check = _hc_calls(fn, rows, set_name, stream)
                    reps = HC_REPS
                else:
                    symbol, argtypes = SYMBOLS[source]
                    fn = getattr(lib, VARIANT_SYMBOLS.get(name, symbol))
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
                    call, check = _calls(
                        fn, source, rows, HC9_SET if set_name == HC9_SET
                        else rows.sets[set_name], stream)
                if not check():
                    raise SystemExit(f"design_variants: {name} differs from "
                                     f"the shipped kernel on {set_name}")
                ms = testing.cuda_ms(call, reps)
                result.setdefault(name, {"registers": regs}).setdefault(
                    set_name, []).append(ms)
                print(f"round {rnd}: {name}, {set_name}: {ms:.3f} ms",
                      flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
