// XXH32 of one byte string (xxhash32_hash.template:27-83, as in
// lz4_tpu/kernels/xxhash_jax.py::xxh32_batch), in the pieces a CTA of K3 or
// of the streaming update runs (xxh32.cu, over the ring of
// lz4tt_xxh_ring.cuh): the lane accumulators' start, the stage body that
// absorbs one lane of a stage's 16-byte stripes from shared memory, and
// the finish (up to three 4-byte words, up to three bytes, the avalanche).
// The host tests compose them as the kernel does.
#pragma once

#include "lz4tt_common.cuh"
#include "lz4tt_xxh_ring.cuh"

#define LZ4TT_P1 2654435761u
#define LZ4TT_P2 2246822519u
#define LZ4TT_P3 3266489917u
#define LZ4TT_P4 668265263u
#define LZ4TT_P5 374761393u

#define LZ4TT_XXH_GROUP 8  // stripes loaded together

// Lane k's accumulator before the first stripe.
LZ4TT_HD uint32_t lz4tt_xxh32_lane_init(uint32_t seed, int k) {
  return k == 0 ? seed + LZ4TT_P1 + LZ4TT_P2 : k == 1 ? seed + LZ4TT_P2 : k == 2 ? seed : seed - LZ4TT_P1;
}

// One round in its carried form (see below): rotl(w, 13) * P1 + y, which
// the card runs as one funnel shift and one multiply-add, two dependent
// instructions.
LZ4TT_HD uint32_t lz4tt_xxh32_step(uint32_t w, uint32_t y) {
#ifdef __CUDA_ARCH__
  uint32_t o;
  asm("mad.lo.u32 %0, %1, %2, %3;"
      : "=r"(o)
      : "r"(__funnelshift_l(w, w, 13)), "r"(LZ4TT_P1), "r"(y));
  return o;
#else
  return lz4tt_rotl32(w, 13) * LZ4TT_P1 + y;
#endif
}

// Absorb lane k (0..3) of the n 16-byte stripes of a stage p (16-byte
// aligned, in shared memory on the card) into v, that lane's accumulator;
// returns the new accumulator. The rounds rotl(v + x * P2, 13) * P1 are
// carried as w = v + x * P2, so that a stripe is w = rotl(w, 13) * P1 +
// x' * P2 (lz4tt_xxh32_step): two dependent instructions, with the product
// x' * P2 off the chain. The loads of the next group of stripes are issued
// before the rounds of the current one, and those of the last, partial
// group all together, so the chain never waits for shared memory.
LZ4TT_HD uint32_t lz4tt_xxh32_stage_lane(const uint8_t* p, int32_t n, int k,
                                         uint32_t v) {
  if (n <= 0) return v;
  const uint8_t* q = p + 4 * k;
  uint32_t w = v + lz4tt_ld32(q) * LZ4TT_P2;
  const int32_t groups = (n - 1) / LZ4TT_XXH_GROUP;
  uint32_t a[LZ4TT_XXH_GROUP];
  if (groups > 0) {
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH_GROUP; j++) a[j] = lz4tt_ld32(q + 16 * (1 + j));
  }
  for (int32_t g = 0; g < groups; g++) {
    const int32_t next = 1 + LZ4TT_XXH_GROUP * (g + 1 < groups ? g + 1 : g);
    uint32_t b[LZ4TT_XXH_GROUP];
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH_GROUP; j++) b[j] = lz4tt_ld32(q + 16 * (next + j));
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH_GROUP; j++)
      w = lz4tt_xxh32_step(w, a[j] * LZ4TT_P2);
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH_GROUP; j++) a[j] = b[j];
  }
  const int32_t rest = 1 + LZ4TT_XXH_GROUP * groups;
#pragma unroll
  for (int j = 0; j < LZ4TT_XXH_GROUP - 1; j++)
    if (rest + j < n) a[j] = lz4tt_ld32(q + 16 * (rest + j));
#pragma unroll
  for (int j = 0; j < LZ4TT_XXH_GROUP - 1; j++)
    if (rest + j < n) w = lz4tt_xxh32_step(w, a[j] * LZ4TT_P2);
  return lz4tt_rotl32(w, 13) * LZ4TT_P1;
}

// The hash of the len bytes at p from its lanes v[4] (all of p's whole
// stripes absorbed): the lanes' merge, the length, the bytes after the last
// whole stripe, read from p, and the avalanche.
LZ4TT_HD uint32_t lz4tt_xxh32_finish(const uint32_t* v, const uint8_t* p, int64_t len,
                                     uint32_t seed) {
  uint32_t h = len >= 16 ? lz4tt_rotl32(v[0], 1) + lz4tt_rotl32(v[1], 7) +
                               lz4tt_rotl32(v[2], 12) + lz4tt_rotl32(v[3], 18)
                         : seed + LZ4TT_P5;
  h += (uint32_t)len;
  int64_t pos = len / 16 * 16;
  for (; pos + 4 <= len; pos += 4)
    h = lz4tt_rotl32(h + lz4tt_read32(p, pos) * LZ4TT_P3, 17) * LZ4TT_P4;
  for (; pos < len; pos++) h = lz4tt_rotl32(h + (uint32_t)p[pos] * LZ4TT_P5, 11) * LZ4TT_P1;
  h ^= h >> 15;
  h *= LZ4TT_P2;
  h ^= h >> 13;
  h *= LZ4TT_P3;
  h ^= h >> 16;
  return h;
}
