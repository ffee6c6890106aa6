// XXH32 of one byte string (xxhash32_hash.template:27-83, as in
// lz4_tpu/kernels/xxhash_jax.py::xxh32_batch): 16-byte stripes into four
// lane accumulators, then up to three 4-byte words, up to three bytes, and
// the avalanche. The input must start 16-byte aligned on the card, where
// stripes are read as aligned 16-byte loads, a group of them in flight
// before the rounds use them.
//
// The streaming update (lz4tt_xxh32_stream_update in xxh32.cu) absorbs its
// input a stage of LZ4TT_XXH_STAGE bytes at a time from shared memory, one
// lane at a time with lz4tt_xxh32_stage_lane, each lane carried from one
// stage to the next.
#pragma once

#include "lz4tt_common.cuh"

#define LZ4TT_P1 2654435761u
#define LZ4TT_P2 2246822519u
#define LZ4TT_P3 3266489917u
#define LZ4TT_P4 668265263u
#define LZ4TT_P5 374761393u

LZ4TT_HD uint32_t lz4tt_xxh_round(uint32_t v, uint32_t x) {
  return lz4tt_rotl32(v + x * LZ4TT_P2, 13) * LZ4TT_P1;
}

#define LZ4TT_XXH_GROUP 8  // stripes loaded together

// Absorb n_stripes 16-byte stripes of p into the lane accumulators v[4]:
// the stripe loop of the one-shot hash.
LZ4TT_HD void lz4tt_xxh32_stripes(const uint8_t* p, int64_t n_stripes, uint32_t* v) {
  uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  int64_t i = 0;
  for (; i + LZ4TT_XXH_GROUP <= n_stripes; i += LZ4TT_XXH_GROUP) {
    lz4tt_u4 w[LZ4TT_XXH_GROUP];
#pragma unroll
    for (int k = 0; k < LZ4TT_XXH_GROUP; k++) w[k] = lz4tt_load16(p + 16 * (i + k));
#pragma unroll
    for (int k = 0; k < LZ4TT_XXH_GROUP; k++) {
      v1 = lz4tt_xxh_round(v1, w[k].x);
      v2 = lz4tt_xxh_round(v2, w[k].y);
      v3 = lz4tt_xxh_round(v3, w[k].z);
      v4 = lz4tt_xxh_round(v4, w[k].w);
    }
  }
  for (; i < n_stripes; i++) {
    const lz4tt_u4 w = lz4tt_load16(p + 16 * i);
    v1 = lz4tt_xxh_round(v1, w.x);
    v2 = lz4tt_xxh_round(v2, w.y);
    v3 = lz4tt_xxh_round(v3, w.z);
    v4 = lz4tt_xxh_round(v4, w.w);
  }
  v[0] = v1;
  v[1] = v2;
  v[2] = v3;
  v[3] = v4;
}

// The streaming update's stages: bytes a stage holds (a multiple of
// 16 * LZ4TT_XXH_GROUP), and stages in the ring.
#define LZ4TT_XXH_STAGE 32768
#define LZ4TT_XXH_STAGES 4

// One round of the streaming update in its carried form (see below):
// rotl(w, 13) * P1 + y, which the card runs as one funnel shift and one
// multiply-add, two dependent instructions.
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

// Stripes in stage i of an update of n_stripes stripes.
LZ4TT_HD int32_t lz4tt_xxh32_stage_stripes(int64_t n_stripes, int64_t i) {
  const int64_t left = n_stripes - i * (LZ4TT_XXH_STAGE / 16);
  return (int32_t)(left < LZ4TT_XXH_STAGE / 16 ? left : LZ4TT_XXH_STAGE / 16);
}

// Absorb lane k (0..3) of the n 16-byte stripes of a stage p (16-byte
// aligned, in shared memory on the card) into v, that lane's accumulator;
// returns the new accumulator. The rounds are carried as w = v + x * P2,
// so that a stripe is w = rotl(w, 13) * P1 + x' * P2 (lz4tt_xxh32_step):
// two dependent instructions, with the product x' * P2 off the chain. The
// loads of the next group of stripes are issued before the rounds of the
// current one, so the chain never waits for shared memory.
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
  for (int32_t i = 1 + LZ4TT_XXH_GROUP * groups; i < n; i++)
    w = lz4tt_xxh32_step(w, lz4tt_ld32(q + 16 * i) * LZ4TT_P2);
  return lz4tt_rotl32(w, 13) * LZ4TT_P1;
}

LZ4TT_HD uint32_t lz4tt_xxh32(const uint8_t* p, int64_t len, uint32_t seed) {
  uint32_t v[4] = {seed + LZ4TT_P1 + LZ4TT_P2, seed + LZ4TT_P2, seed, seed - LZ4TT_P1};
  const int64_t n_stripes = len / 16;
  lz4tt_xxh32_stripes(p, n_stripes, v);
  const uint32_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  uint32_t h = len >= 16 ? lz4tt_rotl32(v1, 1) + lz4tt_rotl32(v2, 7) +
                               lz4tt_rotl32(v3, 12) + lz4tt_rotl32(v4, 18)
                         : seed + LZ4TT_P5;
  h += (uint32_t)len;
  int64_t pos = n_stripes * 16;
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
