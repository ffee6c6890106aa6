// XXH64 of one byte string (xxhash64_hash.template:27-103, as in
// lz4_tpu/core/xxhash_ref.py::xxh64), in the pieces a CTA of K4 or of the
// streaming update runs (xxh64.cu, over the ring of lz4tt_xxh_ring.cuh):
// the lane accumulators' start, the stage body that absorbs one lane of a
// stage's 32-byte stripes from shared memory, and the finish (the merge of
// the four lanes, up to three 8-byte words, one 4-byte word, up to three
// bytes, the avalanche). Arithmetic is native uint64_t; a multiply keeps
// the low 64 bits of the product. The host tests compose the pieces as
// the kernel does.
#pragma once

#include "lz4tt_common.cuh"
#include "lz4tt_xxh_ring.cuh"

#define LZ4TT_Q1 11400714785074694791ull
#define LZ4TT_Q2 14029467366897019727ull
#define LZ4TT_Q3 1609587929392839161ull
#define LZ4TT_Q4 9650029242287828579ull
#define LZ4TT_Q5 2870177450012600261ull

#define LZ4TT_XXH64_GROUP 8  // stripes loaded together

LZ4TT_HD uint64_t lz4tt_rotl64(uint64_t v, int n) {
  return (v << n) | (v >> (64 - n));
}

LZ4TT_HD uint64_t lz4tt_read64(const uint8_t* p, int64_t i) {
  return (uint64_t)lz4tt_read32(p, i) | ((uint64_t)lz4tt_read32(p, i + 4) << 32);
}

// One aligned 64-bit word.
LZ4TT_HD uint64_t lz4tt_ld64(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint64_t*>(p);
#else
  uint64_t v;
  memcpy(&v, p, 8);
  return v;
#endif
}

LZ4TT_HD uint64_t lz4tt_xxh64_round(uint64_t v, uint64_t x) {
  return lz4tt_rotl64(v + x * LZ4TT_Q2, 31) * LZ4TT_Q1;
}

LZ4TT_HD uint64_t lz4tt_xxh64_merge(uint64_t h, uint64_t v) {
  return (h ^ lz4tt_xxh64_round(0, v)) * LZ4TT_Q1 + LZ4TT_Q4;
}

// Lane k's accumulator before the first stripe.
LZ4TT_HD uint64_t lz4tt_xxh64_lane_init(uint64_t seed, int k) {
  return k == 0 ? seed + LZ4TT_Q1 + LZ4TT_Q2 : k == 1 ? seed + LZ4TT_Q2 : k == 2 ? seed : seed - LZ4TT_Q1;
}

// One round in its carried form (see below): rotl(w, 31) * Q1 + y, a 64-bit
// rotate (two funnel shifts) and one 64-bit multiply-add.
LZ4TT_HD uint64_t lz4tt_xxh64_step(uint64_t w, uint64_t y) {
#ifdef __CUDA_ARCH__
  uint64_t o;
  asm("mad.lo.u64 %0, %1, %2, %3;" : "=l"(o) : "l"(lz4tt_rotl64(w, 31)), "l"(LZ4TT_Q1), "l"(y));
  return o;
#else
  return lz4tt_rotl64(w, 31) * LZ4TT_Q1 + y;
#endif
}

// Absorb lane k (0..3) of the n 32-byte stripes of a stage p (16-byte
// aligned, in shared memory on the card) into v, that lane's accumulator;
// returns the new accumulator. As lz4tt_xxh32_stage_lane: the rounds
// rotl(v + x * Q2, 31) * Q1 carried as w = v + x * Q2, so that a stripe is
// w = rotl(w, 31) * Q1 + x' * Q2 (lz4tt_xxh64_step) with the product
// x' * Q2 off the chain; the next group's loads issued before the current
// group's rounds, the last partial group's all together.
LZ4TT_HD uint64_t lz4tt_xxh64_stage_lane(const uint8_t* p, int32_t n, int k,
                                         uint64_t v) {
  if (n <= 0) return v;
  const uint8_t* q = p + 8 * k;
  uint64_t w = v + lz4tt_ld64(q) * LZ4TT_Q2;
  const int32_t groups = (n - 1) / LZ4TT_XXH64_GROUP;
  uint64_t a[LZ4TT_XXH64_GROUP];
  if (groups > 0) {
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH64_GROUP; j++) a[j] = lz4tt_ld64(q + 32 * (1 + j));
  }
  for (int32_t g = 0; g < groups; g++) {
    const int32_t next = 1 + LZ4TT_XXH64_GROUP * (g + 1 < groups ? g + 1 : g);
    uint64_t b[LZ4TT_XXH64_GROUP];
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH64_GROUP; j++) b[j] = lz4tt_ld64(q + 32 * (next + j));
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH64_GROUP; j++)
      w = lz4tt_xxh64_step(w, a[j] * LZ4TT_Q2);
#pragma unroll
    for (int j = 0; j < LZ4TT_XXH64_GROUP; j++) a[j] = b[j];
  }
  const int32_t rest = 1 + LZ4TT_XXH64_GROUP * groups;
#pragma unroll
  for (int j = 0; j < LZ4TT_XXH64_GROUP - 1; j++)
    if (rest + j < n) a[j] = lz4tt_ld64(q + 32 * (rest + j));
#pragma unroll
  for (int j = 0; j < LZ4TT_XXH64_GROUP - 1; j++)
    if (rest + j < n) w = lz4tt_xxh64_step(w, a[j] * LZ4TT_Q2);
  return lz4tt_rotl64(w, 31) * LZ4TT_Q1;
}

// The hash of the len bytes at p from its lanes v[4] (all of p's whole
// stripes absorbed): the merge, the length, the bytes after the last whole
// stripe, read from p, and the avalanche.
LZ4TT_HD uint64_t lz4tt_xxh64_finish(const uint64_t* v, const uint8_t* p, int64_t len,
                                     uint64_t seed) {
  uint64_t h;
  if (len >= 32) {
    h = lz4tt_rotl64(v[0], 1) + lz4tt_rotl64(v[1], 7) + lz4tt_rotl64(v[2], 12) +
        lz4tt_rotl64(v[3], 18);
    for (int k = 0; k < 4; k++) h = lz4tt_xxh64_merge(h, v[k]);
  } else {
    h = seed + LZ4TT_Q5;
  }
  h += (uint64_t)len;
  int64_t pos = len / 32 * 32;
  for (; pos + 8 <= len; pos += 8)
    h = lz4tt_rotl64(h ^ lz4tt_xxh64_round(0, lz4tt_read64(p, pos)), 27) * LZ4TT_Q1 +
        LZ4TT_Q4;
  if (pos + 4 <= len) {
    h = lz4tt_rotl64(h ^ ((uint64_t)lz4tt_read32(p, pos) * LZ4TT_Q1), 23) * LZ4TT_Q2 +
        LZ4TT_Q3;
    pos += 4;
  }
  for (; pos < len; pos++) h = lz4tt_rotl64(h ^ ((uint64_t)p[pos] * LZ4TT_Q5), 11) * LZ4TT_Q1;
  h ^= h >> 33;
  h *= LZ4TT_Q2;
  h ^= h >> 29;
  h *= LZ4TT_Q3;
  h ^= h >> 32;
  return h;
}
