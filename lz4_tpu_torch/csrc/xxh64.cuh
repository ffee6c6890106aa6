// XXH64 of one byte string (xxhash64_hash.template:27-103, as in
// lz4_tpu/core/xxhash_ref.py::xxh64): 32-byte stripes into four 64-bit lane
// accumulators, the merge of the four lanes, then up to three 8-byte words,
// one 4-byte word, up to three bytes, and the avalanche. Arithmetic is native
// uint64_t; a multiply keeps the low 64 bits of the product. The input must
// start 16-byte aligned on the card, where a stripe is two aligned 16-byte
// loads, a group of stripes in flight before the rounds use them. The
// stripe loop is shared with the streaming update
// (lz4tt_xxh64_stream_update in xxh64.cu).
#pragma once

#include "lz4tt_common.cuh"

#define LZ4TT_Q1 11400714785074694791ull
#define LZ4TT_Q2 14029467366897019727ull
#define LZ4TT_Q3 1609587929392839161ull
#define LZ4TT_Q4 9650029242287828579ull
#define LZ4TT_Q5 2870177450012600261ull

LZ4TT_HD uint64_t lz4tt_rotl64(uint64_t v, int n) {
  return (v << n) | (v >> (64 - n));
}

LZ4TT_HD uint64_t lz4tt_read64(const uint8_t* p, int64_t i) {
  return (uint64_t)lz4tt_read32(p, i) | ((uint64_t)lz4tt_read32(p, i + 4) << 32);
}

LZ4TT_HD uint64_t lz4tt_xxh64_round(uint64_t v, uint64_t x) {
  return lz4tt_rotl64(v + x * LZ4TT_Q2, 31) * LZ4TT_Q1;
}

LZ4TT_HD uint64_t lz4tt_xxh64_merge(uint64_t h, uint64_t v) {
  return (h ^ lz4tt_xxh64_round(0, v)) * LZ4TT_Q1 + LZ4TT_Q4;
}

// little-endian 64-bit words of a 16-byte load
LZ4TT_HD uint64_t lz4tt_lo64(const lz4tt_u4& w) {
  return (uint64_t)w.x | ((uint64_t)w.y << 32);
}
LZ4TT_HD uint64_t lz4tt_hi64(const lz4tt_u4& w) {
  return (uint64_t)w.z | ((uint64_t)w.w << 32);
}

#define LZ4TT_XXH64_GROUP 4  // stripes loaded together: eight 16-byte loads

// Absorb n_stripes 32-byte stripes of p into the lane accumulators v[4]:
// the stripe loop of the one-shot hash and of the streaming update.
LZ4TT_HD void lz4tt_xxh64_stripes(const uint8_t* p, int64_t n_stripes, uint64_t* v) {
  uint64_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  int64_t i = 0;
  for (; i + LZ4TT_XXH64_GROUP <= n_stripes; i += LZ4TT_XXH64_GROUP) {
    lz4tt_u4 w[2 * LZ4TT_XXH64_GROUP];
#pragma unroll
    for (int k = 0; k < 2 * LZ4TT_XXH64_GROUP; k++) w[k] = lz4tt_load16(p + 32 * i + 16 * k);
#pragma unroll
    for (int k = 0; k < LZ4TT_XXH64_GROUP; k++) {
      v1 = lz4tt_xxh64_round(v1, lz4tt_lo64(w[2 * k]));
      v2 = lz4tt_xxh64_round(v2, lz4tt_hi64(w[2 * k]));
      v3 = lz4tt_xxh64_round(v3, lz4tt_lo64(w[2 * k + 1]));
      v4 = lz4tt_xxh64_round(v4, lz4tt_hi64(w[2 * k + 1]));
    }
  }
  for (; i < n_stripes; i++) {
    const lz4tt_u4 a = lz4tt_load16(p + 32 * i);
    const lz4tt_u4 b = lz4tt_load16(p + 32 * i + 16);
    v1 = lz4tt_xxh64_round(v1, lz4tt_lo64(a));
    v2 = lz4tt_xxh64_round(v2, lz4tt_hi64(a));
    v3 = lz4tt_xxh64_round(v3, lz4tt_lo64(b));
    v4 = lz4tt_xxh64_round(v4, lz4tt_hi64(b));
  }
  v[0] = v1;
  v[1] = v2;
  v[2] = v3;
  v[3] = v4;
}

LZ4TT_HD uint64_t lz4tt_xxh64(const uint8_t* p, int64_t len, uint64_t seed) {
  uint64_t v[4] = {seed + LZ4TT_Q1 + LZ4TT_Q2, seed + LZ4TT_Q2, seed, seed - LZ4TT_Q1};
  const int64_t n_stripes = len / 32;
  lz4tt_xxh64_stripes(p, n_stripes, v);
  const uint64_t v1 = v[0], v2 = v[1], v3 = v[2], v4 = v[3];
  uint64_t h;
  if (len >= 32) {
    h = lz4tt_rotl64(v1, 1) + lz4tt_rotl64(v2, 7) + lz4tt_rotl64(v3, 12) +
        lz4tt_rotl64(v4, 18);
    h = lz4tt_xxh64_merge(h, v1);
    h = lz4tt_xxh64_merge(h, v2);
    h = lz4tt_xxh64_merge(h, v3);
    h = lz4tt_xxh64_merge(h, v4);
  } else {
    h = seed + LZ4TT_Q5;
  }
  h += (uint64_t)len;
  int64_t pos = n_stripes * 32;
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
