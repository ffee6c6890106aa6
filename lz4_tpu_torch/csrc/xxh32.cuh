// XXH32 of one byte string (xxhash32_hash.template:27-83, as in
// lz4_tpu/kernels/xxhash_jax.py::xxh32_batch): 16-byte stripes into four
// lane accumulators, then up to three 4-byte words, up to three bytes, and
// the avalanche. The input must start 16-byte aligned on the card, where
// stripes are read as aligned 16-byte loads, a group of them in flight
// before the rounds use them. The stripe loop is shared with the streaming
// update (lz4tt_xxh32_stream_update in xxh32.cu).
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
// the stripe loop of the one-shot hash and of the streaming update.
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
