// Shared definitions of the port's kernels.
//
// Each kernel keeps its per-block body in a header, written against a
// "team" of lanes: a warp on the card (WarpTeam), one thread in the host
// build (HostTeam) that the CPU tests compile with g++. Control flow is
// uniform across a team: every lane walks the same tokens and positions,
// and only byte copies and compares are split across lanes. State that
// must have one writer (the compressor's hash table, single output bytes)
// is touched by the leader lane alone.
#pragma once

#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define LZ4TT_HD __host__ __device__ __forceinline__
#else
#define LZ4TT_HD inline
#endif

enum { LZ4TT_OK = 0, LZ4TT_ERR_MALFORMED = 1, LZ4TT_ERR_DEST_TOO_SMALL = 2 };

// LZ4 block format constants (lz4_tpu_torch/core/constants.py).
enum {
  LZ4TT_MIN_MATCH = 4,
  LZ4TT_COPY_LENGTH = 8,
  LZ4TT_LAST_LITERALS = 5,
  LZ4TT_MF_LIMIT = 12,
  LZ4TT_MIN_LENGTH = 13,
  LZ4TT_ML_BITS = 4,
  LZ4TT_ML_MASK = 15,
  LZ4TT_RUN_MASK = 15,
  LZ4TT_SKIP_STRENGTH = 6,
  LZ4TT_MAX_DISTANCE = 65536,
  LZ4TT_64K_LIMIT = 65547,
  LZ4TT_HASH_LOG = 12,
  LZ4TT_HASH_LOG_64K = 13,
};

struct HostTeam {
  LZ4TT_HD int lane() const { return 0; }
  LZ4TT_HD int size() const { return 1; }
  LZ4TT_HD bool leader() const { return true; }
  LZ4TT_HD void sync() const {}
  LZ4TT_HD unsigned ballot(bool p) const { return p ? 1u : 0u; }
  LZ4TT_HD int32_t bcast(int32_t v) const { return v; }
};

// One warp. The members are __host__ __device__ so that templates
// instantiated with it compile on both sides; only the device side runs.
struct WarpTeam {
  LZ4TT_HD int lane() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x & 31;
#else
    return 0;
#endif
  }
  LZ4TT_HD int size() const { return 32; }
  LZ4TT_HD bool leader() const { return lane() == 0; }
  LZ4TT_HD void sync() const {
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
  }
  LZ4TT_HD unsigned ballot(bool p) const {
#ifdef __CUDA_ARCH__
    return __ballot_sync(0xffffffffu, p);
#else
    return p ? 1u : 0u;
#endif
  }
  // value of v on the leader lane, on every lane
  LZ4TT_HD int32_t bcast(int32_t v) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, 0);
#else
    return v;
#endif
  }
};

// 1-based index of the lowest set bit, 0 for x == 0.
LZ4TT_HD int lz4tt_ffs(unsigned x) {
#ifdef __CUDA_ARCH__
  return __ffs(x);
#else
  return __builtin_ffs(x);
#endif
}

LZ4TT_HD uint32_t lz4tt_read32(const uint8_t* p, int64_t i) {
  return (uint32_t)p[i] | ((uint32_t)p[i + 1] << 8) |
         ((uint32_t)p[i + 2] << 16) | ((uint32_t)p[i + 3] << 24);
}

LZ4TT_HD uint32_t lz4tt_rotl32(uint32_t v, int n) {
  return (v << n) | (v >> (32 - n));
}

// An aligned 16-byte load: one vector load through the read-only cache on
// the card.
struct lz4tt_u4 {
  uint32_t x, y, z, w;
};

LZ4TT_HD lz4tt_u4 lz4tt_load16(const uint8_t* p) {
  lz4tt_u4 r;
#ifdef __CUDA_ARCH__
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  r.x = v.x;
  r.y = v.y;
  r.z = v.z;
  r.w = v.w;
#else
  memcpy(&r, p, 16);  // the host build runs on little-endian machines
#endif
  return r;
}
