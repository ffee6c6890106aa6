// Shared definitions of the port's kernels.
//
// Each kernel keeps its per-block body in a header, written against a
// "team" of lanes: a warp on the card (WarpTeam), one thread in the host
// build (HostTeam) that the CPU tests compile with g++. In the block codec
// the serial walk (the compressor's scan, the decoder's tokens) runs on the
// leader lane alone, which hands the whole team jobs (Lz4ttJob): copies,
// compares and writes that split across lanes; between jobs the team
// waits at one broadcast. The other bodies keep a team's control flow
// uniform and split only copies across lanes.
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
  LZ4TT_HD int32_t shfl(int32_t v, int) const { return v; }
  LZ4TT_HD int32_t bcast(int32_t v) const { return v; }
  LZ4TT_HD unsigned match_any(uint32_t) const { return 1u; }
  LZ4TT_HD uint32_t reduce_max(uint32_t v) const { return v; }
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
  LZ4TT_HD int32_t bcast(int32_t v) const { return shfl(v, 0); }
  // value of v on lane src, on every lane
  LZ4TT_HD int32_t shfl(int32_t v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, src);
#else
    return v;
#endif
  }
  // the lanes whose v equals this lane's
  LZ4TT_HD unsigned match_any(uint32_t v) const {
#ifdef __CUDA_ARCH__
    return __match_any_sync(0xffffffffu, v);
#else
    return 1u;
#endif
  }
  // the largest v of the team, on every lane
  LZ4TT_HD uint32_t reduce_max(uint32_t v) const {
#ifdef __CUDA_ARCH__
    return __reduce_max_sync(0xffffffffu, v);
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

// Index of the highest set bit, for x != 0.
LZ4TT_HD int lz4tt_fls(unsigned x) {
#ifdef __CUDA_ARCH__
  return 31 - __clz(x);
#else
  return 31 - __builtin_clz(x);
#endif
}

// Number of set bits.
LZ4TT_HD int lz4tt_popc(unsigned x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
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

// An aligned 16-byte store.
LZ4TT_HD void lz4tt_store16(uint8_t* dst, const uint8_t* src) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
#else
  memcpy(dst, src, 16);
#endif
}

// Four little-endian words as one aligned 16-byte store.
LZ4TT_HD void lz4tt_store16w(uint8_t* dst, const uint32_t a[4]) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(a[0], a[1], a[2], a[3]);
#else
  memcpy(dst, a, 16);  // the host build runs on little-endian machines
#endif
}

// Sixteen zero bytes at an aligned address.
LZ4TT_HD void lz4tt_zero16(uint8_t* dst) {
#ifdef __CUDA_ARCH__
  *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
#else
  memset(dst, 0, 16);
#endif
}

// The low 32 bits of (hi:lo) >> (sh & 31): __funnelshift_r.
LZ4TT_HD uint32_t lz4tt_funnel_r(uint32_t lo, uint32_t hi, int sh) {
#ifdef __CUDA_ARCH__
  return __funnelshift_r(lo, hi, sh);
#else
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
#endif
}

// One aligned 32-bit word.
LZ4TT_HD uint32_t lz4tt_ld32(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t v;
  memcpy(&v, p, 4);
  return v;
#endif
}

// Byte k (0..3) of the word, as an int.
LZ4TT_HD uint32_t lz4tt_byte(uint32_t w, int k) { return (w >> (8 * k)) & 0xFF; }

// The n bytes p[i, i + n), 1 <= n <= 16, little-endian in a[0..3] (bytes
// past n are unspecified), from at most five aligned word loads and funnel
// shifts. Only words that hold one of the n bytes are read, so the loads
// never leave the memory those bytes lie in.
LZ4TT_HD void lz4tt_load_upto16(const uint8_t* p, int64_t i, int32_t n,
                                uint32_t a[4]) {
  const uintptr_t addr = (uintptr_t)(p + i);
  const uint8_t* w = (const uint8_t*)(addr & ~(uintptr_t)3);
  const int mis = (int)(addr & 3);
  const int last = (mis + n - 1) >> 2;  // the last word that holds a byte
  uint32_t v[5];
#pragma unroll
  for (int k = 0; k < 5; k++) v[k] = k <= last ? lz4tt_ld32(w + 4 * k) : 0u;
#pragma unroll
  for (int k = 0; k < 4; k++) a[k] = lz4tt_funnel_r(v[k], v[k + 1], 8 * mis);
}

// Byte r (0..15) of four little-endian words by selects, not an indexed
// (local-memory) array; a constant r folds to one shift.
LZ4TT_HD uint32_t lz4tt_byte16(const uint32_t a[4], int r) {
  const uint32_t w = r < 8 ? (r < 4 ? a[0] : a[1]) : (r < 12 ? a[2] : a[3]);
  return lz4tt_byte(w, r & 3);
}

// Inclusive sum of v over the team's lanes up to this one.
template <class Team>
LZ4TT_HD int32_t lz4tt_team_scan(const Team& t, int32_t v) {
  const int lane = t.lane();
  for (int o = 1; o < t.size(); o <<= 1) {
    const int32_t u = t.shfl(v, lane >= o ? lane - o : 0);
    if (lane >= o) v += u;
  }
  return v;
}

// A unit of work the leader lane hands to its whole team (see the
// compress and decode bodies): its kind, a count and three operands.
struct Lz4ttJob {
  int32_t kind, n, a, b, c;
};

template <class Team>
LZ4TT_HD Lz4ttJob lz4tt_bcast_job(const Team& t, Lz4ttJob j) {
  return {t.bcast(j.kind), t.bcast(j.n), t.bcast(j.a), t.bcast(j.b),
          t.bcast(j.c)};
}
