// A CTA as a block team (csrc/parallel_compress.cuh): the collectives of
// K7 and K8 over the kThreads threads of one CTA, from warp shuffles and a
// little shared memory (Shared, which the kernel provides, and for
// sort_pass kWarps x 256 int32 counters). Every collective starts with a
// barrier, so that it never overwrites what the one before is still
// reading. Only the card runs it: the members are __host__ __device__ for
// the bodies' templates, and empty on the host side; the host builds of
// the bodies run Lz4ttBlockSerial or a team of host threads instead.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define LZ4TT_CTA __host__ __device__ __forceinline__

template <int kThreads>
struct CtaTeam {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  static constexpr int kWarps = kThreads / 32;
  struct Shared {
    int32_t warp[32];
  };
  Shared* sh;
  int32_t* cnt;  // kWarps x 256 counters for sort_pass; null without a sort

  LZ4TT_CTA int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  LZ4TT_CTA int size() const { return kThreads; }
  LZ4TT_CTA void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  LZ4TT_CTA bool any(bool p) const {
#ifdef __CUDA_ARCH__
    return __syncthreads_or(p) != 0;
#else
    return p;
#endif
  }
  LZ4TT_CTA int32_t add(int32_t* p, int32_t v) const {
#ifdef __CUDA_ARCH__
    return atomicAdd(p, v);
#else
    return 0;
#endif
  }
  // A slot of *counter (its old value plus this thread's place): one
  // atomic a warp for the lanes that call it together.
  LZ4TT_CTA int32_t slot(int32_t* counter) const {
#ifdef __CUDA_ARCH__
    const auto g = cooperative_groups::coalesced_threads();
    int32_t base = 0;
    if (g.thread_rank() == 0) base = atomicAdd(counter, (int32_t)g.size());
    return g.shfl(base, 0) + (int32_t)g.thread_rank();
#else
    return 0;
#endif
  }

  // A warp's collectives; every lane of the warp calls them.
  LZ4TT_CTA int warp_size() const { return 32; }
  LZ4TT_CTA int32_t warp_min(int32_t v) const {
#ifdef __CUDA_ARCH__
    return __reduce_min_sync(0xffffffffu, v);
#else
    return v;
#endif
  }
  LZ4TT_CTA int32_t warp_suffix_min(int32_t v) const {
#ifdef __CUDA_ARCH__
    const int lane = threadIdx.x & 31;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_down_sync(0xffffffffu, v, o);
      if (lane + o < 32) v = u < v ? u : v;
    }
#endif
    return v;
  }
  LZ4TT_CTA int32_t warp_bcast(int32_t v, int src) const {
#ifdef __CUDA_ARCH__
    return __shfl_sync(0xffffffffu, v, src);
#else
    return v;
#endif
  }

  LZ4TT_CTA int32_t warp_count(bool p) const {
#ifdef __CUDA_ARCH__
    return __popc(__ballot_sync(0xffffffffu, p));
#else
    return p ? 1 : 0;
#endif
  }
  LZ4TT_CTA int32_t warp_rank(bool p) const {
#ifdef __CUDA_ARCH__
    return __popc(__ballot_sync(0xffffffffu, p) &
                  ((1u << (threadIdx.x & 31)) - 1u));
#else
    return 0;
#endif
  }

  // Exclusive scan of v over the CTA, a sum or (kMin) a min (INT32_MAX on
  // thread 0); *total is the sum or min over all threads.
  template <bool kMin>
  LZ4TT_CTA static int32_t op(int32_t a, int32_t b) {
    return kMin ? (a < b ? a : b) : a + b;
  }
  template <bool kMin>
  LZ4TT_CTA int32_t scan(int32_t v, int32_t* total) const {
#ifdef __CUDA_ARCH__
    const int32_t id = kMin ? INT32_MAX : 0;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = op<kMin>(v, u);
    }
    int32_t ex = __shfl_up_sync(0xffffffffu, v, 1);
    if (lane == 0) ex = id;
    __syncthreads();
    if (lane == 31) sh->warp[w] = v;
    __syncthreads();
    if (w == 0) {
      int32_t x = lane < kWarps ? sh->warp[lane] : id;
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x = op<kMin>(x, u);
      }
      if (lane < kWarps) sh->warp[lane] = x;
    }
    __syncthreads();
    *total = sh->warp[kWarps - 1];
    return w > 0 ? op<kMin>(sh->warp[w - 1], ex) : ex;
#else
    *total = v;
    return kMin ? INT32_MAX : 0;
#endif
  }

  LZ4TT_CTA int32_t exclusive_sum(int32_t v, int32_t* total) const {
    return scan<false>(v, total);
  }

  LZ4TT_CTA int32_t exclusive_min(int32_t v, int32_t* total) const {
    return scan<true>(v, total);
  }

  // The lanes whose digit d (below 1 << bits, or 1 << bits for none) is
  // this lane's: one ballot a bit (match_any is far slower).
  LZ4TT_CTA static unsigned peers(uint32_t d, int bits) {
#ifdef __CUDA_ARCH__
    unsigned m = 0xffffffffu;
    for (int b = 0; b <= bits; b++) {
      const bool on = (d >> b) & 1u;
      const unsigned v = __ballot_sync(0xffffffffu, on);
      m &= on ? v : ~v;
    }
    return m;
#else
    return 1u;
#endif
  }

  // A stable counting sort of ks[0, m) (and vs when not null) by the digit
  // (k >> shift) & mask, mask = 2^bits - 1 < 256, into kd (vd). Warp w
  // takes a slice of the keys, 32 at a time: the lanes with the same digit
  // find each other (peers); each warp counts its digits in its own 256
  // counters, one scan turns the counts into offsets (digit-major, then
  // warp order), and each warp scatters its slice in order. Eight tiles of
  // keys are loaded before any is counted, so that their loads overlap.
  LZ4TT_CTA void sort_pass(const uint32_t* ks, const int32_t* vs, uint32_t* kd,
                           int32_t* vd, int32_t m, int shift,
                           uint32_t mask) const {
#ifdef __CUDA_ARCH__
    constexpr int kTiles = 8;
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const unsigned below = (1u << lane) - 1u;
    const int bits = 32 - __clz(mask);
    int32_t* c = cnt + w * 256;
    const int32_t per = ((m + kWarps - 1) / kWarps + 31) & ~31;
    const int32_t lo = w * per < m ? w * per : m;
    const int32_t hi = lo + per < m ? lo + per : m;
    __syncthreads();
    for (int i = lane; i < 256; i += 32) c[i] = 0;
    __syncwarp();
    for (int32_t b = lo; b < hi; b += 32 * kTiles) {
      uint32_t key[kTiles];
#pragma unroll
      for (int u = 0; u < kTiles; u++) {
        const int32_t i = b + 32 * u + lane;
        key[u] = i < hi ? ks[i] : 0u;
      }
#pragma unroll
      for (int u = 0; u < kTiles; u++) {
        const bool valid = b + 32 * u + lane < hi;
        const uint32_t d = valid ? (key[u] >> shift) & mask : mask + 1;
        const unsigned same = peers(d, bits);
        if (valid && (same & below) == 0) c[d] += __popc(same);
        __syncwarp();
      }
    }
    __syncthreads();
    int32_t tot = 0;
    if (threadIdx.x < 256)
      for (int k = 0; k < kWarps; k++) tot += cnt[k * 256 + threadIdx.x];
    int32_t all;
    int32_t run = exclusive_sum(threadIdx.x < 256 ? tot : 0, &all);
    if (threadIdx.x < 256)
      for (int k = 0; k < kWarps; k++) {
        const int32_t x = cnt[k * 256 + threadIdx.x];
        cnt[k * 256 + threadIdx.x] = run;
        run += x;
      }
    __syncthreads();
    for (int32_t b = lo; b < hi; b += 32 * kTiles) {
      uint32_t key[kTiles];
      int32_t val[kTiles];
#pragma unroll
      for (int u = 0; u < kTiles; u++) {
        const int32_t i = b + 32 * u + lane;
        key[u] = i < hi ? ks[i] : 0u;
        val[u] = vs != nullptr && i < hi ? vs[i] : 0;
      }
#pragma unroll
      for (int u = 0; u < kTiles; u++) {
        const bool valid = b + 32 * u + lane < hi;
        const uint32_t d = valid ? (key[u] >> shift) & mask : mask + 1;
        const unsigned same = peers(d, bits);
        if (valid) {
          const int32_t at = c[d] + __popc(same & below);
          kd[at] = key[u];
          if (vd != nullptr) vd[at] = val[u];
        }
        __syncwarp();
        if (valid && (same & below) == 0) c[d] += __popc(same);
        __syncwarp();
      }
    }
    __syncthreads();
#endif
  }
};
