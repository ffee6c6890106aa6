// A CTA as a block team (csrc/parallel_compress.cuh): the collectives of
// K7 and K8 over the kThreads threads of one CTA, from warp shuffles and a
// little shared memory (Shared, which the kernel provides). Every
// collective starts with a barrier, so that it never overwrites what the
// one before is still reading. Only the card runs it: the members are
// __host__ __device__ for the bodies' templates, and empty on the host
// side; the host builds of the bodies run Lz4ttBlockSerial or a team of
// host threads instead.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define LZ4TT_CTA __host__ __device__ __forceinline__

template <int kThreads>
struct CtaTeam {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  static constexpr int kWarps = kThreads / 32;
  struct Shared {
    int32_t warp[32];
    int32_t cnt[kWarps * 256];
  };
  Shared* sh;

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

  // Inclusive scan of v over the CTA, a sum or (kMin) a min; *total is
  // the sum or min over all threads.
  template <bool kMin>
  LZ4TT_CTA static int32_t op(int32_t a, int32_t b) {
    return kMin ? (a < b ? a : b) : a + b;
  }
  template <bool kMin>
  LZ4TT_CTA int32_t scan(int32_t v, int32_t* total) const {
#ifdef __CUDA_ARCH__
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v = op<kMin>(v, u);
    }
    __syncthreads();
    if (lane == 31) sh->warp[w] = v;
    __syncthreads();
    if (w == 0) {
      int32_t x = sh->warp[lane < kWarps ? lane : kWarps - 1];
      for (int o = 1; o < 32; o <<= 1) {
        const int32_t u = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o && lane < kWarps) x = op<kMin>(x, u);
      }
      if (lane < kWarps) sh->warp[lane] = x;
    }
    __syncthreads();
    *total = sh->warp[kWarps - 1];
    return w > 0 ? op<kMin>(sh->warp[w - 1], v) : v;
#else
    *total = v;
    return v;
#endif
  }

  LZ4TT_CTA int32_t exclusive_sum(int32_t v, int32_t* total) const {
    return scan<false>(v, total) - v;
  }

  LZ4TT_CTA int32_t inclusive_min(int32_t v, int32_t* total) const {
    return scan<true>(v, total);
  }

  // Stable rank by an 8-bit digit: the lanes of a warp with the same digit
  // find each other (match_any); each warp's count of a digit goes to
  // shared memory, and one thread a digit turns the counts into offsets
  // from base[d] in warp order, then advances base[d].
  LZ4TT_CTA int32_t digit_rank(uint32_t d, bool valid, int32_t* base) const {
#ifdef __CUDA_ARCH__
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    const unsigned peers = __match_any_sync(0xffffffffu, valid ? d : 256u);
    const int32_t before = __popc(peers & ((1u << lane) - 1u));
    __syncthreads();
    for (int c = threadIdx.x; c < kWarps * 256; c += kThreads) sh->cnt[c] = 0;
    __syncthreads();
    if (valid && before == 0) sh->cnt[w * 256 + d] = __popc(peers);
    __syncthreads();
    for (int c = threadIdx.x; c < 256; c += kThreads) {
      int32_t run = base[c];
      for (int k = 0; k < kWarps; k++) {
        const int32_t x = sh->cnt[k * 256 + c];
        sh->cnt[k * 256 + c] = run;
        run += x;
      }
      base[c] = run;
    }
    __syncthreads();
    return valid ? sh->cnt[w * 256 + d] + before : 0;
#else
    return valid ? base[d]++ : 0;
#endif
  }
};
