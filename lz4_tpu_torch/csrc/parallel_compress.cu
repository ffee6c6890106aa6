// K7: the parallel LZ4 compressor on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/parallel_compress.py::compress_parallel_batch
// (:323), the pure-JAX compressor (an argsort, word gathers, reverse
// cummins, a 512-step lax.scan and a searchsorted byte map, vmapped over
// the blocks); not a Pallas kernel. Byte for byte its output.
//
// Bound on the card: by bytes, each input byte read once and each output
// byte written once (3.35 TB/s). What it does instead is a stable sort of
// every position's word (four LSD passes, each reading and writing 16
// bytes a position), reverse scans and a serial walk of 512 steps a
// segment, all in the team's scratch: many times the bound.
//
// Design (the first): one CTA of 512 threads a block, a grid of at most the
// resident CTAs, each taking blocks by a grid-stride loop. The body
// (parallel_compress.cuh) runs the JAX module's phases with the CTA as a
// team (lz4tt_cta_team.cuh): block-wide scans, the sort's stable ranks by
// match_any and per-warp digit counts in shared memory. Each team keeps its
// block's tables in its slice of a scratch tensor the wrapper owns, 16
// bytes a position of the widest row, so the scratch grows with the CTAs
// in flight, not with the batch.
#include "parallel_compress.cuh"

#include <cuda_runtime.h>

#include "lz4tt_cta_team.cuh"
#include "lz4tt_device.cuh"

namespace {

constexpr int kThreads = 512;
using Team = CtaTeam<kThreads>;

// At most 64 registers, so that two CTAs fit an SM.
__global__ void __launch_bounds__(kThreads, 2)
    pc_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
              const int32_t* __restrict__ src_lens, uint8_t* __restrict__ dst,
              int64_t dst_stride, int32_t cap, int32_t* __restrict__ scratch,
              int64_t words, int32_t* __restrict__ out_lens, int n) {
  __shared__ Team::Shared team;
  __shared__ int32_t hist[4 * LZ4TT_PC_RADIX];
  __shared__ int32_t queue;
  const Team t{&team};
  int32_t* mine = scratch + (int64_t)blockIdx.x * words;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    const int32_t len =
        lz4tt_pc_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,
                       cap, mine, words / 4, hist, &queue);
    if (threadIdx.x == 0) out_lens[b] = len;
  }
}

}  // namespace

// src: uint8[n, src_stride], src_lens: int32[n] within [0, width] where
// words >= lz4tt_parallel_team_words(width); dst: uint8[n, dst_stride],
// dst_stride >= cap, zeroed by the caller (bytes past a row's output are
// not written); scratch: teams x words int32; the grid is min(n, teams)
// CTAs. out_lens is -1 on a row whose output exceeds cap. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue without
// scratch).
extern "C" int lz4tt_compress_parallel(const void* src, long long src_stride,
                                       const void* src_lens, void* dst,
                                       long long dst_stride, int cap,
                                       void* scratch, long long words,
                                       int teams, void* out_lens, int n,
                                       void* stream) {
  if (n > 0 && (teams < 1 || words < lz4tt_pc_team_words(0)))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = n < teams ? n : teams;
    pc_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)src_lens,
        (uint8_t*)dst, dst_stride, cap, (int32_t*)scratch, words,
        (int32_t*)out_lens, n);
  }
  return (int)cudaGetLastError();
}

// int32 words of scratch a team needs for rows of up to `width` bytes.
extern "C" long long lz4tt_parallel_team_words(long long width) {
  return lz4tt_pc_team_words(width);
}

// Resident CTAs per SM and threads per CTA as launched.
extern "C" int lz4tt_parallel_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm,
                                                            pc_kernel,
                                                            kThreads, 0);
}
