// Frame-body packing on Hopper (sm_90a): every block's size word and
// payload at its offset in one contiguous LZ4 frame body.
//
// Not a TPU kernel. Replaces the pure-JAX
// lz4_tpu/dist/sharded.py::_frame_body_packed (:271-306), which
// materialises every output byte by a searchsorted over the block ends and
// gathers from the rows, inside the compress jit.
//
// Bound on the card: bytes: each payload byte read once and the body
// written once (about 187 MB on the main path's 4096 blocks). The offsets
// come from the wrapper's scan, so no block depends on another.
//
// Design: one warp per block, eight blocks per CTA; the warp writes the
// size word, then copies the payload with 16-byte aligned stores built
// from aligned source words with funnel shifts, four of them a lane in
// flight (frame_pack.cuh).
#include "frame_pack.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

constexpr int kWarpsPerCta = 8;

__global__ void __launch_bounds__(32 * kWarpsPerCta)
    pack_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
                const int32_t* __restrict__ lens, const uint8_t* __restrict__ comp,
                int64_t comp_stride, const int32_t* __restrict__ comp_lens,
                const int32_t* __restrict__ offs, uint8_t* __restrict__ body,
                int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= n) return;  // uniform across the warp
  WarpTeam t;
  lz4tt_pack_block(t, src + b * src_stride, lens[b], comp + b * comp_stride,
                   comp_lens[b], body + offs[b]);
}

}  // namespace

// src: uint8[n, src_stride] with lens: int32[n] within [0, src_stride];
// comp: uint8[n, comp_stride] with comp_lens: int32[n] within [0,
// comp_stride]; offs: int32[n], each block's offset in body (the exclusive
// scan of what each block emits: 0 for lens 0, else 4 + its payload).
// Returns cudaGetLastError() after the launch.
extern "C" int lz4tt_frame_pack(const void* src, long long src_stride,
                                const void* lens, const void* comp,
                                long long comp_stride, const void* comp_lens,
                                const void* offs, void* body, int n,
                                void* stream) {
  if (n > 0) {
    const int grid = (n + kWarpsPerCta - 1) / kWarpsPerCta;
    pack_kernel<<<grid, 32 * kWarpsPerCta, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)lens,
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_lens,
        (const int32_t*)offs, (uint8_t*)body, n);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the kernel as launched.
extern "C" int lz4tt_frame_pack_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32 * kWarpsPerCta;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, pack_kernel, 32 * kWarpsPerCta, 0);
}
