// K3: batched XXH32 over ragged blocks on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/xxhash_pallas.py::xxh32_words_pallas (pallas_call
// at xxhash_pallas.py:156; body _kernel :53-100; also
// xxh32_words_pallas_dynseed :113 and xxh32_uniform_pallas :188), which
// hashed 1024 equal-length blocks per (8, 128) tile from a word-major
// layout and carried the four accumulators across grid chunks.
//
// Bound on the card: bytes. Each input byte is read once, over 3.35 TB/s of
// HBM; the rounds are a few integer operations per 4 bytes.
//
// Design: one thread per block, any lengths, no tile layout. Rows start
// 16-byte aligned (the layout's row stride is a multiple of 16), so stripes
// are aligned 16-byte loads, eight of them issued before the rounds that
// use them. The frame content checksum is this kernel with n = 1.
#include "xxh32.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    xxh32_kernel(const uint8_t* __restrict__ data, int64_t stride,
                 const int32_t* __restrict__ lens, uint32_t seed,
                 uint32_t* __restrict__ out, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n) return;
  out[b] = lz4tt_xxh32(data + b * stride, lens[b], seed);
}

}  // namespace

// data: uint8[n, stride], 16-byte aligned, stride a multiple of 16;
// lens: int32[n] within [0, stride]. Returns cudaGetLastError().
extern "C" int lz4tt_xxh32_batch(const void* data, long long stride, const void* lens,
                                 unsigned seed, void* out, int n, void* stream) {
  if (n > 0) {
    const int grid = (n + kThreads - 1) / kThreads;
    xxh32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, stride, (const int32_t*)lens, seed, (uint32_t*)out, n);
  }
  return (int)cudaGetLastError();
}
