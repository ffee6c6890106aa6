// K4: batched XXH64 over ragged blocks on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/xxhash64_pallas.py::xxh64_words_pallas
// (pallas_call at xxhash64_pallas.py:222; body _kernel :112-171; also
// xxh64_words_pallas_dynseed :183), which hashed 1024 equal-length blocks
// per (8, 128) tile from a word-major layout, carried the four accumulators
// across grid chunks, and emulated each u64 as a (hi, lo) pair of u32 with
// 16-bit limb multiplies, since the TPU has no 64-bit integers.
//
// Bound on the card: bytes. Each input byte is read once, over 3.35 TB/s of
// HBM; a 64-bit multiply per 8 bytes is far below the integer rate.
//
// Design: K3's shape with native uint64_t. One thread per block, any
// lengths, no tile layout. Rows start 16-byte aligned (the layout's row
// stride is a multiple of 16), so a 32-byte stripe is two aligned 16-byte
// loads, four stripes' loads issued before the rounds that use them. The
// hash is written as a u64 bit pattern (the wrapper's int64 tensor); the
// tier API splits it into (hi, lo).
#include "xxh64.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    xxh64_kernel(const uint8_t* __restrict__ data, int64_t stride,
                 const int32_t* __restrict__ lens, uint64_t seed,
                 uint64_t* __restrict__ out, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n) return;
  out[b] = lz4tt_xxh64(data + b * stride, lens[b], seed);
}

}  // namespace

// data: uint8[n, stride], 16-byte aligned, stride a multiple of 16;
// lens: int32[n] within [0, stride]; out: u64[n]. Returns cudaGetLastError().
extern "C" int lz4tt_xxh64_batch(const void* data, long long stride, const void* lens,
                                 unsigned long long seed, void* out, int n,
                                 void* stream) {
  if (n > 0) {
    const int grid = (n + kThreads - 1) / kThreads;
    xxh64_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, stride, (const int32_t*)lens, (uint64_t)seed,
        (uint64_t*)out, n);
  }
  return (int)cudaGetLastError();
}
