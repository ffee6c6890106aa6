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
//
// lz4tt_xxh64_stream_update is the streaming hash's update on the card:
// the counterpart of lz4_tpu/kernels/xxhash_stream.py::stream64_update
// (:136, pure JAX on (hi, lo) u32 pairs). The lane state v1..v4 stays in a
// u64[4] tensor on the card between updates; the host keeps the <32-byte
// remainder and the total length, and hands over whole stripes only. One
// thread absorbs them from the carried state with the stripe loop of the
// one-shot hash; the bound is the latency of the lanes' serial chains.
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

namespace {

__global__ void __launch_bounds__(1)
    xxh64_stream_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                        uint64_t* __restrict__ state) {
  uint64_t v[4] = {state[0], state[1], state[2], state[3]};
  lz4tt_xxh64_stripes(data, n_stripes, v);
  for (int k = 0; k < 4; k++) state[k] = v[k];
}

}  // namespace

// data: n_stripes * 32 bytes, 16-byte aligned; state: u64[4], the lane
// accumulators, updated in place. Returns cudaGetLastError().
extern "C" int lz4tt_xxh64_stream_update(const void* data, long long n_stripes,
                                         void* state, void* stream) {
  if (n_stripes > 0)
    xxh64_stream_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n_stripes, (uint64_t*)state);
  return (int)cudaGetLastError();
}
