// K4: batched XXH64 over ragged rows on Hopper (sm_90a), and the streaming
// hash's update.
//
// Replaces lz4_tpu/kernels/xxhash64_pallas.py::xxh64_words_pallas
// (pallas_call at xxhash64_pallas.py:222; body _kernel :112-171; also
// xxh64_words_pallas_dynseed :183), which hashed 1024 equal-length blocks
// per (8, 128) tile from a word-major layout, carried the four accumulators
// across grid chunks, and emulated each u64 as a (hi, lo) pair of u32 with
// 16-bit limb multiplies, since the TPU has no 64-bit integers.
//
// lz4tt_xxh64_stream_update is the streaming hash's update on the card:
// the counterpart of lz4_tpu/kernels/xxhash_stream.py::stream64_update
// (:136, pure JAX on (hi, lo) u32 pairs). The lane state v1..v4 stays in a
// u64[4] tensor on the card between updates; the host keeps the <32-byte
// remainder and the total length, and hands over whole stripes only.
//
// Bound on the card: as K3's (xxh32.cu), a row's chain or bytes. A 32-byte
// stripe is one round a lane, rotl(v + x * Q2, 31) * Q1 in 64 bits: a
// long row is bound by that chain, many rows by the bytes over 3.35 TB/s.
// lz4tt_xxh64_chain runs the shipped rounds on register data, no loads.
//
// Design: K3's, with 64-bit lanes: both entry points run the ring of
// lz4tt_xxh_ring.cuh (a producer warp's bulk copies into a shared-memory
// ring, one consumer warp a lane; lz4tt_xxh64_stage_lane in xxh64.cuh,
// the rounds carried as w = rotl(w, 31) * Q1 + x' * Q2). K4 then finishes
// each row on thread j of warp 0 (lz4tt_xxh64_finish) and writes the hash
// as a u64 bit pattern (the wrapper's int64 tensor; the tier API splits it
// into (hi, lo)); the update writes the lanes back.
#include "xxh64.cuh"

#include <cuda_runtime.h>

namespace {

struct Xxh64Lanes {
  typedef uint64_t T;
  enum { kStripe = 32 };
  static __device__ __forceinline__ T stage(const uint8_t* p, int32_t n, int k, T v) {
    return lz4tt_xxh64_stage_lane(p, n, k, v);
  }
};

__global__ void __launch_bounds__(kXxhThreads, 1)
    xxh64_kernel(const uint8_t* __restrict__ data, int64_t stride,
                 const int32_t* __restrict__ lens, uint64_t seed,
                 uint64_t* __restrict__ out, int32_t n, int rows) {
  __shared__ uint64_t lanes[LZ4TT_XXH_ROWS][4];
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const int64_t b = (int64_t)blockIdx.x * rows + j;
  const bool mine = j < rows && b < n;
  const uint8_t* row = data + (mine ? b : 0) * stride;
  const int32_t len = mine ? lens[b] : 0;
  const uint64_t v = lz4tt_xxh_ring<Xxh64Lanes>(
      row, len / 32, rows, lz4tt_xxh64_lane_init(seed, warp));
  if (warp < kXxhConsumers && mine) lanes[j][warp] = v;
  __syncthreads();
  if (warp == 0 && mine) out[b] = lz4tt_xxh64_finish(lanes[j], row, len, seed);
}

__global__ void __launch_bounds__(kXxhThreads, 1)
    xxh64_stream_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                        uint64_t* __restrict__ state) {
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const bool lane = warp < kXxhConsumers && j == 0;
  const uint64_t v = lz4tt_xxh_ring<Xxh64Lanes>(data, j == 0 ? n_stripes : 0, 1,
                                                lane ? state[warp] : 0ull);
  if (lane) state[warp] = v;
}

// The kernels' shared memory allowed once; the CTAs of K4 the card holds.
cudaError_t prepare(int64_t* slots) {
  static int64_t n_slots = 0;
  static const cudaError_t done = [] {
    cudaError_t e = lz4tt_xxh_prepare(xxh64_kernel, &n_slots);
    int64_t unused;
    if (!e) e = lz4tt_xxh_prepare(xxh64_stream_kernel, &unused);
    return e;
  }();
  *slots = n_slots;
  return done;
}

// The update's chains alone: the consumers' rounds in their carried form
// on register data (lane k's word of stripe i is i + k), in the same
// groups, with no loads and no barriers.
__global__ void __launch_bounds__(32 * kXxhConsumers)
    xxh64_chain_kernel(int64_t n_stripes, uint64_t* __restrict__ state) {
  if (threadIdx.x % 32) return;
  const int k = threadIdx.x / 32;
  uint64_t x = (uint64_t)k;
  uint64_t w = state[k] + x * LZ4TT_Q2;
  int64_t i = 1;
  for (; i + LZ4TT_XXH64_GROUP <= n_stripes; i += LZ4TT_XXH64_GROUP) {
#pragma unroll
    for (int j = 1; j <= LZ4TT_XXH64_GROUP; j++)
      w = lz4tt_xxh64_step(w, (x + j) * LZ4TT_Q2);
    x += LZ4TT_XXH64_GROUP;
  }
  for (; i < n_stripes; i++) w = lz4tt_xxh64_step(w, ++x * LZ4TT_Q2);
  state[k] = lz4tt_rotl64(w, 31) * LZ4TT_Q1;
}

}  // namespace

// data: uint8[n, stride], 16-byte aligned, stride a multiple of 16;
// lens: int32[n] within [0, stride]; out: u64[n]. Returns cudaGetLastError().
extern "C" int lz4tt_xxh64_batch(const void* data, long long stride, const void* lens,
                                 unsigned long long seed, void* out, int n,
                                 void* stream) {
  int64_t slots;
  if (const cudaError_t e = prepare(&slots)) return (int)e;
  if (n > 0) {
    const int rows = lz4tt_xxh_rows(n, slots);
    xxh64_kernel<<<(n + rows - 1) / rows, kXxhThreads, lz4tt_xxh_smem(rows),
                   (cudaStream_t)stream>>>((const uint8_t*)data, stride, (const int32_t*)lens,
                                           (uint64_t)seed, (uint64_t*)out, n, rows);
  }
  return (int)cudaGetLastError();
}

// Rows a CTA of K4 takes in a launch of n rows.
extern "C" int lz4tt_xxh64_rows(int n, int* rows) {
  int64_t slots;
  const cudaError_t e = prepare(&slots);
  *rows = lz4tt_xxh_rows(n, slots);
  return (int)e;
}

extern "C" int lz4tt_xxh64_occupancy(int* ctas_per_sm, int* threads) {
  int64_t slots;
  if (const cudaError_t e = prepare(&slots)) return (int)e;
  *threads = kXxhThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, xxh64_kernel,
                                                            kXxhThreads, kXxhRingBytes);
}

// data: n_stripes * 32 bytes, 16-byte aligned; state: u64[4], the lane
// accumulators, updated in place. Returns cudaGetLastError().
extern "C" int lz4tt_xxh64_stream_update(const void* data, long long n_stripes,
                                         void* state, void* stream) {
  int64_t slots;
  if (const cudaError_t e = prepare(&slots)) return (int)e;
  if (n_stripes > 0)
    xxh64_stream_kernel<<<1, kXxhThreads, lz4tt_xxh_smem(1), (cudaStream_t)stream>>>(
        (const uint8_t*)data, n_stripes, (uint64_t*)state);
  return (int)cudaGetLastError();
}

// The chain bound of an update of n_stripes stripes: the rounds alone, one
// warp a lane, from and into state (u64[4]). Returns cudaGetLastError().
extern "C" int lz4tt_xxh64_chain(long long n_stripes, void* state, void* stream) {
  if (n_stripes > 0)
    xxh64_chain_kernel<<<1, 32 * kXxhConsumers, 0, (cudaStream_t)stream>>>(
        n_stripes, (uint64_t*)state);
  return (int)cudaGetLastError();
}
