// K3: batched XXH32 over ragged rows on Hopper (sm_90a), and the streaming
// hash's update.
//
// Replaces lz4_tpu/kernels/xxhash_pallas.py::xxh32_words_pallas (pallas_call
// at xxhash_pallas.py:156; body _kernel :53-100; also
// xxh32_words_pallas_dynseed :113 and xxh32_uniform_pallas :188), which
// hashed 1024 equal-length blocks per (8, 128) tile from a word-major
// layout and carried the four accumulators across grid chunks.
//
// lz4tt_xxh32_stream_update is the streaming hash's update on the card:
// the counterpart of lz4_tpu/kernels/xxhash_stream.py::stream32_update
// (:109, pure JAX, a lax.fori_loop over stripes). The lane state v1..v4
// stays in a u32[4] tensor on the card between updates; the host keeps
// the <16-byte remainder and the total length, and hands over whole
// stripes only.
//
// Bound on the card: a row's chain, or bytes. XXH32 is four serial chains
// a row, one a lane, of rounds v = rotl(v + x * P2, 13) * P1, so a row of
// n stripes takes at least n times one round's dependent latency, however
// many threads read it: a long row (the frame's content checksum is K3
// with n = 1, a streaming update one row) is chain-bound. Many rows run
// their chains side by side and are bound by the bytes, each read once
// over 3.35 TB/s of HBM. lz4tt_xxh32_chain runs the shipped rounds on
// register data, no loads, to measure the chain.
//
// Design: both entry points run the ring of lz4tt_xxh_ring.cuh, one device
// function: a producer warp's bulk copies into a shared-memory ring, one
// consumer warp a lane, each lane in a register (lz4tt_xxh32_stage_lane in
// xxh32.cuh: a funnel shift and one multiply-add a stripe). K3 runs it
// over blockIdx's rows, lz4tt_xxh_rows(n) of them (one a CTA while every
// row fits on the card at once), then hands the lanes through shared
// memory to thread j of warp 0, which finishes row j (lz4tt_xxh32_finish:
// the merge, the length, the tail read from device memory, the
// avalanche). The update runs it over its one row from the carried lanes,
// and writes them back.
#include "xxh32.cuh"

#include <cuda_runtime.h>

namespace {

struct Xxh32Lanes {
  typedef uint32_t T;
  enum { kStripe = 16 };
  static __device__ __forceinline__ T stage(const uint8_t* p, int32_t n, int k, T v) {
    return lz4tt_xxh32_stage_lane(p, n, k, v);
  }
};

__global__ void __launch_bounds__(kXxhThreads, 1)
    xxh32_kernel(const uint8_t* __restrict__ data, int64_t stride,
                 const int32_t* __restrict__ lens, uint32_t seed,
                 uint32_t* __restrict__ out, int32_t n, int rows) {
  __shared__ uint32_t lanes[LZ4TT_XXH_ROWS][4];
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const int64_t b = (int64_t)blockIdx.x * rows + j;
  const bool mine = j < rows && b < n;
  const uint8_t* row = data + (mine ? b : 0) * stride;
  const int32_t len = mine ? lens[b] : 0;
  const uint32_t v = lz4tt_xxh_ring<Xxh32Lanes>(
      row, len / 16, rows, lz4tt_xxh32_lane_init(seed, warp));
  if (warp < kXxhConsumers && mine) lanes[j][warp] = v;
  __syncthreads();
  if (warp == 0 && mine) out[b] = lz4tt_xxh32_finish(lanes[j], row, len, seed);
}

__global__ void __launch_bounds__(kXxhThreads, 1)
    xxh32_stream_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                        uint32_t* __restrict__ state) {
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const bool lane = warp < kXxhConsumers && j == 0;
  const uint32_t v = lz4tt_xxh_ring<Xxh32Lanes>(data, j == 0 ? n_stripes : 0, 1,
                                                lane ? state[warp] : 0u);
  if (lane) state[warp] = v;
}

// The kernels' shared memory allowed once; the CTAs of K3 the card holds.
cudaError_t prepare(int64_t* slots) {
  static int64_t n_slots = 0;
  static const cudaError_t done = [] {
    cudaError_t e = lz4tt_xxh_prepare(xxh32_kernel, &n_slots);
    int64_t unused;
    if (!e) e = lz4tt_xxh_prepare(xxh32_stream_kernel, &unused);
    return e;
  }();
  *slots = n_slots;
  return done;
}

// The update's chains alone: the consumers' rounds on register data (lane
// k's word of stripe i is i + k), in the same groups, with no loads and no
// barriers.
__global__ void __launch_bounds__(32 * kXxhConsumers)
    xxh32_chain_kernel(int64_t n_stripes, uint32_t* __restrict__ state) {
  if (threadIdx.x % 32) return;
  const int k = threadIdx.x / 32;
  uint32_t x = (uint32_t)k;
  uint32_t w = state[k] + x * LZ4TT_P2;
  int64_t i = 1;
  for (; i + LZ4TT_XXH_GROUP <= n_stripes; i += LZ4TT_XXH_GROUP) {
#pragma unroll
    for (int j = 1; j <= LZ4TT_XXH_GROUP; j++)
      w = lz4tt_xxh32_step(w, (x + j) * LZ4TT_P2);
    x += LZ4TT_XXH_GROUP;
  }
  for (; i < n_stripes; i++) w = lz4tt_xxh32_step(w, ++x * LZ4TT_P2);
  state[k] = lz4tt_rotl32(w, 13) * LZ4TT_P1;
}

}  // namespace

// data: uint8[n, stride], 16-byte aligned, stride a multiple of 16;
// lens: int32[n] within [0, stride]. Returns cudaGetLastError().
extern "C" int lz4tt_xxh32_batch(const void* data, long long stride, const void* lens,
                                 unsigned seed, void* out, int n, void* stream) {
  int64_t slots;
  if (const cudaError_t e = prepare(&slots)) return (int)e;
  if (n > 0) {
    const int rows = lz4tt_xxh_rows(n, slots);
    xxh32_kernel<<<(n + rows - 1) / rows, kXxhThreads, lz4tt_xxh_smem(rows),
                   (cudaStream_t)stream>>>((const uint8_t*)data, stride, (const int32_t*)lens,
                                           seed, (uint32_t*)out, n, rows);
  }
  return (int)cudaGetLastError();
}

// Rows a CTA of K3 takes in a launch of n rows, and the CTAs an SM holds.
extern "C" int lz4tt_xxh32_rows(int n, int* rows) {
  int64_t slots;
  const cudaError_t e = prepare(&slots);
  *rows = lz4tt_xxh_rows(n, slots);
  return (int)e;
}

extern "C" int lz4tt_xxh32_occupancy(int* ctas_per_sm, int* threads) {
  int64_t slots;
  if (const cudaError_t e = prepare(&slots)) return (int)e;
  *threads = kXxhThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, xxh32_kernel,
                                                            kXxhThreads, kXxhRingBytes);
}

// data: n_stripes * 16 bytes, 16-byte aligned; state: u32[4], the lane
// accumulators, updated in place. Returns cudaGetLastError().
extern "C" int lz4tt_xxh32_stream_update(const void* data, long long n_stripes,
                                         void* state, void* stream) {
  int64_t slots;
  if (const cudaError_t e = prepare(&slots)) return (int)e;
  if (n_stripes > 0)
    xxh32_stream_kernel<<<1, kXxhThreads, lz4tt_xxh_smem(1), (cudaStream_t)stream>>>(
        (const uint8_t*)data, n_stripes, (uint32_t*)state);
  return (int)cudaGetLastError();
}

// The chain bound of an update of n_stripes stripes: the rounds alone,
// from and into state (u32[4]). Returns cudaGetLastError().
extern "C" int lz4tt_xxh32_chain(long long n_stripes, void* state, void* stream) {
  if (n_stripes > 0)
    xxh32_chain_kernel<<<1, 32 * kXxhConsumers, 0, (cudaStream_t)stream>>>(
        n_stripes, (uint32_t*)state);
  return (int)cudaGetLastError();
}
