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
//
// lz4tt_xxh32_stream_update is the streaming hash's update on the card:
// the counterpart of lz4_tpu/kernels/xxhash_stream.py::stream32_update
// (:109, pure JAX, a lax.fori_loop over stripes). The lane state v1..v4
// stays in a u32[4] tensor on the card between updates; the host keeps
// the <16-byte remainder and the total length, and hands over whole
// stripes only.
//
// Bound on the card: not bytes. XXH32 is four serial chains, one a lane,
// of rounds v = rotl(v + x * P2, 13) * P1, so an update of n stripes takes
// at least n times one round's dependent latency, however many threads
// read the input. One thread that carries all four lanes does worse: its
// eight 32-bit multiplies a stripe go through one sub-partition's
// 16-lane multiply pipe, two cycles each, and it measured 21.6 cycles a
// stripe on this card (PERF.md). lz4tt_xxh32_chain runs the shipped rounds
// on register data, no loads, to measure the floor.
//
// Design: one CTA of five warps, one thread of each working. The producer
// (warp 4) streams the input into a ring of LZ4TT_XXH_STAGES stages of
// LZ4TT_XXH_STAGE bytes in dynamic shared memory with bulk asynchronous
// copies (cp.async.bulk, a 1-D TMA copy), one "full" and one "empty"
// mbarrier a stage. Consumer k (warp k, k < 4, so on sub-partition k)
// carries lane k in a register: it waits for a stage, absorbs its words
// with lz4tt_xxh32_stage_lane (xxh32.cuh: two dependent instructions a
// stripe, the next group's shared-memory loads issued before the current
// group's rounds), and hands the stage back. So no consumer waits for
// device memory, and each runs at its chain's pace. Stripes are 16 bytes
// and the input 16-byte aligned, so every stage, the last partial one
// included, meets the bulk copy's 16-byte rules.
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

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One arrival that also expects `bytes` from the bulk copy of `src` into
// `dst`, which completes the phase when they have landed.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

constexpr int kConsumers = 4;  // one a lane, warps 0-3; the producer is warp 4
constexpr int kStreamThreads = 32 * (kConsumers + 1);
constexpr int kRingBytes = LZ4TT_XXH_STAGES * LZ4TT_XXH_STAGE;

__global__ void __launch_bounds__(kStreamThreads, 1)
    xxh32_stream_kernel(const uint8_t* __restrict__ data, int64_t n_stripes,
                        uint32_t* __restrict__ state) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[LZ4TT_XXH_STAGES], empty[LZ4TT_XXH_STAGES];
  const int64_t stages = (n_stripes * 16 + LZ4TT_XXH_STAGE - 1) / LZ4TT_XXH_STAGE;
  if (threadIdx.x == 0) {
    for (int s = 0; s < LZ4TT_XXH_STAGES; s++) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 32 * kConsumers) {  // the producer
    for (int64_t i = 0; i < stages; i++) {
      const int s = (int)(i % LZ4TT_XXH_STAGES);
      const uint32_t use = (uint32_t)(i / LZ4TT_XXH_STAGES);
      if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
      bulk_load(ring + s * LZ4TT_XXH_STAGE, data + i * LZ4TT_XXH_STAGE,
                16u * lz4tt_xxh32_stage_stripes(n_stripes, i), &full[s]);
    }
  } else if (threadIdx.x % 32 == 0) {  // consumer k, lane k
    const int k = threadIdx.x / 32;
    uint32_t v = state[k];
    for (int64_t i = 0; i < stages; i++) {
      const int s = (int)(i % LZ4TT_XXH_STAGES);
      mbar_wait(&full[s], (uint32_t)(i / LZ4TT_XXH_STAGES) & 1);
      v = lz4tt_xxh32_stage_lane(ring + s * LZ4TT_XXH_STAGE,
                                 lz4tt_xxh32_stage_stripes(n_stripes, i), k, v);
      mbar_arrive(&empty[s]);
    }
    state[k] = v;
  }
}

cudaError_t prepare_stream() {
  static cudaError_t done = cudaFuncSetAttribute(
      xxh32_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  return done;
}

// The update's chains alone: the consumers' rounds on register data (lane
// k's word of stripe i is i + k), in the same groups, with no loads and no
// barriers.
__global__ void __launch_bounds__(32 * kConsumers)
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

// data: n_stripes * 16 bytes, 16-byte aligned; state: u32[4], the lane
// accumulators, updated in place. Returns cudaGetLastError().
extern "C" int lz4tt_xxh32_stream_update(const void* data, long long n_stripes,
                                         void* state, void* stream) {
  if (const cudaError_t e = prepare_stream()) return (int)e;
  if (n_stripes > 0)
    xxh32_stream_kernel<<<1, kStreamThreads, kRingBytes, (cudaStream_t)stream>>>(
        (const uint8_t*)data, n_stripes, (uint32_t*)state);
  return (int)cudaGetLastError();
}

// The chain bound of an update of n_stripes stripes: the rounds alone,
// from and into state (u32[4]). Returns cudaGetLastError().
extern "C" int lz4tt_xxh32_chain(long long n_stripes, void* state, void* stream) {
  if (n_stripes > 0)
    xxh32_chain_kernel<<<1, 32 * kConsumers, 0, (cudaStream_t)stream>>>(
        n_stripes, (uint32_t*)state);
  return (int)cudaGetLastError();
}
