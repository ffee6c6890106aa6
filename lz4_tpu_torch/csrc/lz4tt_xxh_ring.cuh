// The shared-memory ring that K3 (xxh32.cu), K4 (xxh64.cu) and the two
// streaming updates share: one device function, lz4tt_xxh_ring, run by a
// CTA of five warps over up to LZ4TT_XXH_ROWS rows at once.
//
// XXH32 and XXH64 are four serial chains a row, one a lane, so a row runs
// at its chain's pace however many threads read it. The ring keeps the
// chains fed and each on a sub-partition of its own:
//
// - The producer (warp 4) streams the rows into a ring of LZ4TT_XXH_STAGES
//   stages in dynamic shared memory with bulk asynchronous copies
//   (cp.async.bulk, a 1-D TMA copy), one "full" and one "empty" mbarrier a
//   stage. Lane j of the producer copies row j's part of each stage.
// - Consumer k (warp k, k < 4, so on sub-partition k) carries lane k of
//   the rows: its thread j carries lane k of row j, in a register. It
//   waits for a stage, absorbs its stripes with the hash's stage body
//   (lz4tt_xxh32_stage_lane or lz4tt_xxh64_stage_lane), and hands the
//   stage back.
//
// A stage is LZ4TT_XXH_STAGE bytes, split among the CTA's rows: one row
// (few long rows, the streaming updates) has the whole stage; `rows` rows
// have lz4tt_xxh_seg(rows) bytes each, a multiple of 128, in slots 16
// bytes longer, so that the lanes' loads of one stripe spread over the
// banks. A launch picks `rows` from its number of rows (lz4tt_xxh_rows):
// one CTA a row while the rows fit on the card at once, then more rows a
// CTA, so that many rows' loads and chains share each SM.
//
// Rows start 16-byte aligned and a part of a row in a stage is a whole
// number of stripes, so every copy meets the bulk copy's 16-byte rules; a
// row with no stripe in a stage is not copied, and a CTA whose rows are all
// shorter than one stripe runs no stage.
#pragma once

#include "lz4tt_common.cuh"

// Bytes of one stage (all the CTA's rows together), stages in the ring, and
// the most rows a CTA hashes at once (one a thread of each warp).
#define LZ4TT_XXH_STAGE 32768
#define LZ4TT_XXH_STAGES 4
#define LZ4TT_XXH_ROWS 32

// Bytes of one row in a stage of a CTA of `rows` rows, and of its slot.
LZ4TT_HD int32_t lz4tt_xxh_seg(int rows) {
  return rows == 1 ? LZ4TT_XXH_STAGE : LZ4TT_XXH_STAGE / rows / 128 * 128;
}
LZ4TT_HD int32_t lz4tt_xxh_pitch(int rows) {
  return lz4tt_xxh_seg(rows) + (rows == 1 ? 0 : 16);
}

// Stripes in stage i of a row of n_stripes stripes, `per` stripes a stage
// (0 past the row's end).
LZ4TT_HD int32_t lz4tt_xxh_stage_stripes(int64_t n_stripes, int64_t i, int32_t per) {
  const int64_t left = n_stripes - i * per;
  return (int32_t)(left <= 0 ? 0 : left < per ? left : per);
}

// Rows a CTA takes in a launch of n rows when `slots` CTAs fit on the card
// at once: one a CTA while they all fit, then as many as spread them over
// the slots, at most LZ4TT_XXH_ROWS.
LZ4TT_HD int lz4tt_xxh_rows(int64_t n, int64_t slots) {
  const int64_t r = (n + slots - 1) / slots;
  return (int)(r < 1 ? 1 : r > LZ4TT_XXH_ROWS ? LZ4TT_XXH_ROWS : r);
}

#ifdef __CUDACC__

#include <cuda_runtime.h>

constexpr int kXxhConsumers = 4;  // one a lane, warps 0-3; the producer is warp 4
constexpr int kXxhThreads = 32 * (kXxhConsumers + 1);
constexpr int kXxhRingBytes = LZ4TT_XXH_STAGES * (LZ4TT_XXH_STAGE + 16 * LZ4TT_XXH_ROWS);

__device__ __forceinline__ uint32_t lz4tt_smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void lz4tt_mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(lz4tt_smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void lz4tt_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(lz4tt_smem_addr(bar))
               : "memory");
}

// One arrival that also expects `bytes` from bulk copies before the phase
// completes.
__device__ __forceinline__ void lz4tt_mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   lz4tt_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`.
__device__ __forceinline__ void lz4tt_mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(lz4tt_smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The bulk copy of `bytes` (a multiple of 16) from src to dst, both 16-byte
// aligned, which completes that many bytes of the barrier's phase.
__device__ __forceinline__ void lz4tt_bulk_copy(void* dst, const void* src, uint32_t bytes,
                                                uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(lz4tt_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(lz4tt_smem_addr(bar))
      : "memory");
}

// Run the ring over the CTA's `rows` rows; every thread of the CTA calls it.
// Thread j of each warp stands for row j: `src` is that row's start and
// n_stripes its whole stripes (0 for j >= rows). A consumer's thread j
// passes v, the lane accumulator of its warp's lane of row j, and gets it
// back with the row's stripes absorbed; the producer's v is returned as it
// came. H gives the lane type T, the stripe's bytes kStripe and the stage
// body stage(p, n, k, v).
template <class H>
__device__ __forceinline__ typename H::T lz4tt_xxh_ring(const uint8_t* src, int64_t n_stripes,
                                                        int rows, typename H::T v) {
  extern __shared__ __align__(128) uint8_t ring[];
  __shared__ uint64_t full[LZ4TT_XXH_STAGES], empty[LZ4TT_XXH_STAGES];
  const int warp = threadIdx.x / 32, j = threadIdx.x % 32;
  const int32_t seg = lz4tt_xxh_seg(rows), pitch = lz4tt_xxh_pitch(rows);
  const int32_t per = seg / H::kStripe;
  const int32_t stages =
      (int32_t)__reduce_max_sync(0xffffffffu, (unsigned)((n_stripes + per - 1) / per));
  if (threadIdx.x == 0) {
    for (int s = 0; s < LZ4TT_XXH_STAGES; s++) {
      lz4tt_mbar_init(&full[s], 1);
      lz4tt_mbar_init(&empty[s], kXxhConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kXxhConsumers) {  // the producer
    for (int32_t i = 0; i < stages; i++) {
      const int s = i % LZ4TT_XXH_STAGES;
      const uint32_t use = (uint32_t)(i / LZ4TT_XXH_STAGES);
      const uint32_t bytes = H::kStripe * lz4tt_xxh_stage_stripes(n_stripes, i, per);
      const uint32_t total = __reduce_add_sync(0xffffffffu, bytes);
      if (use > 0) lz4tt_mbar_wait(&empty[s], (use - 1) & 1);
      if (j == 0) lz4tt_mbar_expect(&full[s], total);
      __syncwarp();
      if (bytes)
        lz4tt_bulk_copy(ring + (s * rows + j) * pitch, src + (int64_t)i * seg, bytes,
                        &full[s]);
    }
  } else {  // consumer `warp`: lane `warp` of each row
    for (int32_t i = 0; i < stages; i++) {
      const int s = i % LZ4TT_XXH_STAGES;
      lz4tt_mbar_wait(&full[s], (uint32_t)(i / LZ4TT_XXH_STAGES) & 1);
      v = H::stage(ring + (s * rows + j) * pitch, lz4tt_xxh_stage_stripes(n_stripes, i, per),
                   warp, v);
      __syncwarp();
      if (j == 0) lz4tt_mbar_arrive(&empty[s]);
    }
  }
  return v;
}

// Allow `kernel` the ring's shared memory, and count the CTAs of it that
// fit on the card at once (`slots`). Returns the first CUDA error.
template <class K>
cudaError_t lz4tt_xxh_prepare(K kernel, int64_t* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       kXxhRingBytes);
  if (!e) e = cudaGetDevice(&dev);
  if (!e) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (!e)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kXxhThreads,
                                                      kXxhRingBytes);
  *slots = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  return e;
}

// Dynamic shared memory of a CTA of `rows` rows.
inline int lz4tt_xxh_smem(int rows) {
  return LZ4TT_XXH_STAGES * rows * lz4tt_xxh_pitch(rows);
}

#endif  // __CUDACC__
