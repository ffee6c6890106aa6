// K2: batched LZ4 fast-scan block compression on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/lz4_pallas.py::compress_fast_pallas (pallas_call
// at lz4_pallas.py:676; body _compress_kernel :398-619), which kept the hash
// table in VMEM as (rows, 128) and compared 128-byte windows. Unlike it,
// the table variant is chosen per block from the block's own length
// (jax_codec.py:579-588 and the reference), not from the row capacity.
//
// Bound on the card: bytes (each input byte read once, each output byte
// written once, over 3.35 TB/s of HBM). In practice the scan is serial per
// block: skip acceleration makes each probe depend on the last, and each
// sequence on the table entry the one before it wrote. On the main path's
// alphabet-4 blocks (about 15,100 sequences of 4.3 bytes) it is one lane's
// chain of about a hundred dependent instructions a sequence (byte loads,
// hash, table, compare, bookkeeping), so what bounds the kernel is that
// chain's latency times the blocks that do not fit on the card at once:
// 2048 such blocks over 13 x 132 slots run in two rounds.
//
// Design: one CTA of one warp per block, with the block's 16 KiB hash table
// in dynamic shared memory (uint16_t entries below LZ4_64K_LIMIT, int32_t
// from it on), which lets 13 CTAs share an SM where the former 32 KiB
// table let 6; the carve-out asks for the most shared memory. Lane 0 runs
// the scan alone and the other lanes wait at one shuffle, joining only for
// literal runs above 16 bytes and matches that run past 32 bytes; a match
// is extended 4 bytes a step by XOR and __ffs, and a run of matches with
// no literals between them stays in one loop. Measured on the card
// (PERF.md): staging the row in shared memory (80 KiB a CTA, 2 CTAs an SM)
// was 3x slower, and words joined by a funnel shift were 2 % slower than
// four byte loads through L1.
#include "lz4_compress.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

__global__ void __launch_bounds__(32)
    compress_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
                    const int32_t* __restrict__ src_lens, uint8_t* __restrict__ dst,
                    int64_t dst_stride, int32_t dest_cap,
                    int32_t* __restrict__ out_lens, int32_t* __restrict__ err) {
  extern __shared__ uint4 table[];
  const int64_t b = blockIdx.x;
  WarpTeam t;
  int32_t len = 0;
  int32_t e = 0;
  lz4tt_compress_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,
                       dest_cap, dst_stride, table, &len, &e);
  if (t.leader()) {
    out_lens[b] = len;
    err[b] = e;
  }
}

cudaError_t prepare() {
  int dev;
  return lz4tt_once_a_device([](int) {
    return cudaFuncSetAttribute(compress_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }, &dev);
}

}  // namespace

// src: uint8[n, src_stride], src_lens: int32[n] within [0, src_stride];
// dst: uint8[n, dst_stride] with dst_stride >= dest_cap. Returns
// cudaGetLastError() after the launch.
extern "C" int lz4tt_compress_fast(const void* src, long long src_stride,
                                   const void* src_lens, void* dst,
                                   long long dst_stride, int dest_cap,
                                   void* out_lens, void* err, int n,
                                   void* stream) {
  if (const cudaError_t e = prepare()) return (int)e;
  if (n > 0) {
    compress_kernel<<<n, 32, LZ4TT_TABLE_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)src_lens, (uint8_t*)dst,
        dst_stride, dest_cap, (int32_t*)out_lens, (int32_t*)err);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the kernel as launched.
extern "C" int lz4tt_compress_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32;
  if (const cudaError_t e = prepare()) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, compress_kernel, 32, LZ4TT_TABLE_BYTES);
}
