// K2: batched LZ4 fast-scan block compression on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/lz4_pallas.py::compress_fast_pallas (pallas_call
// at lz4_pallas.py:676; body _compress_kernel :398-619), which kept the hash
// table in VMEM as (rows, 128) and compared 128-byte windows. Unlike it,
// the table variant is chosen per block from the block's own length
// (jax_codec.py:579-588 and the reference), not from the row capacity.
//
// Bound on the card: bytes. Each input byte is read once and each output
// byte written once, over 3.35 TB/s of HBM. In practice the scan is serial
// per block (skip acceleration makes each probe depend on the last), so the
// kernel is latency-bound and lives on block parallelism.
//
// Design: one CTA of one warp per block. The hash table sits in shared
// memory as int32 entries (32 KB for the 13-bit table, the first 16 KB of
// it for the 12-bit one) and is zeroed per block. The whole warp walks the
// scan in lockstep; only lane 0 reads and writes the table and broadcasts
// the old entry. Literal runs are copied by the 32 lanes, and matches are
// extended 32 bytes per step by one compare per lane and a __ballot_sync.
#include "lz4_compress.cuh"

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(32)
    compress_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
                    const int32_t* __restrict__ src_lens, uint8_t* __restrict__ dst,
                    int64_t dst_stride, int32_t dest_cap,
                    int32_t* __restrict__ out_lens, int32_t* __restrict__ err) {
  __shared__ int32_t table[1 << LZ4TT_HASH_LOG_64K];
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

}  // namespace

// src: uint8[n, src_stride], src_lens: int32[n] within [0, src_stride];
// dst: uint8[n, dst_stride] with dst_stride >= dest_cap. Returns
// cudaGetLastError() after the launch.
extern "C" int lz4tt_compress_fast(const void* src, long long src_stride,
                                   const void* src_lens, void* dst,
                                   long long dst_stride, int dest_cap,
                                   void* out_lens, void* err, int n,
                                   void* stream) {
  if (n > 0) {
    compress_kernel<<<n, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)src_lens, (uint8_t*)dst,
        dst_stride, dest_cap, (int32_t*)out_lens, (int32_t*)err);
  }
  return (int)cudaGetLastError();
}
