// K6: batched LZ4 HC block compression on Hopper (sm_90a), levels 1..17.
//
// Replaces lz4_tpu/kernels/jax_hc.py::compress_hc_batch (:478-493), the
// pure-JAX phase machine (one lax.while_loop over lax.switch, vmapped over
// the blocks) that the JAX `pallas` tier runs on its device; not a Pallas
// kernel. Byte-identical to it and to the host HC (lz4_hc.cuh).
//
// Bound on the card: by bytes, each input byte read once and each output
// byte written once (3.35 TB/s). In practice the match finder is a serial
// chain of dependent loads a block: each probe of a hash chain reads the
// chain slot that names the next probe, and a level-9 search on
// alphabet-4 data walks some 256 probes (4^4 = 256 distinct keys in a 64
// KiB window). So a batch takes about as long as its slowest block's
// chain, and what bounds the kernel is that chain's latency times the
// blocks that do not fit on the card at once.
//
// Design (the first, simple one): one warp a block, one warp a CTA, a
// grid of at most the resident CTAs, each taking blocks by a grid-stride
// loop. A block's tables (a 15-bit head table of int32 and 65,536 uint16
// chain deltas, 256 KiB) do not fit in shared memory beside more than
// one team, so each team keeps them in its slice of a global scratch
// tensor that the wrapper owns (teams x LZ4TT_HC_TEAM_BYTES), where they
// stay in L2 as far as they fit. The head table is reset for each block;
// the chain is not. All 32 lanes run the phase machine on the same state
// (lz4_hc.cuh); they split only compares, copies and the reset.
#include "lz4_hc.cuh"

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(32)
    hc_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
              const int32_t* __restrict__ src_lens, uint8_t* __restrict__ dst,
              int64_t dst_stride, int32_t dest_cap, int32_t max_attempts,
              uint8_t* __restrict__ scratch, int32_t* __restrict__ out_lens,
              int32_t* __restrict__ err, int n) {
  WarpTeam t;
  uint8_t* tables = scratch + (int64_t)blockIdx.x * LZ4TT_HC_TEAM_BYTES;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    int32_t len = 0;
    int32_t e = 0;
    lz4tt_hc_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,
                   dest_cap, dst_stride, max_attempts, tables, &len, &e);
    if (t.leader()) {
      out_lens[b] = len;
      err[b] = e;
    }
  }
}

}  // namespace

// src: uint8[n, src_stride], src_lens: int32[n] within [0, src_stride];
// dst: uint8[n, dst_stride] with dst_stride >= dest_cap; scratch: teams x
// LZ4TT_HC_TEAM_BYTES bytes, 16-byte aligned; the grid is min(n, teams)
// CTAs. out_lens is 0 and err ERR_DEST_TOO_SMALL on a row that does not
// fit dest_cap. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a level outside 1..17 or no scratch).
extern "C" int lz4tt_compress_hc(const void* src, long long src_stride,
                                 const void* src_lens, void* dst,
                                 long long dst_stride, int dest_cap, int level,
                                 void* scratch, int teams, void* out_lens,
                                 void* err, int n, void* stream) {
  if (level < 1 || level > 17 || (n > 0 && teams < 1))
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int grid = n < teams ? n : teams;
    hc_kernel<<<grid, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)src_lens,
        (uint8_t*)dst, dst_stride, dest_cap, 1 << (level - 1),
        (uint8_t*)scratch, (int32_t*)out_lens, (int32_t*)err, n);
  }
  return (int)cudaGetLastError();
}

// Bytes of scratch a team needs.
extern "C" int lz4tt_hc_team_bytes() { return LZ4TT_HC_TEAM_BYTES; }

// Resident CTAs per SM and threads per CTA of the kernel as launched.
extern "C" int lz4tt_hc_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm,
                                                             hc_kernel, 32, 0);
}
