// K6: batched LZ4 HC block compression on Hopper (sm_90a), levels 1..17.
//
// Replaces lz4_tpu/kernels/jax_hc.py::compress_hc_batch (:478-493), the
// pure-JAX phase machine (one lax.while_loop over lax.switch, vmapped over
// the blocks) that the JAX `pallas` tier runs on its device; not a Pallas
// kernel. Byte-identical to it and to the host HC (lz4_hc.cuh).
//
// Bound on the card: by bytes, each input byte read once and each output
// byte written once (3.35 TB/s). In practice a search waits on memory: a
// level-9 search on alphabet-4 data reads some 120 candidates (4^4 = 256
// distinct keys in a 64 KiB window), and the first design read them one
// dependent chain load at a time.
//
// Design (the second): one warp a block, one warp a CTA, a grid of at
// most the resident CTAs, each taking blocks by a grid-stride loop. A
// block's tables (a 15-bit head table of int32, 65,536 uint16 chain
// deltas, and the bucket index, 65,536 uint16 ranks and 16-byte records:
// 1.375 MiB) do not fit in shared memory beside more than one team, so
// each team keeps them in its slice of a global scratch tensor that the
// wrapper owns (teams x LZ4TT_HC_TEAM_BYTES); the index's 384 counters
// lie in shared memory. From level 4 on, a block of at most 64 KiB first
// sorts its positions by hash; each search then reads 32 candidates a
// step from that index and checks their links against the chain in one
// ballot, and inserts go 32 positions a step (lz4_hc.cuh). All 32 lanes
// run the phase machine on the same state.
#include "lz4_hc.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

// At most 64 registers, so that 32 teams fit an SM: 4,224 on the card,
// a round for the 4096 rows of the main path. kSpec: the levels whose
// walks speculate; the others run a kernel without the index's code.
template <bool kSpec>
__global__ void __launch_bounds__(32, 32)
    hc_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
              const int32_t* __restrict__ src_lens, uint8_t* __restrict__ dst,
              int64_t dst_stride, int32_t dest_cap, int32_t max_attempts,
              uint8_t* __restrict__ scratch, int32_t* __restrict__ out_lens,
              int32_t* __restrict__ err, int n) {
  __shared__ uint32_t counts[LZ4TT_HC_COUNTS];
  WarpTeam t;
  uint8_t* tables = scratch + (int64_t)blockIdx.x * LZ4TT_HC_TEAM_BYTES;
  for (int64_t b = blockIdx.x; b < n; b += gridDim.x) {
    int32_t len = 0;
    int32_t e = 0;
    lz4tt_hc_block_as<kSpec>(t, src + b * src_stride, src_lens[b],
                             dst + b * dst_stride, dest_cap, dst_stride,
                             max_attempts, tables, counts, &len, &e);
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
    const int32_t attempts = 1 << (level - 1);
    (lz4tt_hc_speculates(attempts) ? hc_kernel<true> : hc_kernel<false>)
        <<<grid, 32, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)src, src_stride, (const int32_t*)src_lens,
            (uint8_t*)dst, dst_stride, dest_cap, attempts, (uint8_t*)scratch,
            (int32_t*)out_lens, (int32_t*)err, n);
  }
  return (int)cudaGetLastError();
}

// Bytes of scratch a team needs.
extern "C" int lz4tt_hc_team_bytes() { return LZ4TT_HC_TEAM_BYTES; }

// Resident CTAs per SM (the fewer of the two kernels') and threads per CTA
// as launched.
extern "C" int lz4tt_hc_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32;
  int spec = 0, serial = 0;
  cudaError_t e =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&spec, hc_kernel<true>, 32, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&serial, hc_kernel<false>,
                                                      32, 0);
  *ctas_per_sm = spec < serial ? spec : serial;
  return (int)e;
}
