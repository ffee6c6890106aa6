// K8: the gather decode on Hopper (sm_90a): LZ4 blocks decoded from the
// parser's sequence tables by pointer doubling.
//
// Replaces lz4_tpu/kernels/gather_decode.py::gather_decompress_batch
// (:168), the pure-JAX decode (searchsorted over the tables, a parent a
// byte, pointer-doubling rounds in a lax.while_loop, vmapped over the
// blocks); not a Pallas kernel. Byte for byte its output, max_depth
// included.
//
// Bound on the card: by bytes, each literal byte and each sequence's table
// entries (and the first sentinel's) read once and each output byte
// written once (3.35 TB/s). What it does instead is 8-byte nodes a byte,
// written once and then read, gathered and written again in each doubling
// round, in the team's scratch.
//
// Design (the first): one CTA of 512 threads a block, a grid of at most the
// resident CTAs looping over the blocks; each sequence writes its bytes'
// nodes (a thread a sequence, long ones by the CTA), then synchronous
// rounds between two buffers of nodes in the team's slice of a scratch
// tensor the wrapper owns, until no byte is unresolved or max_depth rounds
// have run (gather_decode.cuh).
#include "gather_decode.cuh"

#include <cuda_runtime.h>

#include "lz4tt_cta_team.cuh"
#include "lz4tt_device.cuh"

namespace {

constexpr int kThreads = 512;
using Team = CtaTeam<kThreads>;

__global__ void __launch_bounds__(kThreads, 2)
    gd_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
              int32_t cmax, Lz4ttGdTables tables, int32_t max_seq,
              uint8_t* __restrict__ out, int64_t out_stride,
              int32_t out_len, int32_t max_depth, Lz4ttGdNode* scratch,
              int64_t team_nodes, int n) {
  __shared__ Team::Shared team;
  __shared__ int32_t queue;
  const Team t{&team};
  Lz4ttGdNode* a = scratch + (int64_t)blockIdx.x * team_nodes;
  Lz4ttGdNode* b = a + out_len;
  int32_t* longs = reinterpret_cast<int32_t*>(b + out_len);
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const int64_t o = r * max_seq;
    const Lz4ttGdTables s = {tables.lit_out + o, tables.lit_src + o,
                             tables.lit_len + o, tables.m_out + o,
                             tables.m_dist + o, tables.m_len + o};
    lz4tt_gd_block(t, comp + r * comp_stride, cmax, s, max_seq,
                   out + r * out_stride, out_len, max_depth, a, b, longs,
                   &queue);
  }
}

}  // namespace

// Nodes of scratch a team needs: two buffers of out_len nodes, then
// max_seq int32 (rounded up to whole nodes).
extern "C" long long lz4tt_gather_team_nodes(int out_len, int max_seq) {
  return 2LL * out_len + (max_seq + 1) / 2;
}

// comp: uint8[n, comp_stride], cmax <= comp_stride bytes a row read;
// lit_out, lit_src, lit_len, m_out, m_dist, m_len: int32[n, max_seq]
// each; out: uint8[n, out_stride], out_stride >= out_len, every byte of
// [0, out_len) written; scratch: teams x lz4tt_gather_team_nodes nodes,
// 8-byte aligned; the grid is min(n, teams) CTAs. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for cmax < 1
// or no scratch).
extern "C" int lz4tt_gather_decode(const void* comp, long long comp_stride,
                                   int cmax, const void* lit_out,
                                   const void* lit_src, const void* lit_len,
                                   const void* m_out, const void* m_dist,
                                   const void* m_len, int max_seq,
                                   void* out, long long out_stride, int out_len,
                                   int max_depth, void* scratch, int teams,
                                   int n, void* stream) {
  if (n > 0 && out_len > 0 && (teams < 1 || cmax < 1 || max_seq < 1))
    return (int)cudaErrorInvalidValue;
  if (n > 0 && out_len > 0) {
    const int grid = n < teams ? n : teams;
    gd_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, cmax,
        Lz4ttGdTables{(const int32_t*)lit_out, (const int32_t*)lit_src,
                      (const int32_t*)lit_len, (const int32_t*)m_out,
                      (const int32_t*)m_dist, (const int32_t*)m_len},
        max_seq, (uint8_t*)out, out_stride, out_len, max_depth,
        (Lz4ttGdNode*)scratch, lz4tt_gather_team_nodes(out_len, max_seq), n);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA as launched.
extern "C" int lz4tt_gather_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm,
                                                            gd_kernel,
                                                            kThreads, 0);
}
