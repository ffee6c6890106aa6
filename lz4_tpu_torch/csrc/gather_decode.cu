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
// written once (3.35 TB/s). What it does besides: a 4-byte node a byte,
// written once by the fill, read once to list the open ones, then only the
// open nodes read and gathered in each round, in the team's scratch.
//
// Design (the second; the first kept 8-byte nodes in two buffers and read,
// gathered and rewrote every node of a row each round): one CTA of 512
// threads a block, a grid of at most the resident CTAs looping over the
// blocks. Each sequence writes its bytes' nodes, and its literal bytes to
// the output (a thread a sequence, long ones by the CTA); then rounds over
// a list of the open nodes, in place when 2^max_depth >= out_len (at most
// ceil(log2(out_len)) + 1), synchronous below that, until none is open;
// a node that resolves writes its byte. No host read-back between rounds
// (gather_decode.cuh).
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
              int32_t out_len, int32_t max_depth, int32_t* scratch,
              int64_t team_words, int n) {
  __shared__ Team::Shared team;
  __shared__ int32_t counters[4];
  const Team t{&team, nullptr};
  int32_t* mine = scratch + (int64_t)blockIdx.x * team_words;
  for (int64_t r = blockIdx.x; r < n; r += gridDim.x) {
    const int64_t o = r * max_seq;
    const Lz4ttGdTables s = {tables.lit_out + o, tables.lit_src + o,
                             tables.lit_len + o, tables.m_out + o,
                             tables.m_dist + o, tables.m_len + o};
    lz4tt_gd_block(t, comp + r * comp_stride, cmax, s, max_seq,
                   out + r * out_stride, out_len, max_depth, mine, counters);
  }
}

}  // namespace

// Int32 words of scratch a team needs (lz4tt_gd_team_words).
extern "C" long long lz4tt_gather_team_words(int out_len, int max_seq) {
  return lz4tt_gd_team_words(out_len, max_seq);
}

// comp: uint8[n, comp_stride], cmax <= comp_stride bytes a row read;
// lit_out, lit_src, lit_len, m_out, m_dist, m_len: int32[n, max_seq]
// each; out: uint8[n, out_stride], out_stride >= out_len, every byte of
// [0, out_len) written; scratch: teams x lz4tt_gather_team_words int32;
// the grid is min(n, teams) CTAs. Returns
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
        (int32_t*)scratch, lz4tt_gd_team_words(out_len, max_seq), n);
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
