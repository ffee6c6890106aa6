// The LZ4 sequence parser on Hopper (sm_90a): the tables K5 decodes from.
//
// Not a TPU kernel. Replaces the host parser the JAX package runs before
// its segment decode: lz4_tpu/native/src/tpulz4.cpp::
// tpulz4_parse_sequences_batch (:1683-1805) with tail mode 1, called from
// lz4_tpu/kernels/gather_decode.py::parse_packed (:50-103). The tables are
// six int32 entries a sequence, about 8x the compressed bytes; built on the
// card from the compressed bytes, which K5 needs there anyway, they never
// cross PCIe.
//
// Bound on the card: bytes: each compressed byte read once and every
// table entry written once, the zeros past each row's sequences included
// (the tables are almost all of it). A block's token walk is a serial
// chain, so one block's sequences set the time of a small launch.
//
// Design: one warp per block, four blocks per CTA, at most 64 registers,
// so that 8 CTAs an SM (all 4096 blocks of the main path) are resident, as
// in K5. The warp reads its block from a 2 KiB window in shared memory,
// which it fills with 16-byte loads. It takes 32 three-byte sequences a
// step, one a lane, and where they stop a chain of the short sequences
// that start in the next 32 bytes, and writes each table's entries of a
// step with one coalesced store; lane 0 walks any other sequence alone
// (lz4_parse.cuh). The warp then writes its row's zero tails with 16-byte
// stores, so the wrapper allocates the tables without zeroing them.
#include "lz4_parse.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

constexpr int kWarpsPerCta = 4;
// enough for every block of a 4096-block batch to be resident (132 SMs)
constexpr int kCtasPerSm = 8;

__global__ void __launch_bounds__(32 * kWarpsPerCta, kCtasPerSm)
    parse_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                 const int32_t* __restrict__ comp_lens, int32_t max_seq,
                 int32_t* tables, int32_t* __restrict__ n_seq,
                 int32_t* __restrict__ out_total, int32_t n, int32_t tail) {
  __shared__ __align__(16) uint8_t wins[kWarpsPerCta][LZ4TT_PARSE_WIN];
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerCta + warp;
  if (b >= n) return;  // uniform across the warp
  WarpTeam t;
  int32_t total;
  const int32_t ns = lz4tt_parse_block(t, comp + b * comp_stride, comp_lens[b],
                                       max_seq, lz4tt_seq_row(tables, n, max_seq, b),
                                       wins[warp], &total);
  if (tail != 0)
    lz4tt_parse_sentinel(t, lz4tt_seq_row(tables, n, max_seq, b), ns, max_seq,
                         tail);
  if (t.leader()) {
    n_seq[b] = ns;
    out_total[b] = total;
  }
}

}  // namespace

// comp: uint8[n, comp_stride], comp_lens: int32[n] within [0, comp_stride];
// tables: int32[6, n, max_seq] (lit_out, lit_src, lit_len, m_out, m_dist,
// m_len), every entry written; n_seq: int32[n], the sequence count or a
// negative code; out_total: int32[n], the decoded length of each OK block,
// else 0. tail: 0, or the value of lit_out and m_out past the sequences of
// an OK row (lz4tt_parse_sentinel). Returns cudaGetLastError() after the
// launch.
extern "C" int lz4tt_parse_sequences(const void* comp, long long comp_stride,
                                     const void* comp_lens, int max_seq,
                                     void* tables, void* n_seq, void* out_total,
                                     int n, int tail, void* stream) {
  if (n > 0) {
    const int grid = (n + kWarpsPerCta - 1) / kWarpsPerCta;
    parse_kernel<<<grid, 32 * kWarpsPerCta, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_lens, max_seq,
        (int32_t*)tables, (int32_t*)n_seq, (int32_t*)out_total, n, tail);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the kernel as launched.
extern "C" int lz4tt_parse_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32 * kWarpsPerCta;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, parse_kernel, 32 * kWarpsPerCta, 0);
}
