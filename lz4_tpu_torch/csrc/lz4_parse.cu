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
// Bound on the card: bytes, in principle: each compressed byte read once,
// the tables written once (the wrapper zeroes them first, so the tails past
// n_seq are zeros). In practice the token walk of a block is one serial
// chain of dependent byte loads, so the kernel is bound by that chain's
// latency times the sequences of the longest block.
//
// Design: one thread per block, 32 blocks to a CTA; the thread walks its
// block's tokens (lz4_parse.cuh), where consecutive bytes of its block hit
// the L1 line its last load brought in, and writes its entries. Nothing is shared between threads.
#include "lz4_parse.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 32;

__global__ void __launch_bounds__(kThreads)
    parse_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                 const int32_t* __restrict__ comp_lens, int32_t max_seq,
                 int32_t* tables, int32_t* __restrict__ n_seq,
                 int32_t* __restrict__ out_total, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (b >= n) return;
  const int64_t field = (int64_t)n * max_seq;
  int32_t* r = tables + b * max_seq;
  const Lz4ttSeqRow row = {r, r + field, r + 2 * field,
                           r + 3 * field, r + 4 * field, r + 5 * field};
  int32_t written = 0;
  n_seq[b] = lz4tt_parse_block(comp + b * comp_stride, comp_lens[b], max_seq,
                               row, &written, &out_total[b]);
}

}  // namespace

// comp: uint8[n, comp_stride], comp_lens: int32[n] within [0, comp_stride];
// tables: int32[6, n, max_seq] (lit_out, lit_src, lit_len, m_out, m_dist,
// m_len), zeroed by the caller; n_seq: int32[n], the sequence count or a
// negative code; out_total: int32[n], zeroed by the caller, the decoded
// length of each OK block. Returns cudaGetLastError().
extern "C" int lz4tt_parse_sequences(const void* comp, long long comp_stride,
                                     const void* comp_lens, int max_seq,
                                     void* tables, void* n_seq, void* out_total,
                                     int n, void* stream) {
  if (n > 0) {
    const int grid = (n + kThreads - 1) / kThreads;
    parse_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_lens, max_seq,
        (int32_t*)tables, (int32_t*)n_seq, (int32_t*)out_total, n);
  }
  return (int)cudaGetLastError();
}
