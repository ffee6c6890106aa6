// K5: batched LZ4 decode from sequence tables on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/segment_decode.py::decompress_segments_pallas
// (pallas_call at segment_decode.py:215; body _segment_kernel :96-153),
// which kept one block's output resident in VMEM (bytes one per int32)
// while chunks of 1024 sequences streamed through SMEM, and copied each
// sequence's literal run and match with 128-lane windows, one sequence
// after the other.
//
// Bound on the card: bytes. The work is to read the literal bytes and the
// 24 bytes of table a sequence once and to write each output byte once,
// over 3.35 TB/s of HBM. Matches depend on earlier output, so they run in
// order within a block; the kernel lives on block parallelism.
//
// Design: one CTA of eight warps per block. The CTA zeroes the row, checks
// every sequence against the row (lz4tt_segment_ok; the JAX kernel trusts
// its tables, this one does not), then each warp takes every eighth
// literal run, whose destination is absolute, and copies it with its 32
// lanes. After a barrier, warp 0 runs the matches in sequence order with
// K1's overlap copy (lz4tt_copy_match in lz4_decode.cuh). Shared-memory
// staging of the row, and matches in parallel across independent chains,
// are left for later.
#include "segment_decode.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;

// The whole CTA as a team, for the zeroing (only the device side runs).
struct CtaTeam {
  LZ4TT_HD int lane() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  LZ4TT_HD int size() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
};

__global__ void __launch_bounds__(32 * kWarps)
    segment_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                   const int32_t* __restrict__ comp_lens,
                   const int32_t* __restrict__ n_seq,
                   const int32_t* __restrict__ tables, int32_t max_seq,
                   uint8_t* out, int64_t out_stride, int32_t out_max,
                   int32_t* __restrict__ err, int32_t n) {
  const int64_t b = blockIdx.x;
  uint8_t* row = out + b * out_stride;
  const uint8_t* src = comp + b * comp_stride;
  const int32_t comp_len = comp_lens[b];
  const int32_t ns = n_seq[b];
  const Lz4ttSeqTables s = lz4tt_seq_tables(tables, n, max_seq, b);

  lz4tt_segment_zero(CtaTeam(), row, out_max);
  bool bad = ns < 0 || ns > max_seq;
  for (int32_t k = threadIdx.x; !bad && k < ns; k += blockDim.x)
    bad = !lz4tt_segment_ok(s, k, comp_len, out_max);
  // also orders the zeroing before the copies
  if (__syncthreads_or(bad)) {
    if (threadIdx.x == 0) err[b] = LZ4TT_ERR_MALFORMED;
    return;
  }
  WarpTeam t;
  for (int32_t k = threadIdx.x >> 5; k < ns; k += kWarps)
    lz4tt_segment_literal(t, src, row, s, k);
  __syncthreads();
  if (threadIdx.x < 32) lz4tt_segment_matches(t, row, s, ns);
  if (threadIdx.x == 0) err[b] = LZ4TT_OK;
}

}  // namespace

// comp: uint8[n, comp_stride], comp_lens: int32[n] within [0, comp_stride];
// n_seq: int32[n]; tables: int32[6, n, max_seq] (lit_out, lit_src, lit_len,
// m_out, m_dist, m_len); out: uint8[n, out_stride] with out_stride >=
// out_max; writes stay below out_max in every row. Returns
// cudaGetLastError() after the launch.
extern "C" int lz4tt_decompress_segments(const void* comp, long long comp_stride,
                                         const void* comp_lens, const void* n_seq,
                                         const void* tables, int max_seq, void* out,
                                         long long out_stride, int out_max, void* err,
                                         int n, void* stream) {
  if (n > 0)
    segment_kernel<<<n, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_lens,
        (const int32_t*)n_seq, (const int32_t*)tables, max_seq, (uint8_t*)out,
        out_stride, out_max, (int32_t*)err, n);
  return (int)cudaGetLastError();
}
