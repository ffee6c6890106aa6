// K5: batched LZ4 decode from sequence tables on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/segment_decode.py::decompress_segments_pallas
// (pallas_call at segment_decode.py:215; body _segment_kernel :96-153),
// which kept one block's output resident in VMEM (bytes one per int32)
// while chunks of 1024 sequences streamed through SMEM, and copied each
// sequence's literal run and match with 128-lane windows, one sequence
// after the other.
//
// Bound on the card: bytes, in principle. The work is to read the literal
// bytes and the 24 bytes of table a sequence once and to write each output
// byte once, over 3.35 TB/s of HBM. In practice it is the instructions a
// sequence: the main path's alphabet-4 blocks hold about 15,100 sequences
// of 4.3 bytes each, and every one is a copy that reads earlier output.
//
// Design: one warp per block, four blocks per CTA and at most 64
// registers, so that 8 CTAs an SM (all 4096 blocks of the main path) are
// resident, each warp with K1's 4 KiB ring of its latest output and queue
// of 32 copies in shared memory (segment_decode.cuh, lz4_decode.cuh). The
// tables need no serial walk: lane i loads sequence k0 + i's six words
// (coalesced, the next window's loads in flight while this one decodes),
// the 32 lanes check their sequences at once, and a warp scan places each
// lane's short pieces in the queue, which the lanes run one a lane in
// dependency waves into the ring, written out with 16-byte stores. Long
// pieces go to the whole warp. Gaps that no sequence writes are queued as
// zero copies and the tail is zeroed once, so the row is written exactly
// once and never zeroed first.
#include "segment_decode.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

constexpr int kWarpsPerCta = 4;
// enough for every block of a 4096-block batch to be resident (132 SMs)
constexpr int kCtasPerSm = 8;

__global__ void __launch_bounds__(32 * kWarpsPerCta, kCtasPerSm)
    segment_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                   const int32_t* __restrict__ comp_lens,
                   const int32_t* __restrict__ n_seq,
                   const int32_t* __restrict__ tables, int32_t max_seq,
                   uint8_t* out, int64_t out_stride, int32_t out_max,
                   int32_t* __restrict__ err, int32_t n) {
  __shared__ __align__(16) uint8_t rings[kWarpsPerCta][LZ4TT_RING];
  __shared__ Lz4ttCopies queues[kWarpsPerCta];
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerCta + warp;
  if (b >= n) return;  // uniform across the warp
  WarpTeam t;
  const int32_t e = lz4tt_segment_block(
      t, comp + b * comp_stride, comp_lens[b], lz4tt_seq_tables(tables, n, max_seq, b),
      n_seq[b], max_seq, out + b * out_stride, out_max, rings[warp], queues[warp]);
  if (t.leader()) err[b] = e;
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
  if (n > 0) {
    const int grid = (n + kWarpsPerCta - 1) / kWarpsPerCta;
    segment_kernel<<<grid, 32 * kWarpsPerCta, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_lens,
        (const int32_t*)n_seq, (const int32_t*)tables, max_seq, (uint8_t*)out,
        out_stride, out_max, (int32_t*)err, n);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the kernel as launched.
extern "C" int lz4tt_segment_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32 * kWarpsPerCta;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, segment_kernel, 32 * kWarpsPerCta, 0);
}
