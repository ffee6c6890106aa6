// K1: batched LZ4 block decode on Hopper (sm_90a), with two entry points.
//
// lz4tt_decompress_safe replaces lz4_tpu/kernels/lz4_pallas.py::
// decompress_safe_pallas (pallas_call at lz4_pallas.py:309; body
// _decompress_kernel :99-266), which decoded one block per grid step with
// 128-lane aligned windows, rotate/select unaligned loads and log-doubled
// period vectors for overlapping matches. lz4tt_decompress_fast is the same
// kernel in the fast contract (exact decoded length, bytes read reported),
// the counterpart of the pure-JAX jax_codec.py::decompress_fast_batch
// (:255-270), which has no Pallas kernel of its own.
//
// Bound on the card: bytes. The work is to read each compressed byte once
// and write each decoded byte once, over 3.35 TB/s of HBM. The token walk
// of a block is serial, so the kernel lives on block parallelism.
//
// Design: one warp per block, four blocks per CTA. Every lane walks the
// same tokens (the length bytes are one broadcast load); literal runs and
// matches are copied by the 32 lanes, one byte each per step. An
// overlapping match (distance below its length) is copied as
// byte j = period[j mod dist], so every lane reads only bytes that exist
// before the match starts: no serial replication and no hazard inside a
// copy. A __syncwarp before each match orders it after the writes it reads.
#include "lz4_decode.cuh"

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerCta = 4;

// Safe: lens[b] is the exact compressed length and out_max the capacity;
// writes the decoded length. Fast: lens[b] is the bytes available and
// out_max the exact decoded length; writes the bytes read.
template <bool kFast>
__global__ void __launch_bounds__(32 * kWarpsPerCta)
    decode_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                  const int32_t* __restrict__ lens, uint8_t* out,
                  int64_t out_stride, int32_t out_max,
                  int32_t* __restrict__ out_lens, int32_t* __restrict__ err,
                  int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerCta + (threadIdx.x >> 5);
  if (b >= n) return;  // uniform across the warp
  WarpTeam t;
  int32_t len = 0;
  int32_t read = 0;
  int32_t e = 0;
  lz4tt_decode_block<kFast>(t, comp + b * comp_stride, lens[b],
                            out + b * out_stride, out_max, &len, &read, &e);
  if (t.leader()) {
    out_lens[b] = kFast ? read : len;
    err[b] = e;
  }
}

template <bool kFast>
int launch(const void* comp, long long comp_stride, const void* lens, void* out,
           long long out_stride, int out_max, void* out_lens, void* err, int n,
           void* stream) {
  if (n > 0) {
    const int grid = (n + kWarpsPerCta - 1) / kWarpsPerCta;
    decode_kernel<kFast><<<grid, 32 * kWarpsPerCta, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)lens, (uint8_t*)out,
        out_stride, out_max, (int32_t*)out_lens, (int32_t*)err, n);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// comp: uint8[n, comp_stride], comp_lens: int32[n] within [0, comp_stride];
// out: uint8[n, out_stride] with out_stride >= out_max; writes stay below
// out_max in every row. Returns cudaGetLastError() after the launch.
extern "C" int lz4tt_decompress_safe(const void* comp, long long comp_stride,
                                     const void* comp_lens, void* out,
                                     long long out_stride, int out_max,
                                     void* out_lens, void* err, int n,
                                     void* stream) {
  return launch<false>(comp, comp_stride, comp_lens, out, out_stride, out_max,
                       out_lens, err, n, stream);
}

// comp: uint8[n, comp_stride] with comp_stride >= 1, comp_avail: int32[n]
// within [0, comp_stride]; out: uint8[n, out_stride] with out_stride >=
// dest_len; writes stay below dest_len in every row, and src_read[b] is the
// bytes of row b consumed. Returns cudaGetLastError() after the launch.
extern "C" int lz4tt_decompress_fast(const void* comp, long long comp_stride,
                                     const void* comp_avail, void* out,
                                     long long out_stride, int dest_len,
                                     void* src_read, void* err, int n,
                                     void* stream) {
  return launch<true>(comp, comp_stride, comp_avail, out, out_stride, dest_len,
                      src_read, err, n, stream);
}
