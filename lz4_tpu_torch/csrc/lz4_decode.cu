// K1: batched LZ4 block decode on Hopper (sm_90a), with three entry points.
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
// Bound on the card: bytes (each compressed byte read once, each decoded
// byte written once, over 3.35 TB/s of HBM). In practice the token walk of
// a block is serial: on the main path's alphabet-4 blocks a sequence is 3
// compressed bytes for 4.3 decoded ones, and one lane's chain of
// dependent instructions a sequence bounds the kernel, with every block
// resident at once.
//
// Design: one warp per block, four blocks per CTA, at most 64 registers so
// that 8 CTAs (all 4096 blocks of the main path) are resident, each warp
// with a 4 KiB ring of its latest output and a queue of 32 copies in
// shared memory (lz4_decode.cuh). Lane 0 walks the tokens alone and only
// checks and queues: a literal run or match of up to 64 bytes becomes one
// queued copy, and four tokens with no literals and a short match are read
// at once, since such sequences are 3 bytes each. The 32 lanes then run
// the queued copies one a lane, in waves that respect the order in which
// they read each other's output, into the ring (a match within 3 KiB reads
// shared memory, not bytes just stored to the row); they write the ring out
// with 16-byte stores once 2 KiB wait, and copy longer runs and matches
// together. Writes are exactly the decoded bytes: nothing is written past
// a run and later overwritten.
//
// lz4tt_decompress_safe_smem is the safe decode of lz4tt_decompress_safe
// for a batch that leaves the card room, a CTA a row, whose dynamic shared
// memory (about 65.6 KiB, three CTAs an SM) holds the row's whole output
// (out_max <= 65,536) and four slots of queued copies. Every match reads
// shared memory, however far back (a match past the ring's 3 KiB waits for
// the row in device memory in the warp-a-row kernel), and the row is
// written once, at the end, with 16-byte stores. Its two warps split the
// row (lz4tt_split_row): warp 0's lane 0 walks the tokens and fills the
// slots, warp 1 runs each slot's copies behind it, so the walk, the
// serial part, never waits for a copy; named barriers 1-8 order the slots.
// The wrapper takes it for batches of at most its resident CTAs
// (lz4tt_decode_smem_occupancy) and the warp-a-row kernel for the rest.
//
// lz4tt_decompress_safe_hist is the safe decode with a history window a
// row, the device counterpart of the native tpulz4_decompress_safe_ext
// (lz4_tpu/native/src/tpulz4.cpp:1060-1202), which the JAX package runs on
// the host for linked-block and dictionary frames: row b's history is the
// hist_lens[b] bytes that end at hist + b * hist_stride. A stride of 0
// gives every row one history (a dictionary, stored once); a linked block
// passes its own row as the end of the history, so the frame's earlier
// output stays where it was decoded.
#include "lz4_decode.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

constexpr int kWarpsPerCta = 4;
// enough for every block of a 4096-block batch to be resident (132 SMs)
constexpr int kCtasPerSm = 8;

// Safe: lens[b] is the exact compressed length and out_max the capacity;
// writes the decoded length. Fast: lens[b] is the bytes available and
// out_max the exact decoded length; writes the bytes read. A lens[b]
// outside [0, comp_stride] is row b's MALFORMED (lz4tt_decode_row): the
// wrappers do not read the lengths back.
template <bool kFast, bool kHist>
__global__ void __launch_bounds__(32 * kWarpsPerCta, kCtasPerSm)
    decode_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                  const int32_t* __restrict__ lens, uint8_t* out,
                  int64_t out_stride, int32_t out_max,
                  int32_t* __restrict__ out_lens, int32_t* __restrict__ err,
                  int32_t n, const uint8_t* hist, int64_t hist_stride,
                  const int32_t* __restrict__ hist_lens) {
  __shared__ __align__(16) uint8_t rings[kWarpsPerCta][LZ4TT_RING];
  __shared__ Lz4ttCopies queues[kWarpsPerCta];
  const int warp = threadIdx.x >> 5;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerCta + warp;
  if (b >= n) return;  // uniform across the warp
  WarpTeam t;
  int32_t len = 0;
  int32_t read = 0;
  int32_t e = 0;
  Lz4ttHist h = {nullptr, 0};
  if (kHist) h = {hist + b * hist_stride, hist_lens[b]};
  lz4tt_decode_row<kFast, kHist>(t, comp + b * comp_stride, comp_stride,
                                 lens[b], out + b * out_stride, out_max,
                                 rings[warp], queues[warp], &len, &read, &e,
                                 h);
  if (t.leader()) {
    out_lens[b] = kFast ? read : len;
    err[b] = e;
  }
}

// The CTA-a-row kernel's dynamic shared memory: the row's whole output,
// then the slots.
using SmemRing = Lz4ttWhole;
constexpr int kSmemThreads = 64;
constexpr int kSmemBytes =
    SmemRing::kBytes + (int)((sizeof(Lz4ttSlot) * LZ4TT_SLOTS + 15) & ~(size_t)15);

// The walker's and the copier's signals: slot s is full at named barrier
// 1 + s, empty at 1 + LZ4TT_SLOTS + s, each met by both warps.
// (__host__ __device__ for the body's templates; only the card runs it.)
struct NamedPipe {
  static LZ4TT_HD void sync(int id) {
#ifdef __CUDA_ARCH__
    asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
#endif
  }
  static LZ4TT_HD void arrive(int id) {
#ifdef __CUDA_ARCH__
    asm volatile("bar.arrive %0, 64;" ::"r"(id) : "memory");
#endif
  }
  LZ4TT_HD void wait_empty(const WarpTeam&, int s) const { sync(1 + LZ4TT_SLOTS + s); }
  LZ4TT_HD void fill(const WarpTeam&, int s) const { arrive(1 + s); }
  LZ4TT_HD void wait_full(const WarpTeam&, int s) const { sync(1 + s); }
  LZ4TT_HD void empty(const WarpTeam&, int s) const { arrive(1 + LZ4TT_SLOTS + s); }
};

__global__ void __launch_bounds__(kSmemThreads)
    decode_smem_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                       const int32_t* __restrict__ lens, uint8_t* out,
                       int64_t out_stride, int32_t out_max,
                       int32_t* __restrict__ out_lens,
                       int32_t* __restrict__ err) {
  extern __shared__ __align__(16) uint8_t smem[];
  Lz4ttSlot* slots = reinterpret_cast<Lz4ttSlot*>(smem + SmemRing::kBytes);
  const int64_t b = blockIdx.x;
  const bool walker = threadIdx.x < 32;  // uniform across a warp
  WarpTeam t;
  int32_t len = 0;
  int32_t e = 0;
  lz4tt_split_row(t, walker, NamedPipe(), comp + b * comp_stride,
                  comp_stride, lens[b], out + b * out_stride, out_max, smem,
                  slots, &len, &e);
  if (!walker && t.leader()) {
    out_lens[b] = len;
    err[b] = e;
  }
}

// The CTA-a-row kernel's shared memory allowed once a card.
cudaError_t prepare_smem() {
  int dev;
  return lz4tt_once_a_device([](int) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e) return e;
    return cudaFuncSetAttribute(decode_smem_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }, &dev);
}

template <bool kFast, bool kHist>
int launch(const void* comp, long long comp_stride, const void* lens, void* out,
           long long out_stride, int out_max, void* out_lens, void* err, int n,
           void* stream, const void* hist = nullptr, long long hist_stride = 0,
           const void* hist_lens = nullptr) {
  if (n > 0) {
    const int grid = (n + kWarpsPerCta - 1) / kWarpsPerCta;
    decode_kernel<kFast, kHist>
        <<<grid, 32 * kWarpsPerCta, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)comp, comp_stride, (const int32_t*)lens,
            (uint8_t*)out, out_stride, out_max, (int32_t*)out_lens,
            (int32_t*)err, n, (const uint8_t*)hist, hist_stride,
            (const int32_t*)hist_lens);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// comp: uint8[n, comp_stride], comp_lens: int32[n] (a length outside
// [0, comp_stride] is that row's MALFORMED, out length 0, nothing read or
// written); out: uint8[n, out_stride] with out_stride >= out_max; writes
// stay below out_max in every row. Returns cudaGetLastError() after the
// launch.
extern "C" int lz4tt_decompress_safe(const void* comp, long long comp_stride,
                                     const void* comp_lens, void* out,
                                     long long out_stride, int out_max,
                                     void* out_lens, void* err, int n,
                                     void* stream) {
  return launch<false, false>(comp, comp_stride, comp_lens, out, out_stride,
                              out_max, out_lens, err, n, stream);
}

// comp: uint8[n, comp_stride] with comp_stride >= 1, comp_avail: int32[n]
// (a count outside [0, comp_stride] is that row's MALFORMED, src_read 0,
// nothing read or written); out: uint8[n, out_stride] with out_stride >=
// dest_len; writes stay below dest_len in every row, and src_read[b] is the
// bytes of row b consumed. Returns cudaGetLastError() after the launch.
extern "C" int lz4tt_decompress_fast(const void* comp, long long comp_stride,
                                     const void* comp_avail, void* out,
                                     long long out_stride, int dest_len,
                                     void* src_read, void* err, int n,
                                     void* stream) {
  return launch<true, false>(comp, comp_stride, comp_avail, out, out_stride,
                             dest_len, src_read, err, n, stream);
}

// lz4tt_decompress_safe's contract and arguments, a CTA a row, for
// out_max <= 65,536 (else cudaErrorInvalidValue, nothing launched). Any n
// is decoded; more rows than the card holds at once run in rounds.
extern "C" int lz4tt_decompress_safe_smem(const void* comp,
                                          long long comp_stride,
                                          const void* comp_lens, void* out,
                                          long long out_stride, int out_max,
                                          void* out_lens, void* err, int n,
                                          void* stream) {
  if (out_max > SmemRing::kBytes) return (int)cudaErrorInvalidValue;
  if (const cudaError_t e = prepare_smem()) return (int)e;
  if (n > 0) {
    decode_smem_kernel<<<n, kSmemThreads, kSmemBytes, (cudaStream_t)stream>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)comp_lens,
        (uint8_t*)out, out_stride, out_max, (int32_t*)out_lens, (int32_t*)err);
  }
  return (int)cudaGetLastError();
}

// The safe contract with a history a row: row b's history is the
// hist_lens[b] <= 65,536 bytes that end at hist + b * hist_stride (they
// may lie just before the row's own output); comp_lens as in
// lz4tt_decompress_safe. Returns cudaGetLastError() after the launch.
extern "C" int lz4tt_decompress_safe_hist(
    const void* comp, long long comp_stride, const void* comp_lens, void* out,
    long long out_stride, int out_max, const void* hist, long long hist_stride,
    const void* hist_lens, void* out_lens, void* err, int n, void* stream) {
  return launch<false, true>(comp, comp_stride, comp_lens, out, out_stride,
                             out_max, out_lens, err, n, stream, hist,
                             hist_stride, hist_lens);
}

// Resident CTAs per SM and threads per CTA of the kernel as launched (the
// first two entry points are one body).
extern "C" int lz4tt_decode_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32 * kWarpsPerCta;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, decode_kernel<false, false>, 32 * kWarpsPerCta, 0);
}

// The same for the kernel with a history.
extern "C" int lz4tt_decode_hist_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32 * kWarpsPerCta;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, decode_kernel<false, true>, 32 * kWarpsPerCta, 0);
}

// The same for the CTA-a-row kernel: the rows it decodes in one round are
// *ctas_per_sm times the SMs.
extern "C" int lz4tt_decode_smem_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kSmemThreads;
  if (const cudaError_t e = prepare_smem()) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, decode_smem_kernel, kSmemThreads, kSmemBytes);
}
