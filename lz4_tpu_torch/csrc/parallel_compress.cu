// K7: the parallel LZ4 compressor on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/parallel_compress.py::compress_parallel_batch
// (:323), the pure-JAX compressor (an argsort, word gathers, reverse
// cummins, a 512-step lax.scan and a searchsorted byte map, vmapped over
// the blocks); not a Pallas kernel. Byte for byte its output.
//
// Bound on the card: by bytes, each input byte read once and each output
// byte written once (3.35 TB/s). What it does besides: two sort passes of
// 4-byte keys a position (its window and the 65,535 positions before it)
// in the team's scratch, word reads for the hash walks, and a few passes
// over its window's bytes in L1 and shared memory.
//
// Design (the second; the first ran a CTA of 512 a block, a stable 8-bit
// LSD sort of (word, position) in four passes of 512-position tiles, and
// the walks' lengths in device memory, so a 4 MiB row ran on one SM): a
// row is cut into windows of 65,536 positions, each a CTA of 1,024
// threads, one CTA an SM (128 KiB of shared memory hold the window's
// match lengths for the walks), in three kernels a wave of rows:
//  1. window_kernel (parallel_compress.cuh, lz4tt_pc_window): candidates
//     by a hash sort and walks (the exact sort where a walk runs long),
//     run stops from thread slices, lengths, walks, the window's groups;
//  2. row_kernel (lz4tt_pc_row): a thread a row carries the group chains,
//     literal starts and output offsets across its windows;
//  3. emit_kernel (lz4tt_pc_emit_window): each window writes its
//     sequences and the literal bytes it holds.
// The windows' stores live in a scratch tensor the wrapper owns, so the
// scratch grows with the windows of a wave and the CTAs, not with the
// batch: a wave is the rows of at most kWaveWindows windows.
#include "parallel_compress.cuh"

#include <cuda_runtime.h>

#include "lz4tt_cta_team.cuh"
#include "lz4tt_device.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kWaveWindows = 512;
constexpr int kRowThreads = 128;
constexpr size_t kMlenBytes =
    lz4tt_pc_mlen_len(LZ4TT_PC_WIN) * sizeof(uint16_t);
using Team = CtaTeam<kThreads>;

struct Batch {
  const uint8_t* src;
  int64_t src_stride;
  const int32_t* src_lens;
  uint8_t* dst;
  int64_t dst_stride;
  int32_t cap;
  int32_t* out_lens;
  int32_t windows;  // a row's windows, at the batch's width
  int64_t span, groups, team_words, window_words;
  int32_t* teams;   // the teams' scratch
  int32_t* stores;  // the wave's windows' stores, then its rows' records
};

// Window v of a wave of `rows` rows: window v / rows of row v % rows, so
// that the CTAs take every row's first window first (a row at the batch's
// width may end in windows past its bytes) and its store.
__device__ int32_t row_of(int32_t v, int32_t rows) { return v % rows; }
__device__ int32_t window_of(int32_t v, int32_t rows) { return v / rows; }
__device__ int32_t* store_of(const Batch& b, int32_t v, int32_t rows) {
  return b.stores +
         ((int64_t)row_of(v, rows) * b.windows + window_of(v, rows)) *
             b.window_words;
}

__global__ void __launch_bounds__(kThreads, 1)
    window_kernel(Batch b, int64_t r0, int32_t n_win, int32_t rows) {
  extern __shared__ uint16_t mlen[];
  __shared__ Team::Shared team;
  __shared__ int32_t cnt[Team::kWarps * 256];
  const Team t{&team, cnt};
  int32_t* mine = b.teams + (int64_t)blockIdx.x * b.team_words;
  for (int32_t v = blockIdx.x; v < n_win; v += gridDim.x) {
    const int64_t row = r0 + row_of(v, rows);
    const int32_t w = window_of(v, rows), n = b.src_lens[row];
    if (w >= lz4tt_pc_windows(n, LZ4TT_PC_WIN)) continue;
    lz4tt_pc_window(t, b.src + row * b.src_stride, n, w, LZ4TT_PC_WIN,
                    LZ4TT_PC_WALK, mine, b.span, b.groups, mlen,
                    store_of(b, v, rows));
  }
}

__global__ void __launch_bounds__(kRowThreads)
    row_kernel(Batch b, int64_t r0, int32_t rows) {
  const int32_t i = blockIdx.x * kRowThreads + threadIdx.x;
  if (i >= rows) return;
  int32_t* records = b.stores + (int64_t)rows * b.windows * b.window_words;
  b.out_lens[r0 + i] = lz4tt_pc_row(
      b.src_lens[r0 + i], LZ4TT_PC_WIN, b.cap,
      b.stores + (int64_t)i * b.windows * b.window_words, b.window_words,
      b.groups, records + (int64_t)i * LZ4TT_PC_ROW_WORDS);
}

__global__ void __launch_bounds__(kThreads, 1)
    emit_kernel(Batch b, int64_t r0, int32_t n_win, int32_t rows) {
  __shared__ Team::Shared team;
  __shared__ int32_t queue;
  const Team t{&team, nullptr};
  int32_t* mine = b.teams + (int64_t)blockIdx.x * b.team_words;
  const int32_t* records =
      b.stores + (int64_t)rows * b.windows * b.window_words;
  for (int32_t v = blockIdx.x; v < n_win; v += gridDim.x) {
    const int64_t row = r0 + row_of(v, rows);
    const int32_t w = window_of(v, rows), n = b.src_lens[row];
    if (w >= lz4tt_pc_windows(n, LZ4TT_PC_WIN)) continue;
    lz4tt_pc_emit_window(t, b.src + row * b.src_stride, n, w, LZ4TT_PC_WIN,
                         store_of(b, v, rows), b.groups,
                         records + (row - r0) * LZ4TT_PC_ROW_WORDS,
                         b.dst + row * b.dst_stride, b.cap, mine, b.span,
                         &queue);
  }
}

cudaError_t set_attributes() {
  int dev;
  return lz4tt_once_a_device(
      [](int) {
        return cudaFuncSetAttribute(window_kernel,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)kMlenBytes);
      },
      &dev);
}

}  // namespace

// Int32 words of a team's scratch (rows of at most `width` bytes).
extern "C" long long lz4tt_parallel_team_words(long long width) {
  return lz4tt_pc_team_words(width, LZ4TT_PC_WIN);
}

// Rows a wave takes at this width, and the words of its stores.
extern "C" long long lz4tt_parallel_wave_rows(long long width) {
  const long long w = lz4tt_pc_windows(width, LZ4TT_PC_WIN);
  return w >= kWaveWindows ? 1 : kWaveWindows / w;
}

extern "C" long long lz4tt_parallel_wave_words(long long width,
                                               long long rows) {
  return rows * (lz4tt_pc_windows(width, LZ4TT_PC_WIN) *
                     lz4tt_pc_window_words(width, LZ4TT_PC_WIN) +
                 LZ4TT_PC_ROW_WORDS);
}

// src: uint8[n, src_stride], src_lens: int32[n] within [0, width]; dst:
// uint8[n, dst_stride], dst_stride >= cap, zeroed by the caller (bytes
// past a row's output are not written); scratch: teams x
// lz4tt_parallel_team_words(width) int32, then lz4tt_parallel_wave_words(
// width, wave_rows). The rows go in waves of wave_rows, three kernels a
// wave, each kernel 1 and 3 a grid of `teams` CTAs. out_lens is -1 on a
// row whose output exceeds cap. Returns the first error of the launches
// (cudaErrorInvalidValue without scratch).
extern "C" int lz4tt_compress_parallel(const void* src, long long src_stride,
                                       const void* src_lens, void* dst,
                                       long long dst_stride, int cap,
                                       long long width, void* scratch,
                                       int teams, long long wave_rows,
                                       void* out_lens, int n, void* stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (teams < 1 || wave_rows < 1 || width < 0)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t e = set_attributes()) return (int)e;
  Batch b;
  b.src = (const uint8_t*)src;
  b.src_stride = src_stride;
  b.src_lens = (const int32_t*)src_lens;
  b.dst = (uint8_t*)dst;
  b.dst_stride = dst_stride;
  b.cap = cap;
  b.out_lens = (int32_t*)out_lens;
  b.windows = lz4tt_pc_windows(width, LZ4TT_PC_WIN);
  b.span = lz4tt_pc_span(width, LZ4TT_PC_WIN);
  b.groups = lz4tt_pc_groups(width, LZ4TT_PC_WIN);
  b.team_words = lz4tt_pc_team_words(width, LZ4TT_PC_WIN);
  b.window_words = lz4tt_pc_window_words(width, LZ4TT_PC_WIN);
  b.teams = (int32_t*)scratch;
  b.stores = b.teams + (int64_t)teams * b.team_words;
  const cudaStream_t s = (cudaStream_t)stream;
  for (long long r0 = 0; r0 < n; r0 += wave_rows) {
    const int32_t rows = (int32_t)(n - r0 < wave_rows ? n - r0 : wave_rows);
    const int32_t n_win = rows * b.windows;
    const int grid = n_win < teams ? n_win : teams;
    window_kernel<<<grid, kThreads, kMlenBytes, s>>>(b, r0, n_win, rows);
    row_kernel<<<(rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0, s>>>(
        b, r0, rows);
    emit_kernel<<<grid, kThreads, 0, s>>>(b, r0, n_win, rows);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
  }
  return (int)cudaSuccess;
}

// Resident CTAs per SM (of the window kernel, its shared memory included)
// and threads per CTA as launched.
extern "C" int lz4tt_parallel_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kThreads;
  if (const cudaError_t e = set_attributes()) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, window_kernel, kThreads, kMlenBytes);
}
