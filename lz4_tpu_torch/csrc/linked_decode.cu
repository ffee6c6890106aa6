// The batched decode of linked-block frames on Hopper (sm_90a): a walk of
// every block's tokens and a frame-wide resolve by pointer doubling
// (linked_decode.cuh).
//
// Replaces, on the linked-frame path, the serial history decode
// (lz4tt_decompress_safe_hist in lz4_decode.cu, one launch, one read-back
// and one row a block, the device counterpart of the native
// tpulz4_decompress_safe_ext, lz4_tpu/native/src/tpulz4.cpp:1060-1202); it
// carries the technique of the pure-JAX gather decode
// (lz4_tpu/kernels/gather_decode.py::_decode_one, :127-165) across the
// blocks of a batch, with a history and no depth cap.
//
// Bound on the card: bytes. The walk reads each compressed byte once and
// writes 24 bytes of table a sequence; the resolve reads the tables, the
// literal bytes and the window once and writes each output byte once
// (3.35 TB/s). What they do instead: the walk is chains of dependent
// loads, one a chunk of a block (K1's, without its copies), beside a
// backward pass over every offset of a chunk and one dependent table read
// a chunk; the resolve's chains are output bytes copied from earlier ones,
// through the whole batch (the match sources of alphabet-4 data lie a few
// hundred bytes back, so a byte's chain runs back to the start of its run
// of such blocks).
//
// Design (the walk's second, the resolve's second):
//   - lz4tt_linked_walk, four launches on one stream: a block longer than
//     one chunk (kernels/linked_decode.py::CHUNK compressed bytes) is cut
//     into chunks, and every chunk but a block's last gets its exit tables
//     (tables_kernel: a warp a chunk, the chunk's bytes staged in shared
//     memory, 32 offsets a step from the chunk's end back, the 0xFF runs'
//     ends and the last 256 offsets' tables in shared memory, the tables
//     in the scratch, 12 B an offset); a thread a block follows its
//     chunks' entries (hops_kernel, one table read a chunk); a warp a
//     chunk, lane 0 walking, walks from its true entry and writes its
//     records (emit_kernel: a block of one chunk is the whole walk); a
//     thread a block takes the first chunk that stopped (finish_kernel).
//     Exact: linked_decode.cuh says why. A batch whose blocks are all one
//     chunk (kernels/linked_decode.py::WHOLE_BELOW: 64 KiB frame blocks)
//     takes the walk's first design alone, which was faster on them: one
//     warp a block, lane 0 walking, four warps a CTA (walk_kernel). The
//     chunks in one kernel with a decoupled look-back lost to the four
//     launches (design_variants.py, linked_decode);
//   - lz4tt_linked_resolve, five launches on one stream
//     (linked_decode.cuh, "The resolve by segments"): segment_kernel, a CTA
//     of 512 threads a segment of 16 KiB of output (64 KiB of int32 nodes
//     in shared memory, three CTAs an SM), fills its nodes from the
//     records that cover it, resolves them in output order and writes
//     every known byte once; count_kernel and init_kernel rank the open
//     exits (the nodes through which chains leave their segments: far
//     fewer than the nodes whose chains leave); and resolve_kernel, a
//     cooperative grid of the resident CTAs, takes those exits in chunks
//     of a fixed room in output order (a chunk's positions from the words
//     of the bitmap that hold its ranks alone), makes each entry the index
//     of the entry its exit has or that exit's known byte, runs the rounds
//     over each chunk in place and writes their bytes; finish_kernel
//     writes every other open node's byte, the byte at its exit. Every byte is written once. Nothing waits for the host,
//     and no launch returns for want of work: the rounds end on the list.
//     The rounds are bounded, and the entries they leave open (none,
//     unless the list is faulty) are counted. A batch holds 2 B an output
//     byte (the offset to its exit), three bitmaps' worth of words and the
//     room (two int32 an entry), where the first design (a node for every
//     byte, rounds over all of them; design_variants.py times it) held an
//     int32 node an output byte.
#include "linked_decode.cuh"

#include <cooperative_groups.h>
#include <string.h>
#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

constexpr int kWalkWarps = 4;
constexpr int kTabWarps = 4;
constexpr int kEmitWarps = 4;
constexpr int kChunkThreads = 128;
// the resolve's segments: output bytes, threads, resident CTAs an SM
constexpr int kSeg = 16384, kSegThreads = 512, kSegCtas = 3;
constexpr int kScan = 512;    // count and init: words a thread, a CTA
constexpr int kScanWords = 4;
constexpr int kChunkWords = kScan * kScanWords;
constexpr int kResolve = 256;
constexpr int kBatch = 8;     // words or entries a thread at a time, in flight
constexpr int kFinish = 16;   // nodes a thread in finish_kernel

// The six tables of block b of n, max_seq records a row.
__device__ __forceinline__ Lz4ttLwTables row_tables(int32_t* tables,
                                                    int32_t n,
                                                    int32_t max_seq,
                                                    int64_t b) {
  const int64_t plane = (int64_t)n * max_seq;
  int32_t* row = tables + b * max_seq;
  return {row,             row + plane,     row + 2 * plane,
          row + 3 * plane, row + 4 * plane, row + 5 * plane};
}

// The largest b < n with base[b] <= g (base: int32[n + 1], ascending,
// base[n] > g): the block of chunk g.
__device__ __forceinline__ int32_t block_of(const int32_t* __restrict__ base,
                                            int32_t n, int32_t g) {
  int32_t lo = 0, hi = n;
  while (hi - lo > 1) {
    const int32_t mid = (lo + hi) >> 1;
    if (base[mid] <= g)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

// The scratch of the chunked walk: n_tab chunks' tables (3 x chunk int32
// each), then five int32[n_chunks] of each chunk's entry, records and
// output before it (then its own), code and reach.
struct ChunkState {
  int32_t *tab, *ent, *n0, *d0, *code, *reach;
};

__host__ __device__ __forceinline__ ChunkState chunk_state(int32_t* scratch,
                                                           int32_t n_chunks,
                                                           int32_t n_tab,
                                                           int32_t chunk) {
  int32_t* s = scratch + (int64_t)n_tab * 3 * chunk;
  return {scratch, s, s + n_chunks, s + 2 * (int64_t)n_chunks,
          s + 3 * (int64_t)n_chunks, s + 4 * (int64_t)n_chunks};
}

// A warp's shared memory in tables_kernel: its stage, ring and ff16.
__host__ __device__ __forceinline__ int64_t table_warp_bytes(int32_t chunk) {
  const int64_t stage = (chunk + LZ4TT_LW_MARGIN + 15) / 16 * 16;
  return stage + 12 * LZ4TT_LW_RING + (2 * (int64_t)chunk + 15) / 16 * 16;
}

// Warp w of CTA x: table chunk g = x * kTabWarps + w (layout: int32[2, n +
// 1], the chunks' and table chunks' exclusive scans a block).
__global__ void __launch_bounds__(32 * kTabWarps)
    tables_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                  const int32_t* __restrict__ lens,
                  const int32_t* __restrict__ layout, int32_t n,
                  int32_t chunk, int32_t n_tab, int32_t* scratch) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int32_t w = threadIdx.x / 32;
  const int32_t g = blockIdx.x * kTabWarps + w;
  if (g >= n_tab) return;  // the whole warp
  uint8_t* mine = smem + w * table_warp_bytes(chunk);
  const int64_t stage = (chunk + LZ4TT_LW_MARGIN + 15) / 16 * 16;
  const Lz4ttLwScratch sc = {(uint16_t*)(mine + stage + 12 * LZ4TT_LW_RING),
                             mine, (int32_t*)(mine + stage)};
  const int32_t* tbase = layout + n + 1;
  const int32_t b = block_of(tbase, n, g), c = g - tbase[b];
  lz4tt_lw_tables(WarpTeam(), comp + b * comp_stride, lens[b], c * chunk,
                  (c + 1) * chunk, scratch + (int64_t)g * 3 * chunk, sc);
}

__global__ void __launch_bounds__(kChunkThreads)
    hops_kernel(const int32_t* __restrict__ layout, int32_t n, int32_t chunk,
                ChunkState st) {
  const int32_t b = blockIdx.x * kChunkThreads + threadIdx.x;
  if (b >= n) return;
  const int32_t cb = layout[b], nc = layout[b + 1] - cb;
  lz4tt_lw_hops(nc, chunk, st.tab + (int64_t)layout[n + 1 + b] * 3 * chunk,
                st.ent + cb, st.n0 + cb, st.d0 + cb);
}

// A warp a chunk, lane 0 walking (lanes of one warp walking chunks of
// their own diverge at every token); its result in place of its entry's
// counts.
__global__ void __launch_bounds__(32 * kEmitWarps)
    emit_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                const int32_t* __restrict__ lens,
                const uint8_t* __restrict__ raw, int32_t n, int32_t dest_cap,
                int32_t* tables, int32_t max_seq,
                const int32_t* __restrict__ layout, int32_t n_chunks,
                int32_t chunk, ChunkState st) {
  const int32_t g = blockIdx.x * kEmitWarps + threadIdx.x / 32;
  if (g >= n_chunks || (threadIdx.x & 31) != 0) return;
  const int32_t b = block_of(layout, n, g), c = g - layout[b];
  const Lz4ttLwResult r = lz4tt_lw_chunk(
      comp + b * comp_stride, lens[b], dest_cap, raw[b] != 0,
      row_tables(tables, n, max_seq, b), max_seq, c, layout[b + 1] - layout[b],
      chunk, st.ent[g], st.n0[g], st.d0[g]);
  st.code[g] = r.code;
  st.n0[g] = r.n_seq;
  st.d0[g] = r.out_total;
  st.reach[g] = r.reach;
}

__global__ void __launch_bounds__(kChunkThreads)
    finish_kernel(const int32_t* __restrict__ layout, int32_t n,
                  ChunkState st, int32_t* n_seq, int32_t* out_total,
                  int32_t* code, int32_t* reach) {
  const int32_t b = blockIdx.x * kChunkThreads + threadIdx.x;
  if (b >= n) return;
  const int32_t cb = layout[b];
  const Lz4ttLwResult r = lz4tt_lw_finish(layout[b + 1] - cb, st.code + cb,
                                          st.n0 + cb, st.d0 + cb,
                                          st.reach + cb);
  n_seq[b] = r.n_seq;
  out_total[b] = r.out_total;
  code[b] = r.code;
  reach[b] = r.reach;
}

__global__ void __launch_bounds__(32 * kWalkWarps)
    walk_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                const int32_t* __restrict__ lens,
                const uint8_t* __restrict__ raw, int32_t n, int32_t dest_cap,
                int32_t* tables, int32_t max_seq, int32_t* n_seq,
                int32_t* out_total, int32_t* code, int32_t* reach) {
  const int64_t b = (int64_t)blockIdx.x * kWalkWarps + threadIdx.x / 32;
  if (b >= n || (threadIdx.x & 31) != 0) return;
  const Lz4ttLwResult r =
      lz4tt_lw_walk(comp + b * comp_stride, lens[b], dest_cap, raw[b] != 0,
                    row_tables(tables, n, max_seq, b), max_seq);
  n_seq[b] = r.n_seq;
  out_total[b] = r.out_total;
  code[b] = r.code;
  reach[b] = r.reach;
}

// ---------------------------------------------------------------------------
// The resolve by segments (linked_decode.cuh, lz4tt_rs_*).
// ---------------------------------------------------------------------------

// A CTA as lz4tt_rs_segment's team (its collectives a warp at a time).
struct SegTeam {
  __host__ __device__ __forceinline__ int rank() const {
#ifdef __CUDA_ARCH__
    return threadIdx.x;
#else
    return 0;
#endif
  }
  __host__ __device__ __forceinline__ int size() const {
#ifdef __CUDA_ARCH__
    return blockDim.x;
#else
    return 1;
#endif
  }
  __host__ __device__ __forceinline__ void sync() const {
#ifdef __CUDA_ARCH__
    __syncthreads();
#endif
  }
  __host__ __device__ __forceinline__ int32_t add(int32_t* p,
                                                  int32_t v) const {
#ifdef __CUDA_ARCH__
    return atomicAdd(p, v);
#else
    return 0;
#endif
  }
  __host__ __device__ __forceinline__ void add_all(int32_t* p,
                                                   int32_t v) const {
#ifdef __CUDA_ARCH__
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(p, v);
#endif
  }
  // the warp's word: a ballot, stored by lane 0
  __host__ __device__ __forceinline__ void put_bit(uint32_t* words, int32_t j,
                                                   bool on,
                                                   bool valid) const {
#ifdef __CUDA_ARCH__
    const uint32_t w = __ballot_sync(0xffffffffu, on);
    if ((threadIdx.x & 31) == 0 && valid) words[j >> 5] = w;
#endif
  }
  __host__ __device__ __forceinline__ void or_shared(uint32_t* p,
                                                     uint32_t v) const {
#ifdef __CUDA_ARCH__
    atomicOr(p, v);
#endif
  }
  __host__ __device__ __forceinline__ void or_global(uint32_t* p,
                                                     uint32_t v) const {
#ifdef __CUDA_ARCH__
    atomicOr(p, v);
#endif
  }
};

// The whole grid of a cooperative launch as lz4tt_rs_rounds' grid.
struct GridTeam {
  __host__ __device__ __forceinline__ int64_t rank() const {
#ifdef __CUDA_ARCH__
    return (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
#else
    return 0;
#endif
  }
  __host__ __device__ __forceinline__ int64_t size() const {
#ifdef __CUDA_ARCH__
    return (int64_t)gridDim.x * blockDim.x;
#else
    return 1;
#endif
  }
  __host__ __device__ __forceinline__ bool leader() const {
#ifdef __CUDA_ARCH__
    return blockIdx.x == 0 && threadIdx.x == 0;
#else
    return true;
#endif
  }
  __host__ __device__ __forceinline__ void sync() const {
#ifdef __CUDA_ARCH__
    cooperative_groups::this_grid().sync();
#endif
  }
  __host__ __device__ __forceinline__ void add_all(int32_t* p,
                                                   int32_t v) const {
#ifdef __CUDA_ARCH__
    v = __reduce_add_sync(0xffffffffu, v);
    if ((threadIdx.x & 31) == 0 && v) atomicAdd(p, v);
#endif
  }
};

// Shared memory of a segment (Lz4ttRsShared): the nodes, the exits'
// bitmap, the long records, four counters.
constexpr size_t kSegSmem =
    4 * (size_t)(kSeg + LZ4TT_RS_EXIT_WORDS + kSegThreads + 4);

// Step 1: CTA g resolves segment [g * kSeg, +kSeg) if it starts below
// *n_nodes; counters[0] += its open nodes.
__global__ void __launch_bounds__(kSegThreads, kSegCtas)
    segment_kernel(Lz4ttRsBatch bt, Lz4ttRsMaps m,
                   const int64_t* __restrict__ n_ok,
                   const int64_t* __restrict__ n_nodes, int32_t* counters) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int64_t total = *n_nodes;
  const int64_t s0 = (int64_t)blockIdx.x * kSeg;
  if (s0 >= total) return;
  bt.n_ok = (int32_t)*n_ok;
  bt.n_nodes = (int32_t)total;
  int32_t* sm = (int32_t*)smem;
  const Lz4ttRsShared sh = {sm, (uint32_t*)(sm + kSeg),
                            sm + kSeg + LZ4TT_RS_EXIT_WORDS,
                            sm + kSeg + LZ4TT_RS_EXIT_WORDS + kSegThreads};
  lz4tt_rs_segment(SegTeam(), bt, m, (int32_t)s0, kSeg, sh);
  if (threadIdx.x == 0 && sh.cnt[2]) atomicAdd(counters, sh.cnt[2]);
}

// The sum of v over a CTA of kScan threads (sh: kScan / 32 int32).
__device__ __forceinline__ int32_t block_sum(int32_t v, int32_t* sh) {
  v = __reduce_add_sync(0xffffffffu, v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  int32_t s = 0;
#pragma unroll
  for (int i = 0; i < kScan / 32; i++) s += sh[i];
  return s;
}

// The exclusive sum of v over a CTA of kScan threads, in thread order.
__device__ __forceinline__ int32_t block_exclusive(int32_t v, int32_t* sh) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += u;
  }
  __syncthreads();
  if (lane == 31) sh[wid] = x;
  __syncthreads();
  int32_t before = 0;
  for (int i = 0; i < wid; i++) before += sh[i];
  return before + x - v;
}

// Step 2: the open exits (exits &= open) and their count a chunk of
// kChunkWords words (thread t: words kScanWords * t, ...).
__global__ void __launch_bounds__(kScan)
    count_kernel(uint32_t* exits, const uint32_t* __restrict__ open,
                 const int64_t* __restrict__ n_nodes, int32_t* chunk_sum) {
  __shared__ int32_t sh[kScan / 32];
  const int64_t words = (*n_nodes + 31) >> 5;
  const int64_t w0 =
      (int64_t)blockIdx.x * kChunkWords + (int64_t)threadIdx.x * kScanWords;
  int32_t c = 0;
#pragma unroll
  for (int u = 0; u < kScanWords; u++) {
    if (w0 + u < words) {
      const uint32_t f = exits[w0 + u] & open[w0 + u];
      exits[w0 + u] = f;
      c += __popc(f);
    }
  }
  c = block_sum(c, sh);
  if (threadIdx.x == 0) chunk_sum[blockIdx.x] = c;
}

// Step 3: word_base, the open exits in all (counters[1]), and the first
// chunk's positions: those of the open exits of ranks below list_cap;
// tally (the rounds' sums) zeroed.
__global__ void __launch_bounds__(kScan)
    init_kernel(Lz4ttRsMaps m, const int64_t* __restrict__ n_nodes,
                const int32_t* __restrict__ chunk_sum, int32_t n_chunks,
                int32_t list_cap, int32_t* counters, int32_t* tally) {
  __shared__ int32_t sh[kScan / 32];
  if (blockIdx.x == 0 && threadIdx.x < 3) tally[threadIdx.x] = 0;
  int32_t before = 0, all = 0;
  for (int32_t c = threadIdx.x; c < n_chunks; c += kScan) {
    const int32_t v = chunk_sum[c];
    all += v;
    if (c < (int32_t)blockIdx.x) before += v;
  }
  before = block_sum(before, sh);
  all = block_sum(all, sh);
  if (blockIdx.x == 0 && threadIdx.x == 0) counters[1] = all;
  const int64_t words = (*n_nodes + 31) >> 5;
  const int64_t w0 =
      (int64_t)blockIdx.x * kChunkWords + (int64_t)threadIdx.x * kScanWords;
  uint32_t f[kScanWords];
  int32_t mine = 0;
#pragma unroll
  for (int u = 0; u < kScanWords; u++) {
    f[u] = w0 + u < words ? m.exits[w0 + u] : 0u;
    mine += __popc(f[u]);
  }
  int32_t at = before + block_exclusive(mine, sh), wb[kScanWords];
#pragma unroll
  for (int u = 0; u < kScanWords; u++) {
    wb[u] = at;
    if (w0 + u < words) m.word_base[w0 + u] = at;
    at += __popc(f[u]);
  }
  // the positions, a warp's words one at a time, a lane a bit: stores of
  // consecutive entries
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < kScanWords; u++)
    for (uint32_t nz = __ballot_sync(0xffffffffu, f[u] != 0u); nz;
         nz &= nz - 1) {
      const int src = __ffs(nz) - 1;
      const uint32_t bits = __shfl_sync(0xffffffffu, f[u], src);
      const int32_t k = __shfl_sync(0xffffffffu, wb[u], src) +
                        __popc(bits & ((1u << lane) - 1u));
      const int32_t w = __shfl_sync(0xffffffffu, (int32_t)(w0 + u), src);
      if (((bits >> lane) & 1u) && k < list_cap) m.pos[k] = w * 32 + lane;
    }
}

// The first word of the open exits' bitmap (of `words`) whose open exits
// reach past rank r (words if none), by a warp: 32 probes a step, the
// words before it those whose open exits all rank at or below r.
__device__ __forceinline__ int64_t word_past(const Lz4ttRsMaps& m,
                                             int64_t words, int32_t r) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = words;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) / 32, w = lo + lane * step;
    const bool before =
        w < hi && m.word_base[w] + __popc(m.exits[w]) <= r;
    const int n = __popc(__ballot_sync(0xffffffffu, before));
    if (n == 0) break;  // the answer is lo
    const int64_t top = lo + n * step;
    lo += (n - 1) * step + 1;
    hi = top < hi ? top : hi;
  }
  return lo;
}

// The open exits with ranks in [base, base + len), kBatch words a warp at a
// time (a lane a bit), over the words that hold them: fn(q, rank(q) -
// base) for each.
template <class F>
__device__ __forceinline__ void each_in_chunk(const Lz4ttRsMaps& m,
                                              int64_t words, int64_t me,
                                              int64_t warps, int32_t base,
                                              int32_t len, F fn) {
  const int lane = threadIdx.x & 31;
  const int64_t lo = word_past(m, words, base);
  int64_t hi = word_past(m, words, base + len - 1) + 1;
  if (hi > words) hi = words;
  for (int64_t w0 = lo + (me >> 5); w0 < hi; w0 += kBatch * warps) {
    uint32_t mask[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; u++) {
      const int64_t w = w0 + u * warps;
      mask[u] = w < hi ? lz4tt_rs_in_chunk(m, w, base, len) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kBatch; u++)
      if ((mask[u] >> lane) & 1u) {
        const int32_t q = (int32_t)((w0 + u * warps) * 32 + lane);
        fn(q, lz4tt_rs_rank(m, q) - base);
      }
  }
}

// Step 4, a cooperative grid (all CTAs resident): the list in chunks of
// list_cap ranks (linked_decode.cuh, step 4; the first chunk's positions
// from init_kernel, the others' here), the rounds over each chunk
// (lz4tt_rs_rounds: a thread's own, then the grid's), counters[2] the most
// rounds a thread took on a chunk, counters[3] the entries left open, each
// chunk's bytes to out at their positions.
__global__ void __launch_bounds__(kResolve)
    resolve_kernel(Lz4ttRsMaps m, const int64_t* __restrict__ n_nodes,
                   int32_t list_cap, int32_t* counters, int32_t* tally) {
  const GridTeam grid;
  const int32_t n_list = counters[1];
  const int64_t me = grid.rank(), lanes = grid.size(), warps = lanes >> 5;
  const int64_t total = *n_nodes, words = (total + 31) >> 5;
  int32_t turn = 0;
  for (int32_t base = 0; base < n_list; base += list_cap) {
    const int32_t len = n_list - base < list_cap ? n_list - base : list_cap;
    if (base > 0) {
      each_in_chunk(m, words, me, warps, base, len,
                    [&](int32_t q, int32_t k) { m.pos[k] = q; });
      grid.sync();
    }
    // the entries: their exits' own entries or known bytes, each step's
    // loads for kBatch entries in flight together
    for (int64_t i0 = me; i0 < len; i0 += kBatch * lanes) {
      int32_t q[kBatch], k[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; u++)
        q[u] = i0 + u * lanes < len ? m.pos[i0 + u * lanes] : -1;
#pragma unroll
      for (int u = 0; u < kBatch; u++)
        if (q[u] >= 0) q[u] = lz4tt_rs_exit(m, q[u], kSeg);
#pragma unroll
      for (int u = 0; u < kBatch; u++)
        if (q[u] >= 0) k[u] = lz4tt_rs_where(m, q[u], base);
#pragma unroll
      for (int u = 0; u < kBatch; u++)
        if (q[u] >= 0 && k[u] < 0) k[u] = lz4tt_lr_known(m.out[q[u]]);
#pragma unroll
      for (int u = 0; u < kBatch; u++)
        if (q[u] >= 0) m.list[i0 + u * lanes] = k[u];
    }
    grid.sync();
    int32_t rounds = 0;
    const int32_t left = lz4tt_rs_rounds(grid, m, len,
                                         lz4tt_rs_rounds_for(len), tally,
                                         turn, rounds);
    rounds = __reduce_max_sync(0xffffffffu, rounds);
    if ((threadIdx.x & 31) == 0 && rounds) atomicMax(counters + 2, rounds);
    if (left && grid.leader()) atomicAdd(counters + 3, left);
    for (int64_t i = me; i < len; i += lanes)
      m.out[m.pos[i]] = (uint8_t)m.list[i];
    grid.sync();
  }
}

// Step 5, kFinish nodes a thread (their offsets in two 16-byte loads, one
// word of the list's bitmap): every other open node (off[j] != 0, not
// listed), the byte at its exit, known in out since step 1 or 4; a
// thread's 16 bytes in one store where all of them are such.
__global__ void __launch_bounds__(kResolve)
    finish_kernel(Lz4ttRsMaps m, const int64_t* __restrict__ n_nodes) {
  const int64_t total = *n_nodes;
  const int64_t j0 = ((int64_t)blockIdx.x * kResolve + threadIdx.x) * kFinish;
  if (j0 >= total) return;
  uint16_t o[kFinish];
  if (j0 + kFinish <= total) {
    const uint4* src = (const uint4*)(m.off + j0);
    const uint4 a = src[0], b = src[1];
    memcpy(o, &a, 16);
    memcpy(o + 8, &b, 16);
  } else {
#pragma unroll
    for (int u = 0; u < kFinish; u++) o[u] = j0 + u < total ? m.off[j0 + u] : 0;
  }
  const uint32_t listed = m.exits[j0 >> 5] >> (j0 & 31);
  const int32_t s0 = (int32_t)j0 & ~(kSeg - 1);  // the same for the 16
  uint32_t mine = 0;
  uint8_t b[kFinish];
#pragma unroll
  for (int u = 0; u < kFinish; u++)
    if (o[u] && !((listed >> u) & 1u)) {
      mine |= 1u << u;
      b[u] = m.out[s0 - o[u]];
    }
  if (mine == 0xFFFFu) {
    uint4 v;
    memcpy(&v, b, 16);
    *(uint4*)(m.out + j0) = v;
    return;
  }
#pragma unroll
  for (int u = 0; u < kFinish; u++)
    if ((mine >> u) & 1u) m.out[j0 + u] = b[u];
}

}  // namespace

// comp: uint8[n, comp_stride], row b's first lens[b] bytes block b's
// payload (raw[b] != 0: stored raw); tables: int32[6, n, max_seq] in the
// order lit_out, lit_src, lit_len, m_out, m_dist, m_len, the first
// n_seq[b] entries of row b written (those past them undefined);
// out_total, code, reach: int32[n]. layout: int32[2, n + 1], the exclusive
// scans of each block's chunks (n_chunks in all) and of its chunks but the
// last (n_tab), chunks of `chunk` <= 65,535 compressed bytes
// (kernels/linked_decode.py::chunk_layout); scratch: int32[n_tab * 3 *
// chunk + 5 * n_chunks]. A batch of one chunk a block (n_chunks == n) runs
// the warp walk alone (walk_kernel; layout and scratch unused). Returns
// the first error of its launches.
extern "C" int lz4tt_linked_walk(const void* comp, long long comp_stride,
                                 const void* lens, const void* raw, int n,
                                 int dest_cap, void* tables, int max_seq,
                                 void* n_seq, void* out_total, void* code,
                                 void* reach, const void* layout,
                                 int n_chunks, int n_tab, int chunk,
                                 void* scratch, void* stream) {
  if (n < 0 || dest_cap < 0 || max_seq < 1 || chunk < 1 || chunk > 65535 ||
      n_chunks < n || n_tab < 0 || n_tab > n_chunks)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  if (n_chunks == n) {  // every block one chunk: the warp walk alone
    walk_kernel<<<(n + kWalkWarps - 1) / kWalkWarps, 32 * kWalkWarps, 0, s>>>(
        (const uint8_t*)comp, comp_stride, (const int32_t*)lens,
        (const uint8_t*)raw, n, dest_cap, (int32_t*)tables, max_seq,
        (int32_t*)n_seq, (int32_t*)out_total, (int32_t*)code,
        (int32_t*)reach);
    return (int)cudaGetLastError();
  }
  const int32_t* lay = (const int32_t*)layout;
  const ChunkState st = chunk_state((int32_t*)scratch, n_chunks, n_tab, chunk);
  if (n_tab > 0) {
    const size_t smem = (size_t)kTabWarps * table_warp_bytes(chunk);
    if (smem > 48 * 1024) {
      if (const cudaError_t e = cudaFuncSetAttribute(
              tables_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              (int)smem))
        return (int)e;
    }
    tables_kernel<<<(n_tab + kTabWarps - 1) / kTabWarps, 32 * kTabWarps, smem,
                    s>>>((const uint8_t*)comp, comp_stride,
                         (const int32_t*)lens, lay, n, chunk, n_tab,
                         (int32_t*)scratch);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
  }
  const int by_block = (n + kChunkThreads - 1) / kChunkThreads;
  hops_kernel<<<by_block, kChunkThreads, 0, s>>>(lay, n, chunk, st);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  emit_kernel<<<(n_chunks + kEmitWarps - 1) / kEmitWarps, 32 * kEmitWarps,
                0, s>>>((const uint8_t*)comp, comp_stride,
                        (const int32_t*)lens, (const uint8_t*)raw, n,
                        dest_cap, (int32_t*)tables, max_seq, lay, n_chunks,
                        chunk, st);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  finish_kernel<<<by_block, kChunkThreads, 0, s>>>(
      lay, n, st, (int32_t*)n_seq, (int32_t*)out_total, (int32_t*)code,
      (int32_t*)reach);
  return (int)cudaGetLastError();
}

// The scratch of lz4tt_linked_resolve in int32, for node_cap nodes
// (kernels/linked_decode.py::resolve_scratch): open, exits and word_base (a
// word each 32 nodes, rounded up to 4), the chunks' counts, the rounds'
// tally (4), the list and its positions.
static int64_t resolve_words(long long node_cap) {
  return ((node_cap + 31) / 32 + 3) / 4 * 4;
}
static int64_t resolve_chunks(long long node_cap) {
  return (resolve_words(node_cap) + kChunkWords - 1) / kChunkWords;
}

// The segment kernel's attributes, once a card.
static cudaError_t prepare_segments() {
  int dev = 0;
  return lz4tt_once_a_device(
      [&](int) {
        if (const cudaError_t e = cudaFuncSetAttribute(
                segment_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                (int)kSegSmem))
          return e;
        return cudaFuncSetAttribute(
            segment_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
            (int)cudaSharedmemCarveoutMaxShared);
      },
      &dev);
}

// The resolve of a walked batch (linked_decode.cuh, "The resolve by
// segments"): blocks [0, *n_ok) at w + block_at[b] (int64[n + 1], an
// exclusive scan of their out_total), the window's w bytes first; n_nodes
// = w + block_at[*n_ok] <= node_cap. out: uint8[node_cap], bytes [0,
// *n_nodes) written; off: uint16[node_cap]; scratch: int32[3 *
// resolve_words + resolve_chunks + 4 + 2 * list_cap]; counters: int32[4],
// the nodes open after the segments' pass, the open exits (the list), the
// most rounds a thread took, and the list entries left open (0: every
// chain ends). Segments of kSeg bytes; the list in chunks of list_cap
// entries; grid: the resident CTAs of resolve_kernel (a cooperative
// launch). Returns the first error.
extern "C" int lz4tt_linked_resolve(
    const void* comp, long long comp_stride, const void* tables, int max_seq,
    int n, const void* n_seq, const void* block_at, const void* n_ok,
    const void* window, int w, const void* n_nodes, long long node_cap,
    void* out, void* off, void* scratch, long long list_cap, void* counters,
    int grid, void* stream) {
  if (n < 0 || w < 0 || w > LZ4TT_RS_REACH || max_seq < 1 || node_cap < 1 ||
      node_cap >= (1ll << 31) || list_cap < 1 || list_cap >= (1ll << 31) ||
      grid < 1)
    return (int)cudaErrorInvalidValue;
  if (const cudaError_t e = prepare_segments()) return (int)e;
  const cudaStream_t s = (cudaStream_t)stream;
  const int64_t words = resolve_words(node_cap);
  int32_t* sc = (int32_t*)scratch;
  const int32_t n_chunks = (int32_t)resolve_chunks(node_cap);
  int32_t* chunk_sum = sc + 3 * words;
  int32_t* tally = chunk_sum + n_chunks;
  int32_t* list = tally + 4;
  const Lz4ttRsMaps m = {(uint8_t*)out,        (uint16_t*)off,
                         (uint32_t*)sc,        (uint32_t*)(sc + words),
                         sc + 2 * words,       list,
                         list + list_cap};
  const Lz4ttRsBatch bt = {(const uint8_t*)comp, comp_stride,
                           (int32_t*)tables,     max_seq,
                           n,                    (const int32_t*)n_seq,
                           (const int64_t*)block_at,
                           0,                    (const uint8_t*)window,
                           w,                    0};
  const int64_t* nk = (const int64_t*)n_ok;
  const int64_t* nn = (const int64_t*)n_nodes;
  int32_t* cnt = (int32_t*)counters;
  if (const cudaError_t e = cudaMemsetAsync(m.exits, 0, 4 * words, s))
    return (int)e;
  if (const cudaError_t e = cudaMemsetAsync(cnt, 0, 4 * sizeof(int32_t), s))
    return (int)e;
  segment_kernel<<<(unsigned)((node_cap + kSeg - 1) / kSeg), kSegThreads,
                   kSegSmem, s>>>(bt, m, nk, nn, cnt);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  count_kernel<<<n_chunks, kScan, 0, s>>>(m.exits, m.open, nn, chunk_sum);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  int32_t cap = (int32_t)list_cap;
  init_kernel<<<n_chunks, kScan, 0, s>>>(m, nn, chunk_sum, n_chunks, cap,
                                         cnt, tally);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  void* args[] = {(void*)&m, (void*)&nn, (void*)&cap, (void*)&cnt,
                  (void*)&tally};
  if (const cudaError_t e = cudaLaunchCooperativeKernel(
          (const void*)resolve_kernel, grid, kResolve, args, 0, s))
    return (int)e;
  const int64_t per = (int64_t)kFinish * kResolve;
  finish_kernel<<<(unsigned)((node_cap + per - 1) / per), kResolve, 0, s>>>(
      m, nn);
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the rounds.
extern "C" int lz4tt_linked_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kResolve;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, resolve_kernel, kResolve, 0);
}

// The same of the segment kernel.
extern "C" int lz4tt_linked_segment_occupancy(int* ctas_per_sm,
                                              int* threads) {
  *threads = kSegThreads;
  if (const cudaError_t e = prepare_segments()) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, segment_kernel, kSegThreads, kSegSmem);
}
