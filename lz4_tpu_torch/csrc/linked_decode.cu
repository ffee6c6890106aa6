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
// a chunk; the resolve writes a 4-byte node a byte, then each round reads
// every node of the batch and gathers the parent of each open one.
//
// Design (the walk's second, the resolve's first):
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
//   - lz4tt_linked_resolve, on one stream: the fill (a CTA of 256 threads a
//     block and 256 of its records, a thread a record, records longer than
//     LZ4TT_LR_LONG nodes by the CTA; one more row of CTAs for the window),
//     `rounds` round kernels over the nodes in place, each a grid of the
//     resident CTAs that counts the nodes it leaves open and returns at
//     once when the round before left none, and the gather of each node's
//     byte. The number of nodes and of blocks to resolve are read on the
//     card, so nothing waits for the host between the walk and the gather.
#include "linked_decode.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"

namespace {

constexpr int kWalkWarps = 4;
constexpr int kTabWarps = 4;
constexpr int kEmitWarps = 4;
constexpr int kChunkThreads = 128;
constexpr int kFill = 256;
constexpr int kRound = 256;

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

// Grid (x, n + 1): CTA (x, b < n) fills records [x * kFill, +kFill) of
// block b, if b is below *n_ok; the row b = n fills the window's nodes.
__global__ void __launch_bounds__(kFill)
    fill_kernel(const uint8_t* __restrict__ comp, int64_t comp_stride,
                const int32_t* tables, int32_t max_seq, int32_t n,
                const int32_t* __restrict__ n_seq,
                const int64_t* __restrict__ block_at,
                const int64_t* __restrict__ n_ok,
                const uint8_t* __restrict__ window, int32_t w,
                int32_t* nodes) {
  __shared__ int32_t longs[kFill];
  __shared__ int32_t n_long;
  const int32_t b = blockIdx.y;
  if (b == n) {
    for (int64_t j = (int64_t)blockIdx.x * kFill + threadIdx.x; j < w;
         j += (int64_t)gridDim.x * kFill)
      nodes[j] = lz4tt_lr_known(window[j]);
    return;
  }
  const int32_t k0 = blockIdx.x * kFill;
  if (b >= *n_ok || k0 >= n_seq[b]) return;  // the same for the whole CTA
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();
  const int64_t plane = (int64_t)n * max_seq;
  int32_t* row = const_cast<int32_t*>(tables) + (int64_t)b * max_seq;
  const Lz4ttLwTables t = {row,             row + plane,     row + 2 * plane,
                           row + 3 * plane, row + 4 * plane, row + 5 * plane};
  const uint8_t* src = comp + b * comp_stride;
  const int64_t base = w + block_at[b];
  const int32_t k = k0 + threadIdx.x;
  if (k < n_seq[b]) {
    if (lz4tt_lr_long(t, k))
      longs[atomicAdd(&n_long, 1)] = k;
    else
      lz4tt_lr_fill(src, t, k, nodes, base, 0, 1);
  }
  __syncthreads();
  for (int32_t q = 0; q < n_long; q++)
    lz4tt_lr_fill(src, t, longs[q], nodes, base, threadIdx.x, kFill);
}

// Round r over nodes [0, *n_nodes): open[r] counts the nodes it leaves
// open; nothing to do once round r - 1 left none.
__global__ void __launch_bounds__(kRound)
    round_kernel(int32_t* nodes, const int64_t* __restrict__ n_nodes,
                 int32_t* open, int32_t r) {
  if (r > 0 && open[r - 1] == 0) return;
  const int64_t total = *n_nodes;
  int32_t mine = 0;
  for (int64_t j = (int64_t)blockIdx.x * kRound + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * kRound)
    mine += lz4tt_lr_step(nodes, j);
  mine = __reduce_add_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && mine) atomicAdd(open + r, mine);
}

__global__ void __launch_bounds__(kRound)
    gather_kernel(const int32_t* __restrict__ nodes,
                  const int64_t* __restrict__ n_nodes, uint8_t* out) {
  const int64_t total = *n_nodes;
  for (int64_t j = (int64_t)blockIdx.x * kRound + threadIdx.x; j < total;
       j += (int64_t)gridDim.x * kRound)
    out[j] = (uint8_t)nodes[j];
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

// The resolve of a walked batch: blocks [0, *n_ok) at nodes w +
// block_at[b] (int64[n + 1], an exclusive scan of their out_total), the
// window's w bytes at nodes [0, w); nodes: int32[>= *n_nodes], n_nodes =
// w + block_at[*n_ok]; open: int32[rounds], zeroed; out: uint8[>=
// *n_nodes], byte j of the batch's nodes. grid: CTAs of each round and of
// the gather. Returns the first error of its launches.
extern "C" int lz4tt_linked_resolve(const void* comp, long long comp_stride,
                                    const void* tables, int max_seq, int n,
                                    const void* n_seq, const void* block_at,
                                    const void* n_ok, const void* window,
                                    int w, const void* n_nodes, void* nodes,
                                    void* out, void* open, int rounds,
                                    int grid, void* stream) {
  if (n < 0 || n >= 65535 || w < 0 || max_seq < 1 || rounds < 0 || grid < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const dim3 fill_grid((max_seq + kFill - 1) / kFill, n + 1);
  fill_kernel<<<fill_grid, kFill, 0, s>>>(
      (const uint8_t*)comp, comp_stride, (const int32_t*)tables, max_seq, n,
      (const int32_t*)n_seq, (const int64_t*)block_at, (const int64_t*)n_ok,
      (const uint8_t*)window, w, (int32_t*)nodes);
  if (const cudaError_t e = cudaGetLastError()) return (int)e;
  for (int r = 0; r < rounds; r++) {
    round_kernel<<<grid, kRound, 0, s>>>((int32_t*)nodes,
                                         (const int64_t*)n_nodes,
                                         (int32_t*)open, r);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
  }
  gather_kernel<<<grid, kRound, 0, s>>>((const int32_t*)nodes,
                                        (const int64_t*)n_nodes,
                                        (uint8_t*)out);
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of a round.
extern "C" int lz4tt_linked_occupancy(int* ctas_per_sm, int* threads) {
  *threads = kRound;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, round_kernel, kRound, 0);
}
