// The LZ4Block stream read on Hopper (sm_90a): the walk of its headers, and
// the decode of its blocks (block_stream.cuh has the format). Not a TPU
// kernel: the JAX package walks the stream on the host, a header at a
// time (lz4_tpu/formats/block_stream.py).
//
// lz4tt_lz4block_index lists the records a reader meets. A header's
// position depends on every payload before it, so one thread following
// them would make one dependent read of the stream a block. Instead:
//   1. mark (a warp a 4 KiB tile of the stream, a CTA a span of eight,
//      every span at once): the positions where the magic starts, a span's
//      count and its first kSpanSlots positions, kept where no tile of it
//      holds more than kSlots. The stream is read once, 16 bytes a lane.
//   2. chain (one CTA): the candidates in order (the spans' counts
//      scanned, a span whose positions were not all kept scanned again by
//      a warp);
//      each candidate's header parsed with the reader's rules and linked
//      to the candidate at its successor's position (or to the fault
//      there: a successor that is no candidate is CORRUPTED, one cut off
//      by the end PREMATURE); then the chain from position 0 ranked. Where
//      every candidate before the chain's end links to the next one (no
//      magic inside a payload before it), the chain is the candidates in
//      order; else it is ranked by pointer jumping: tables of 2^m-step
//      links, the chain's length from candidate 0's, and each rank's
//      candidate from the bits of its rank. A false candidate inside a
//      payload is thus never reached. Candidates past the room of the
//      scratch (4 a record asked for, and 4096) are dropped; should the
//      chain reach past the last one kept, thread 0 walks on from the
//      stream's headers (lz4tt_lz4block_walk), which only a stream
//      holding that many magic bytes in its payloads asks for.
// The records agree with lz4tt_lz4block_walk from position 0, which the
// plain version runs (kernels/block_stream.py).
//
// lz4tt_lz4block_decode: a warp a record, as K1 lays out its warps (four a
// CTA, a 4 KiB ring and a copy queue each in shared memory), the records
// in the order the chain kernel gives them (the LZ4 payloads first: a
// CTA that mixes long decodes with short copies held the stream's decode
// 12 % longer on an H100, 3.05 against 2.72 ms at 4,096 x 64 KiB): a raw
// payload is copied into its row by the pack kernel's team copy
// (frame_pack.cuh), an LZ4 payload decoded there by K1's body in the fast
// contract (lz4tt_decode_row<true>), reading the payload where it lies in
// the stream, its stated original length the exact decoded length and its
// compressed length the bytes available; the bytes read must be the
// compressed length (else CORRUPTED), a payload that does not decode is
// MALFORMED. K1's own entry points (lz4_decode.cu) take one decoded length
// a launch; a stream's blocks state theirs, so this kernel takes each
// row's from the index and leaves K1's kernels as they were.
// lz4tt_lz4block_verdict then compares K3's hash of each decoded row,
// masked to 28 bits, with the header's check (CORRUPTED where they
// differ).
//
// Bound on the card: bytes. The index reads the stream once (the mark)
// and writes 24 B a record; the decode reads each payload once and writes
// each row once, then K3 reads the rows again.
#include "block_stream.cuh"

#include <cuda_runtime.h>

#include "lz4_decode.cuh"
#include "lz4tt_device.cuh"

namespace {

constexpr uint32_t kFull = 0xffffffffu;
constexpr int kTile = 4096;                 // bytes of the stream a warp marks
constexpr int kIters = kTile / (32 * 16);   // 16-byte chunks a lane marks
constexpr int kSlots = 4;                   // candidates a tile keeps
constexpr int kMarkWarps = 8;               // tiles a span
constexpr int kSpan = kTile * kMarkWarps;
constexpr int kSpanSlots = 16;              // candidates a span keeps
constexpr int kChainThreads = 1024;
constexpr int kDecWarps = 4;
constexpr int kDecCtasPerSm = 8;
constexpr int kVerdictThreads = 256;

// The 16 bytes at c (16-byte aligned) into w[0..3], bytes at and past len
// zero.
__device__ __forceinline__ void load_chunk(const uint8_t* s, int64_t c,
                                           int64_t len, uint32_t w[4]) {
  if (c + 16 <= len) {
    const lz4tt_u4 v = lz4tt_load16(s + c);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
    return;
  }
#pragma unroll
  for (int k = 0; k < 4; k++) {
    uint32_t x = 0;
#pragma unroll
    for (int i = 0; i < 4; i++) {
      const int64_t p = c + 4 * k + i;
      if (p < len) x |= (uint32_t)s[p] << (8 * i);
    }
    w[k] = x;
  }
}

// The candidates of the tile at base, in order, by one warp: sink(k, pos)
// for the k-th. Returns the tile's count on every lane.
template <class Sink>
__device__ __forceinline__ int32_t scan_tile(const uint8_t* s, int64_t len,
                                             int64_t base, Sink sink) {
  const int lane = threadIdx.x & 31;
  uint32_t w[kIters][4];
#pragma unroll
  for (int it = 0; it < kIters; it++)
    load_chunk(s, base + it * 512 + lane * 16, len, w[it]);
  int32_t found = 0;
  const unsigned below = (1u << lane) - 1;
#pragma unroll
  for (int it = 0; it < kIters; it++) {
    const int64_t c = base + it * 512 + lane * 16;
    // the 8 bytes after the chunk: lane + 1's first two words; lane 31's
    // are the next chunk's (lane 0 of the next step, or past the tile)
    uint32_t x[6] = {w[it][0], w[it][1], w[it][2], w[it][3], 0u, 0u};
    x[4] = __shfl_down_sync(kFull, w[it][0], 1);
    x[5] = __shfl_down_sync(kFull, w[it][1], 1);
    if (it + 1 < kIters) {
      const uint32_t a = __shfl_sync(kFull, w[it + 1][0], 0);
      const uint32_t b = __shfl_sync(kFull, w[it + 1][1], 0);
      if (lane == 31) {
        x[4] = a;
        x[5] = b;
      }
    } else if (lane == 31) {
      uint32_t y[4];
      load_chunk(s, c + 16, len, y);
      x[4] = y[0];
      x[5] = y[1];
    }
    uint32_t hits = lz4tt_lz4block_hits(x);
    const int mine = __popc(hits);  // at most 2: the magic cannot overlap itself
    const unsigned one = __ballot_sync(kFull, mine >= 1);
    const unsigned two = __ballot_sync(kFull, mine >= 2);
    int32_t k = found + __popc(one & below) + __popc(two & below);
    while (hits) {
      const int r = __ffs(hits) - 1;
      hits &= hits - 1;
      sink(k++, (int32_t)(c + r));
    }
    found += __popc(one) + __popc(two);
  }
  return found;
}

// CTA c marks span c: counts[c] its candidates, slots[c * kSpanSlots + k]
// its k-th where exact[c], which holds where every one was kept.
__global__ void __launch_bounds__(32 * kMarkWarps)
    lz4block_mark_kernel(const uint8_t* __restrict__ s, int64_t len,
                         int32_t* __restrict__ counts,
                         int32_t* __restrict__ exact,
                         int32_t* __restrict__ slots) {
  __shared__ int32_t tile_slots[kMarkWarps][kSlots];
  __shared__ int32_t tile_count[kMarkWarps];
  const int warp = threadIdx.x >> 5;
  const int64_t span = blockIdx.x;
  const int64_t base = span * kSpan + (int64_t)warp * kTile;
  int32_t n = 0;
  if (base < len)  // uniform across the warp
    n = scan_tile(s, len, base, [&](int32_t k, int32_t p) {
      if (k < kSlots) tile_slots[warp][k] = p;
    });
  if ((threadIdx.x & 31) == 0) tile_count[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t* out = slots + span * kSpanSlots;
    int32_t total = 0;
    bool kept = true;
    for (int w = 0; w < kMarkWarps; w++) {
      const int32_t c = tile_count[w];
      kept = kept && c <= kSlots && total + c <= kSpanSlots;
      for (int32_t j = 0; kept && j < c; j++) out[total + j] = tile_slots[w][j];
      total += c;
    }
    counts[span] = total;
    exact[span] = kept;
  }
}

// The chain kernel's scratch: a span's count, whether all were kept, and
// its slots (the mark's), the spans scanned again with their first
// candidate's rank, and a candidate's position, header fields, code,
// successor's position, link (a candidate; -1 none; -2 past the kept
// candidates), the fault after it (NONE for none), the ranked chain, and
// the pointer-jumping tables (log - 1 of cap each; link is the first).
struct Scratch {
  int32_t *counts, *exact, *slots, *over_span, *over_off;
  int32_t *cand, *clen, *olen, *meth, *chk, *code, *next, *link, *tail,
      *path, *lift;
};

constexpr int32_t kPastKept = -2;

// The exclusive sum of v over the CTA's threads, and the total.
__device__ int32_t cta_exclusive_sum(int32_t v, int32_t* warp_sums,
                                     int32_t* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int32_t x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += u;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int32_t y = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t u = __shfl_up_sync(kFull, y, o);
      if (lane >= o) y += u;
    }
    if (lane < nw) warp_sums[lane] = y;
  }
  __syncthreads();
  const int32_t before = (warp ? warp_sums[warp - 1] : 0) + x - v;
  *total = warp_sums[(blockDim.x >> 5) - 1];
  __syncthreads();
  return before;
}

// The candidate of rank k of the chain from candidate 0: 2^m steps at a
// time for each bit m of k.
__device__ __forceinline__ int32_t jump(const Scratch& x, int32_t cap,
                                        int log, int32_t node, int32_t k) {
  for (int m = 0; m < log && node >= 0; m++)
    if ((k >> m) & 1) node = (m == 0 ? x.link : x.lift + (int64_t)(m - 1) * cap)[node];
  return node;
}

__global__ void __launch_bounds__(kChainThreads)
    lz4block_chain_kernel(const uint8_t* __restrict__ s, int64_t len,
                          int32_t n_spans, Scratch x, int32_t cap, int log,
                          int32_t max_blocks, int stop,
                          int32_t* __restrict__ table, int64_t fs,
                          int32_t* __restrict__ meta,
                          int32_t* __restrict__ order) {
  __shared__ int32_t warp_sums[32];
  __shared__ int32_t n_over, first_break, path_len, count;
  __shared__ int64_t end;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, nw = nt >> 5;

  // 1. the candidates in order
  if (tid == 0) n_over = 0;
  const int32_t per = (n_spans + nt - 1) / nt;
  const int32_t t0 = min(tid * per, n_spans), t1 = min(t0 + per, n_spans);
  int32_t mine = 0;
  for (int32_t t = t0; t < t1; t++) mine += x.counts[t];
  int32_t total;
  int32_t off = cta_exclusive_sum(mine, warp_sums, &total);
  for (int32_t t = t0; t < t1; t++) {
    const int32_t c = x.counts[t];
    if (x.exact[t]) {
      for (int32_t j = 0; j < c && off + j < cap; j++)
        x.cand[off + j] = x.slots[(int64_t)t * kSpanSlots + j];
    } else if (off < cap) {
      const int32_t i = atomicAdd(&n_over, 1);
      x.over_span[i] = t;
      x.over_off[i] = off;
    }
    off += c;
  }
  __syncthreads();
  for (int32_t i = warp; i < n_over; i += nw) {
    int32_t o = x.over_off[i];
    const int64_t base = (int64_t)x.over_span[i] * kSpan;
    for (int w = 0; w < kMarkWarps && o < cap && base + w * kTile < len; w++)
      o += scan_tile(s, len, base + w * kTile, [&](int32_t k, int32_t p) {
        if (o + k < cap) x.cand[o + k] = p;
      });
  }
  __syncthreads();
  const int32_t n = min(total, cap);

  // 2. each candidate's header and link
  for (int32_t i = tid; i < n; i += nt) {
    const int64_t p = x.cand[i];
    Lz4ttBlockRecord r = lz4tt_lz4block_parse(s, p, len);
    const int64_t q = p + LZ4TT_LZ4BLOCK_HEADER + r.comp_len;
    if (r.code == LZ4TT_LZ4BLOCK_OK && r.orig_len > 0 && q > len)
      r = {0, 0, 0, 0, LZ4TT_LZ4BLOCK_PREMATURE};
    int32_t link = -1, tail = LZ4TT_LZ4BLOCK_NONE;
    if (r.code == LZ4TT_LZ4BLOCK_OK && !(r.orig_len == 0 && stop)) {
      if (q == len) {
        tail = stop ? LZ4TT_LZ4BLOCK_PREMATURE : LZ4TT_LZ4BLOCK_NONE;
      } else if (q + LZ4TT_LZ4BLOCK_HEADER > len) {
        tail = LZ4TT_LZ4BLOCK_PREMATURE;
      } else if (i + 1 < n && x.cand[i + 1] == q) {
        link = i + 1;
      } else {
        int32_t lo = i + 1, hi = n;  // the first candidate at or past q
        while (lo < hi) {
          const int32_t mid = (lo + hi) >> 1;
          if (x.cand[mid] < q) lo = mid + 1; else hi = mid;
        }
        if (lo < n && x.cand[lo] == q)
          link = lo;
        else if (lo == n && total > cap)
          link = kPastKept;
        else
          tail = LZ4TT_LZ4BLOCK_CORRUPTED;
      }
    }
    x.clen[i] = r.comp_len;
    x.olen[i] = r.orig_len;
    x.meth[i] = r.method;
    x.chk[i] = r.check;
    x.code[i] = r.code;
    x.next[i] = (int32_t)(r.code == LZ4TT_LZ4BLOCK_OK ? q : p);
    x.link[i] = link;
    x.tail[i] = tail;
  }
  if (tid == 0) first_break = n;
  __syncthreads();

  // 3. the chain from position 0: its length, and whether it is the
  // candidates in order
  const bool chained = len >= LZ4TT_LZ4BLOCK_HEADER && n > 0 && x.cand[0] == 0;
  for (int32_t i = tid; i < n; i += nt)
    if (x.link[i] != i + 1) atomicMin(&first_break, i);
  __syncthreads();
  const bool in_order = !chained || x.link[first_break] < 0;
  if (chained && !in_order) {
    int32_t* prev = x.link;
    for (int m = 1; m < log; m++) {
      int32_t* cur = x.lift + (int64_t)(m - 1) * cap;
      for (int32_t i = tid; i < n; i += nt) {
        const int32_t a = prev[i];
        cur[i] = a >= 0 ? prev[a] : -1;
      }
      __syncthreads();
      prev = cur;
    }
    if (tid == 0) {
      int32_t node = 0, steps = 0;
      for (int m = log - 1; m >= 0; m--) {
        const int32_t nx = (m == 0 ? x.link : x.lift + (int64_t)(m - 1) * cap)[node];
        if (nx >= 0) {
          node = nx;
          steps += 1 << m;
        }
      }
      path_len = steps + 1;
    }
    __syncthreads();
    const int32_t m_len = min(path_len, max_blocks);
    for (int32_t k = tid; k < m_len; k += nt) x.path[k] = jump(x, cap, log, 0, k);
  } else if (tid == 0) {
    path_len = chained ? first_break + 1 : 0;
  }
  __syncthreads();

  // 4. the records: the chain's, then the fault or the walk after it
  const int32_t rows = min(path_len, max_blocks);
  for (int32_t k = tid; k < rows; k += nt) {
    const int32_t i = in_order ? k : x.path[k];
    const Lz4ttBlockRecord r = {x.clen[i], x.olen[i], x.meth[i], x.chk[i], x.code[i]};
    lz4tt_lz4block_put(table, fs, k, x.cand[i], r);
  }
  if (tid == 0) {
    int32_t k = rows;
    int64_t e = 0;
    if (!chained) {
      // the stream's first header is cut off, absent, or not there at all
      e = 0;
      k = lz4tt_lz4block_walk(s, len, 0, stop, 0, max_blocks, table, fs, &e);
    } else {
      const int32_t last = in_order ? rows - 1 : x.path[rows - 1];
      e = x.next[last];
      if (rows == path_len && rows < max_blocks) {
        if (x.link[last] == kPastKept) {
          k = lz4tt_lz4block_walk(s, len, e, stop, rows, max_blocks, table, fs, &e);
        } else if (x.tail[last] != LZ4TT_LZ4BLOCK_NONE) {
          const Lz4ttBlockRecord r = {0, 0, 0, 0, x.tail[last]};
          lz4tt_lz4block_put(table, fs, k++, e, r);
        }
      }
    }
    count = k;
    end = e;
  }
  __syncthreads();
  const Lz4ttBlockRecord none = {0, 0, 0, 0, LZ4TT_LZ4BLOCK_NONE};
  for (int32_t k = count + tid; k < max_blocks; k += nt)
    lz4tt_lz4block_put(table, fs, k, 0, none);
  if (tid == 0) {
    meta[0] = count;
    meta[1] = (int32_t)end;
  }
  __syncthreads();

  // 5. the decode's order: the records it decodes as LZ4 first, each part
  // in stream order
  const int32_t per_row = (max_blocks + nt - 1) / nt;
  const int32_t r0 = min(tid * per_row, max_blocks);
  const int32_t r1 = min(r0 + per_row, max_blocks);
  int32_t lz4 = 0;
  for (int32_t k = r0; k < r1; k++) lz4 += lz4tt_lz4block_decodes(table, fs, k);
  int32_t n_lz4;
  int32_t before = cta_exclusive_sum(lz4, warp_sums, &n_lz4);
  int32_t other = n_lz4 + r0 - before;
  for (int32_t k = r0; k < r1; k++)
    order[lz4tt_lz4block_decodes(table, fs, k) ? before++ : other++] = k;
}

__global__ void __launch_bounds__(32 * kDecWarps, kDecCtasPerSm)
    lz4block_decode_kernel(const uint8_t* __restrict__ s,
                           const int32_t* __restrict__ table, int64_t fs,
                           const int32_t* __restrict__ order, int32_t n,
                           uint8_t* out, int64_t out_stride, int32_t out_max,
                           int32_t* __restrict__ out_lens,
                           int32_t* __restrict__ err) {
  __shared__ __align__(16) uint8_t rings[kDecWarps][LZ4TT_RING];
  __shared__ Lz4ttCopies queues[kDecWarps];
  const int warp = threadIdx.x >> 5;
  const int64_t w = (int64_t)blockIdx.x * kDecWarps + warp;
  if (w >= n) return;  // uniform across the warp
  const int64_t b = order[w];
  WarpTeam t;
  const int32_t code = table[LZ4TT_LZ4BLOCK_CODE * fs + b];
  const int32_t ol = table[LZ4TT_LZ4BLOCK_OLEN * fs + b];
  int32_t len = 0, e = code;
  if (code == LZ4TT_LZ4BLOCK_OK && ol > 0) {
    if (ol > out_max) {
      e = LZ4TT_LZ4BLOCK_TOO_LARGE;
    } else {
      const int32_t cl = table[LZ4TT_LZ4BLOCK_CLEN * fs + b];
      const uint8_t* p =
          s + (int64_t)table[LZ4TT_LZ4BLOCK_AT * fs + b] + LZ4TT_LZ4BLOCK_HEADER;
      uint8_t* row = out + b * out_stride;
      if (table[LZ4TT_LZ4BLOCK_METHOD * fs + b] == LZ4TT_LZ4BLOCK_RAW) {
        lz4tt_team_copy(t, row, p, ol);
        len = ol;
      } else {
        int32_t got = 0, read = 0, de = LZ4TT_OK;
        lz4tt_decode_row<true>(t, p, cl, cl, row, ol, rings[warp], queues[warp],
                               &got, &read, &de);
        if (de != LZ4TT_OK) {
          e = LZ4TT_LZ4BLOCK_MALFORMED;
        } else {
          len = ol;
          if (read != cl) e = LZ4TT_LZ4BLOCK_CORRUPTED;
        }
      }
    }
  }
  if (t.leader()) {
    out_lens[b] = len;
    err[b] = e;
  }
}

__global__ void __launch_bounds__(kVerdictThreads)
    lz4block_verdict_kernel(const uint32_t* __restrict__ hashes,
                            const int32_t* __restrict__ table, int64_t fs,
                            const int32_t* __restrict__ out_lens,
                            int32_t* __restrict__ err, int32_t n) {
  const int64_t b = (int64_t)blockIdx.x * kVerdictThreads + threadIdx.x;
  if (b >= n) return;
  if (err[b] == LZ4TT_LZ4BLOCK_OK && out_lens[b] > 0 &&
      (hashes[b] & LZ4TT_LZ4BLOCK_CHECK_MASK) !=
          (uint32_t)table[LZ4TT_LZ4BLOCK_CHECK * fs + b])
    err[b] = LZ4TT_LZ4BLOCK_CORRUPTED;
}

}  // namespace

// The records of s[0, len) (16-byte aligned) from position 0: table
// int32[6, fs] (rows AT, CLEN, OLEN, METHOD, CHECK, CODE; the first
// max_blocks > 0 columns written, NONE past the last record), meta
// int32[2] (the records, the position after the last), order
// int32[max_blocks] (the decode's order of the columns); n_spans = ceil(len
// / 32768); scratch int32[20 * n_spans + (9 + log) * cap] (Scratch, in its
// order); cap > 0 and 2^log > cap. Returns cudaGetLastError() after the
// launches.
extern "C" int lz4tt_lz4block_index(const void* s, long long len, int n_spans,
                                    void* scratch, int cap, int log,
                                    int max_blocks, int stop, void* table,
                                    long long fs, void* meta, void* order,
                                    void* stream) {
  int32_t* w = (int32_t*)scratch;
  Scratch x;
  x.counts = w;
  x.exact = w + n_spans;
  x.over_span = w + 2LL * n_spans;
  x.over_off = w + 3LL * n_spans;
  x.slots = w + 4LL * n_spans;
  int32_t* c = x.slots + (long long)kSpanSlots * n_spans;
  int32_t** arrays[] = {&x.cand, &x.clen, &x.olen, &x.meth, &x.chk,
                        &x.code, &x.next, &x.link, &x.tail, &x.path};
  for (int32_t** a : arrays) {
    *a = c;
    c += cap;
  }
  x.lift = c;
  cudaStream_t st = (cudaStream_t)stream;
  if (n_spans > 0)
    lz4block_mark_kernel<<<n_spans, 32 * kMarkWarps, 0, st>>>(
        (const uint8_t*)s, len, x.counts, x.exact, x.slots);
  lz4block_chain_kernel<<<1, kChainThreads, 0, st>>>(
      (const uint8_t*)s, len, n_spans, x, cap, log, max_blocks, stop,
      (int32_t*)table, fs, (int32_t*)meta, (int32_t*)order);
  return (int)cudaGetLastError();
}

// Every record of the index (table with field stride fs, n columns) into
// its row of out (uint8[n, out_stride], out_stride >= out_max): out_lens
// the bytes written (a record's original length where its payload decoded
// or was copied, else 0), err its code. Warp w takes record order[w]
// (a permutation of 0..n-1). Returns cudaGetLastError().
extern "C" int lz4tt_lz4block_decode(const void* s, const void* table,
                                     long long fs, const void* order, int n,
                                     void* out, long long out_stride,
                                     int out_max, void* out_lens, void* err,
                                     void* stream) {
  if (n > 0)
    lz4block_decode_kernel<<<(n + kDecWarps - 1) / kDecWarps, 32 * kDecWarps,
                             0, (cudaStream_t)stream>>>(
        (const uint8_t*)s, (const int32_t*)table, fs, (const int32_t*)order,
        n, (uint8_t*)out, out_stride, out_max, (int32_t*)out_lens,
        (int32_t*)err);
  return (int)cudaGetLastError();
}

// err[b] CORRUPTED where record b decoded (OK, out_lens[b] > 0) and
// hashes[b] (K3 of its row) masked to 28 bits is not its check. Returns
// cudaGetLastError().
extern "C" int lz4tt_lz4block_verdict(const void* hashes, const void* table,
                                      long long fs, const void* out_lens,
                                      void* err, int n, void* stream) {
  if (n > 0)
    lz4block_verdict_kernel<<<(n + kVerdictThreads - 1) / kVerdictThreads,
                              kVerdictThreads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)hashes, (const int32_t*)table, fs,
        (const int32_t*)out_lens, (int32_t*)err, n);
  return (int)cudaGetLastError();
}
