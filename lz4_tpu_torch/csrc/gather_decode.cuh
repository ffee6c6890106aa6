// K8's per-block body: the pointer-doubling decode of
// lz4_tpu/kernels/gather_decode.py::_decode_one (:127-165), byte for byte,
// written against a block team (parallel_compress.cuh: rank, size, sync,
// any, add).
//
// Each output byte j < out_len gets a node (idx, par): a literal byte its
// source in the compressed row and itself as parent; a byte of a match of
// distance d > 0 idx -1 and the periodic parent base + ((j - base) mod d),
// base = m_out - d; any other byte (a null offset, past the block) idx -1
// and itself. The JAX function finds each byte's sequence by searchsorted;
// here each sequence writes its own bytes (a thread a sequence, runs past
// LZ4TT_GD_LONG bytes by the whole team), which is the same for the
// parser's tables: in output order, their ranges apart, tails of length 0
// (zero or sentinel offsets). The team writes the entries before the
// first sentinel only (lz4tt_gd_used): the parser's sentinel tails come
// after its sequences and write nothing, and tables with zero tails are
// walked to max_seq.
//
// Then rounds, while a byte is unresolved (idx < 0, par != j) and fewer
// than max_depth have run, each synchronous: idx = idx >= 0 ? idx :
// idx[par], par = par[par], from one buffer into the other. A resolved
// byte only copies its node: no byte reads the parent of a resolved one
// and stays unresolved, so its parent never matters. Last, out[j] =
// comp[idx], or 0 where unresolved. Pointers the tables make outside the
// row (never the parser's) are clamped into it, negative ones counted from
// the end first, as the plain version does.
#pragma once

#include "parallel_compress.cuh"

enum { LZ4TT_GD_LONG = 64 };

// The parser's lit_out/m_out past a row's sequences (sequences.SENTINEL).
constexpr int32_t LZ4TT_GD_SENTINEL = 1 << 30;

struct alignas(8) Lz4ttGdNode {
  int32_t idx, par;
};

// One row of the six tables, each max_seq entries.
struct Lz4ttGdTables {
  const int32_t *lit_out, *lit_src, *lit_len, *m_out, *m_dist, *m_len;
};

// p as an index of [0, size): counted from the end when negative, then
// clamped.
LZ4TT_HD int32_t lz4tt_gd_clamp(int64_t p, int64_t size) {
  if (p < 0) p += size;
  return (int32_t)(p < 0 ? 0 : p >= size ? size - 1 : p);
}

// The nodes of sequence k's bytes [from, ..) in steps of step.
LZ4TT_HD void lz4tt_gd_fill(const Lz4ttGdTables& s, int32_t k,
                            Lz4ttGdNode* a, int32_t out_len, int32_t from,
                            int32_t step) {
  const int64_t lo = s.lit_out[k], ll = s.lit_len[k], src = s.lit_src[k];
  const int64_t lit_end = lo + ll < out_len ? lo + ll : out_len;
  for (int64_t j = (lo > 0 ? lo : 0) + from; j < lit_end; j += step)
    a[j] = {(int32_t)(src + (j - lo)), (int32_t)j};
  const int64_t mo = s.m_out[k], d = s.m_dist[k];
  if (d <= 0) return;
  const int64_t m_end = mo + s.m_len[k] < out_len ? mo + s.m_len[k] : out_len;
  const int64_t base = mo - d;
  for (int64_t j = (mo > 0 ? mo : 0) + from; j < m_end; j += step) {
    int64_t q = (j - base) % d;
    q += q < 0 ? d : 0;
    a[j] = {-1, lz4tt_gd_clamp(base + q, out_len)};
  }
}

// Whether sequence k writes more than LZ4TT_GD_LONG nodes.
LZ4TT_HD bool lz4tt_gd_long(const Lz4ttGdTables& s, int32_t k) {
  return (int64_t)s.lit_len[k] + (s.m_dist[k] > 0 ? s.m_len[k] : 0) >
         LZ4TT_GD_LONG;
}

// The entries of a row before its first sentinel (max_seq when it has
// none): a binary search, since lit_out is in output order and the
// sentinels close it.
LZ4TT_HD int32_t lz4tt_gd_used(const int32_t* lit_out, int32_t max_seq) {
  int32_t lo = 0, hi = max_seq;
  while (lo < hi) {
    const int32_t mid = lo + (hi - lo) / 2;
    if (lit_out[mid] >= LZ4TT_GD_SENTINEL)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Decode one row into out[0, out_len) by the team. comp: the row, cmax
// bytes; a, b: out_len nodes each; longs: max_seq int32; queue: one int32
// the team shares.
template <class Team>
LZ4TT_HD void lz4tt_gd_block(const Team& t, const uint8_t* comp, int32_t cmax,
                             const Lz4ttGdTables& s, int32_t max_seq,
                             uint8_t* out, int32_t out_len, int32_t max_depth,
                             Lz4ttGdNode* a, Lz4ttGdNode* b, int32_t* longs,
                             int32_t* queue) {
  const int T = t.size(), r = t.rank();
  const int32_t used = lz4tt_gd_used(s.lit_out, max_seq);
  for (int32_t j = r; j < out_len; j += T) a[j] = {-1, j};
  if (r == 0) *queue = 0;
  t.sync();
  for (int32_t k = r; k < used; k += T) {
    if (lz4tt_gd_long(s, k))
      longs[t.add(queue, 1)] = k;
    else
      lz4tt_gd_fill(s, k, a, out_len, 0, 1);
  }
  t.sync();
  const int32_t n_long = *queue;
  for (int32_t q = 0; q < n_long; q++)
    lz4tt_gd_fill(s, longs[q], a, out_len, r, T);
  t.sync();  // every node written before any thread reads another's
  bool mine = false;
  for (int32_t j = r; j < out_len; j += T)
    mine |= a[j].idx < 0 && a[j].par != j;
  bool open = t.any(mine);
  for (int32_t depth = 0; depth < max_depth && open; depth++) {
    mine = false;
    for (int32_t j = r; j < out_len; j += T) {
      Lz4ttGdNode v = a[j];
      if (v.idx < 0) v = a[v.par];
      b[j] = v;
      mine |= v.idx < 0 && v.par != j;
    }
    Lz4ttGdNode* swap = a;
    a = b;
    b = swap;
    open = t.any(mine);
  }
  for (int32_t j = r; j < out_len; j += T) {
    const int32_t i = a[j].idx;
    out[j] = i >= 0 ? comp[i < cmax ? i : cmax - 1] : 0;
  }
  t.sync();
}
