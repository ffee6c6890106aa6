// K8's per-block body: the pointer-doubling decode of
// lz4_tpu/kernels/gather_decode.py::_decode_one (:127-165), byte for byte,
// written against a block team (parallel_compress.cuh: rank, size, sync,
// add, slot).
//
// Each output byte j < out_len gets a node of 4 bytes. A byte whose value
// is known holds it with the sign bit set (lz4tt_gd_known): a literal byte
// (its source in the compressed row), and a byte no sequence writes (a
// null offset, past the block; 0). A byte of a match of distance d > 0
// holds its parent, base + ((j - base) mod d) with base = m_out - d. The
// JAX function finds each byte's sequence by searchsorted; here each
// sequence writes its own bytes (a thread a sequence, runs past
// LZ4TT_GD_LONG bytes by the whole team), which is the same for the
// parser's tables: in output order, their ranges apart, tails of length 0
// (zero or sentinel offsets). The team writes the entries before the
// first sentinel only (lz4tt_gd_used). Pointers the tables make outside
// the row (never the parser's) are clamped into it, negative ones counted
// from the end first, as the plain version does.
//
// Then rounds of pointer doubling over the open nodes only, kept in a list
// (the match bytes, then those a round leaves open; LZ4TT_GD_BATCH nodes a
// thread at a time, their loads in flight together): an open node takes
// the node of its parent, v = a[a[j]], a known byte or a pointer further
// up its chain. After k synchronous rounds (the JAX function's) a byte is
// known iff its chain to a known byte has at most 2^k - 1 links, so when
// 2^max_depth >= out_len every chain that ends is followed to its end and
// the output is the full resolution. Then the rounds run in place (a node
// only ever moves up its chain, so a node read while another thread writes
// it is still an ancestor, and a round is never slower than the
// synchronous one), at most lz4tt_gd_rounds(out_len) of them. Only a
// smaller max_depth keeps synchronous rounds: every open node's new value
// is computed from the round's start before any is stored. A byte that
// stays open (on or into a cycle of clamped pointers) decodes to 0, as in
// the JAX function; a chain into a byte no sequence writes ends in 0 there
// and here. A null-offset byte is a known 0 here and an unresolved node
// there: its followers decode to 0 either way.
#pragma once

#include "parallel_compress.cuh"

// LONG and HUGE: a sequence writing more nodes goes to a warp, to the
// whole team; BATCH: the open nodes a thread takes at once in a round.
enum { LZ4TT_GD_LONG = 64, LZ4TT_GD_HUGE = 2048, LZ4TT_GD_BATCH = 4 };

// The parser's lit_out/m_out past a row's sequences (sequences.SENTINEL).
constexpr int32_t LZ4TT_GD_SENTINEL = 1 << 30;

// One row of the six tables, each max_seq entries.
struct Lz4ttGdTables {
  const int32_t *lit_out, *lit_src, *lit_len, *m_out, *m_dist, *m_len;
};

// A node that holds byte b.
LZ4TT_HD int32_t lz4tt_gd_known(uint32_t b) {
  return (int32_t)(0x80000000u | (b & 0xFFu));
}

// p as an index of [0, size): counted from the end when negative, then
// clamped.
LZ4TT_HD int32_t lz4tt_gd_clamp(int64_t p, int64_t size) {
  if (p < 0) p += size;
  return (int32_t)(p < 0 ? 0 : p >= size ? size - 1 : p);
}

// ceil(log2(out_len)) + 1: the rounds after which no chain that ends is
// still open (every such chain has fewer than out_len links).
LZ4TT_HD int32_t lz4tt_gd_rounds(int32_t out_len) {
  int32_t k = 0;
  while (k < 31 && (int64_t)1 << k < out_len) k++;
  return k + 1;
}

// Whether max_depth rounds follow every chain that ends: 2^max_depth >=
// out_len, so the rounds may run in place.
LZ4TT_HD bool lz4tt_gd_in_place(int32_t out_len, int32_t max_depth) {
  return max_depth >= 31 || ((int64_t)1 << max_depth) >= out_len;
}

// The nodes (and the output bytes of the literals) of sequence k's bytes
// [from, ..) in steps of step.
LZ4TT_HD void lz4tt_gd_fill(const Lz4ttGdTables& s, int32_t k,
                            const uint8_t* comp, int32_t cmax, int32_t* a,
                            uint8_t* out, int32_t out_len, int32_t from,
                            int32_t step) {
  const int64_t lo = s.lit_out[k], ll = s.lit_len[k], src = s.lit_src[k];
  const int64_t lit_end = lo + ll < out_len ? lo + ll : out_len;
  for (int64_t j = (lo > 0 ? lo : 0) + from; j < lit_end; j += step) {
    const int64_t i = src + (j - lo);
    const uint32_t b = i < 0 ? 0u : comp[i < cmax ? i : cmax - 1];
    a[j] = lz4tt_gd_known(b);
    out[j] = (uint8_t)b;
  }
  const int64_t mo = s.m_out[k], d = s.m_dist[k];
  if (d <= 0) return;
  const int64_t m_end = mo + s.m_len[k] < out_len ? mo + s.m_len[k] : out_len;
  const int64_t base = mo - d, j0 = (mo > 0 ? mo : 0) + from;
  if (j0 >= m_end) return;
  int64_t q = (j0 - base) % d;  // (j - base) mod d, carried from j to j + step
  q += q < 0 ? d : 0;
  const int64_t dq = step % d;
  for (int64_t j = j0; j < m_end; j += step) {
    a[j] = lz4tt_gd_clamp(base + q, out_len);
    q += dq;
    q -= q >= d ? d : 0;
  }
}

// The nodes sequence k writes at most.
LZ4TT_HD int64_t lz4tt_gd_nodes(const Lz4ttGdTables& s, int32_t k) {
  return (int64_t)s.lit_len[k] + (s.m_dist[k] > 0 ? s.m_len[k] : 0);
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

// Int32 words of scratch a team needs: the nodes, two lists of open nodes
// and the synchronous rounds' new values, out_len each, then max_seq.
LZ4TT_HD int64_t lz4tt_gd_team_words(int32_t out_len, int32_t max_seq) {
  return 4 * (int64_t)out_len + max_seq;
}

// Decode one row into out[0, out_len) by the team. comp: the row, cmax
// bytes; scratch: lz4tt_gd_team_words(out_len, max_seq) int32; counters:
// four int32 the team shares.
template <class Team>
LZ4TT_HD void lz4tt_gd_block(const Team& t, const uint8_t* comp, int32_t cmax,
                             const Lz4ttGdTables& s, int32_t max_seq,
                             uint8_t* out, int32_t out_len, int32_t max_depth,
                             int32_t* scratch, int32_t* counters) {
  const int T = t.size(), r = t.rank();
  int32_t* a = scratch;
  int32_t* list0 = a + out_len;
  int32_t* list1 = a + 2 * (int64_t)out_len;
  int32_t* next = a + 3 * (int64_t)out_len;
  int32_t* longs = a + 4 * (int64_t)out_len;  // from the front; huge ones
  int32_t* queue = counters;                   // from the back
  int32_t* open = counters + 1;  // three: a round's, the next, the one after
  const int32_t used = lz4tt_gd_used(s.lit_out, max_seq);
  for (int32_t j = r; j < out_len; j += T) {
    a[j] = lz4tt_gd_known(0);
    out[j] = 0;
  }
  if (r == 0) *queue = open[0] = open[1] = 0;
  t.sync();
  for (int32_t k = r; k < used; k += T) {
    const int64_t nodes = lz4tt_gd_nodes(s, k);
    if (nodes > LZ4TT_GD_HUGE)
      longs[max_seq - 1 - t.add(&open[1], 1)] = k;
    else if (nodes > LZ4TT_GD_LONG)
      longs[t.add(queue, 1)] = k;
    else
      lz4tt_gd_fill(s, k, comp, cmax, a, out, out_len, 0, 1);
  }
  t.sync();
  // the long sequences a warp each, a node a lane; the huge ones by all
  const int32_t n_long = *queue, n_huge = open[1], W = t.warp_size();
  for (int32_t q = r / W; q < n_long; q += T / W)
    lz4tt_gd_fill(s, longs[q], comp, cmax, a, out, out_len, r % W, W);
  for (int32_t q = 0; q < n_huge; q++)
    lz4tt_gd_fill(s, longs[max_seq - 1 - q], comp, cmax, a, out, out_len, r,
                  T);
  t.sync();  // every node written before any thread reads another's
  if (r == 0) open[1] = 0;
  // The open nodes' list. In place, this is also the first round, a tile
  // of BATCH x T nodes at a time in output order: a node's parent (an
  // earlier byte in the parser's tables) is then already as far up its
  // chain as the rounds take it, and most nodes end here.
  const bool in_place = lz4tt_gd_in_place(out_len, max_depth);
  const int32_t rounds = in_place ? lz4tt_gd_rounds(out_len) : max_depth;
  for (int32_t j0 = 0; j0 < out_len; j0 += LZ4TT_GD_BATCH * T) {
    int32_t p[LZ4TT_GD_BATCH], v[LZ4TT_GD_BATCH];
    for (int u = 0; u < LZ4TT_GD_BATCH; u++) {
      const int32_t j = j0 + u * T + r;
      p[u] = j < out_len ? a[j] : -1;  // -1: past the row, like a known byte
    }
    for (int u = 0; u < LZ4TT_GD_BATCH; u++)
      v[u] = in_place && p[u] >= 0 ? a[p[u]] : p[u];
    for (int u = 0; u < LZ4TT_GD_BATCH; u++) {
      const int32_t j = j0 + u * T + r;
      if (p[u] < 0) continue;
      if (in_place) {
        a[j] = v[u];
        if (v[u] < 0) {
          out[j] = (uint8_t)v[u];
          continue;
        }
      }
      list0[t.slot(&open[0])] = j;
    }
    if (in_place) t.sync();
  }
  t.sync();
  int32_t n_open = open[0];
  for (int32_t d = in_place ? 1 : 0, k = 0; d < rounds && n_open > 0;
       d++, k++) {
    const int32_t* src = (k & 1) ? list1 : list0;
    int32_t* dst = (k & 1) ? list0 : list1;
    int32_t* counter = &open[(k + 1) % 3];
    if (r == 0) open[(k + 2) % 3] = 0;  // next round's counter, idle now
    // LZ4TT_GD_BATCH nodes a thread at a time, their loads in flight together
    if (!in_place) {
      for (int32_t i0 = r; i0 < n_open; i0 += LZ4TT_GD_BATCH * T) {
        int32_t j[LZ4TT_GD_BATCH], p[LZ4TT_GD_BATCH];
        for (int u = 0; u < LZ4TT_GD_BATCH; u++)
          j[u] = i0 + u * T < n_open ? src[i0 + u * T] : 0;
        for (int u = 0; u < LZ4TT_GD_BATCH; u++) p[u] = a[j[u]];
        for (int u = 0; u < LZ4TT_GD_BATCH; u++)
          if (i0 + u * T < n_open) next[i0 + u * T] = a[p[u]];
      }
      t.sync();
    }
    for (int32_t i0 = r; i0 < n_open; i0 += LZ4TT_GD_BATCH * T) {
      int32_t j[LZ4TT_GD_BATCH], v[LZ4TT_GD_BATCH];
      for (int u = 0; u < LZ4TT_GD_BATCH; u++)
        j[u] = i0 + u * T < n_open ? src[i0 + u * T] : -1;
      if (in_place) {
        int32_t p[LZ4TT_GD_BATCH];
        for (int u = 0; u < LZ4TT_GD_BATCH; u++) p[u] = j[u] >= 0 ? a[j[u]] : 0;
        for (int u = 0; u < LZ4TT_GD_BATCH; u++) v[u] = j[u] >= 0 ? a[p[u]] : 0;
      } else {
        for (int u = 0; u < LZ4TT_GD_BATCH; u++)
          v[u] = j[u] >= 0 ? next[i0 + u * T] : 0;
      }
      for (int u = 0; u < LZ4TT_GD_BATCH; u++) {
        if (j[u] < 0) continue;
        a[j[u]] = v[u];
        if (v[u] < 0)
          out[j[u]] = (uint8_t)v[u];
        else
          dst[t.slot(counter)] = j[u];
      }
    }
    t.sync();
    n_open = *counter;
  }
  t.sync();  // the counters are free for the next row
}
