// The batched decode of a linked-block frame (lz4 -BD, LZ4F's
// blockLinked): a batch of blocks decoded at once, each against the output
// before it, in two parts.
//
// The walk (lz4tt_lw_walk, a block at a time) reads a block's tokens under
// K1's safe contract (lz4_decode.cuh: dest_cap the frame's block size, the
// last-literals rule, no 0x7E000000 cap on lengths) and writes one record a
// sequence, with offsets relative to the block's output:
//
//   lit_out[k], lit_src[k], lit_len[k]: out[lit_out, +lit_len) =
//                                        comp[lit_src, +lit_len)
//   m_out[k], m_dist[k], m_len[k]:      out[m_out, +m_len) = the match of
//                                        distance m_dist (0: zeros)
//
// A block stored raw is one literal record over its payload. The block's
// history is not known to the walk (it depends on the lengths of the blocks
// before it), so a match that reaches before the block's position 0 is not
// an error there: the walk goes on and reports the farthest such reach.
// K1 with a history of h bytes stops at the first match that reaches past
// h; every sequence the walk reads before it stops precedes its own stop,
// so "the farthest reach > h, else the walk's code" is K1's code, and the
// first error in walk order wins.
//
// The resolve gives each byte of a batch, in frame coordinates (the window
// of w bytes first, then the blocks' output one after another), a node of
// 4 bytes: a byte whose value is known (a window byte, a literal, a byte
// of a null-offset match) holds it with the sign bit set; a byte of a match
// of distance d holds the index of its parent, the periodic source
// base + (x mod d) with base = m_out - d, always an earlier node. Rounds of
// pointer doubling (lz4tt_lr_step: an open node takes its parent's node)
// resolve every node; a node at depth D from a known byte is resolved
// after ceil(log2(D + 1)) synchronous rounds. The rounds run in place: a
// node only ever moves up its chain, so a node read while another thread
// writes it is still its own ancestor or its value, and a round is never
// slower than the synchronous one.
#pragma once

#include "lz4_decode.cuh"

// A walk code besides K1's: a block needs more records than its table has
// (never with sequences.max_seq_for: a sequence but the last takes at
// least 3 compressed bytes).
enum { LZ4TT_LW_TOO_MANY = 3 };

// A literal run and match that write more nodes than this go to the whole
// CTA in the resolve's fill, shorter ones to one thread.
enum { LZ4TT_LR_LONG = 64 };

// The six tables of one block, max_seq entries each.
struct Lz4ttLwTables {
  int32_t *lit_out, *lit_src, *lit_len, *m_out, *m_dist, *m_len;
};

struct Lz4ttLwResult {
  int32_t code, n_seq, out_total, reach;
};

LZ4TT_HD void lz4tt_lw_put(const Lz4ttLwTables& t, int32_t k, int32_t lo,
                           int32_t ls, int32_t ll, int32_t mo, int32_t md,
                           int32_t ml) {
  t.lit_out[k] = lo;
  t.lit_src[k] = ls;
  t.lit_len[k] = ll;
  t.m_out[k] = mo;
  t.m_dist[k] = md;
  t.m_len[k] = ml;
}

// Walk one block of src_end compressed bytes (raw: stored as they are).
// out_total is the output decoded when the walk stopped (K1's out_len).
LZ4TT_HD Lz4ttLwResult lz4tt_lw_walk(const uint8_t* comp, int32_t src_end,
                                     int32_t dest_cap, bool raw,
                                     const Lz4ttLwTables& t, int32_t max_seq) {
  if (raw) {
    if (max_seq < 1) return {LZ4TT_LW_TOO_MANY, 0, 0, 0};
    lz4tt_lw_put(t, 0, 0, 0, src_end, src_end, 0, 0);
    return {LZ4TT_OK, 1, src_end, 0};
  }
  if (dest_cap == 0) {  // K1's rule for an empty output
    const bool ok = src_end == 1 && comp[0] == 0;
    return {ok ? LZ4TT_OK : LZ4TT_ERR_DEST_TOO_SMALL, 0, 0, 0};
  }
  int32_t s = 0, d = 0, n = 0, reach = 0, code = LZ4TT_OK;
  for (;;) {
    // K1's run of 3-byte sequences (no literals, a match of 4-18 bytes),
    // four tokens read at once; no other rule applies this far from both
    // ends
    while (s + 21 <= src_end && (int64_t)d + 80 <= dest_cap &&
           n + 4 <= max_seq) {
      int32_t tk[4], ds[4];
#pragma unroll
      for (int k = 0; k < 4; k++) {
        tk[k] = comp[s + 3 * k];
        ds[k] = (int32_t)comp[s + 3 * k + 1] | ((int32_t)comp[s + 3 * k + 2] << 8);
      }
      int k = 0;
#pragma unroll
      for (; k < 4; k++) {
        if (tk[k] > 14) break;
        const int32_t ml = tk[k] + LZ4TT_MIN_MATCH;
        lz4tt_lw_put(t, n, d, s + 1, 0, d, ds[k], ml);
        if (ds[k] - d > reach) reach = ds[k] - d;
        n++;
        d += ml;
        s += 3;
      }
      if (k < 4) break;
    }
    if (s >= src_end) {
      code = LZ4TT_ERR_MALFORMED;
      break;
    }
    const int32_t token = comp[s];
    s++;
    int64_t lit_len = token >> LZ4TT_ML_BITS;
    if (lit_len == LZ4TT_RUN_MASK) lit_len = lz4tt_read_len_ext(comp, s, src_end, lit_len);
    const int64_t lit_end = (int64_t)d + lit_len;
    const int64_t lit_src_end = (int64_t)s + lit_len;
    if (lit_end > (int64_t)dest_cap - LZ4TT_COPY_LENGTH ||
        lit_src_end > (int64_t)src_end - LZ4TT_COPY_LENGTH) {
      if (lit_end > dest_cap) {
        code = LZ4TT_ERR_DEST_TOO_SMALL;
      } else if (lit_src_end != src_end) {
        code = LZ4TT_ERR_MALFORMED;
      } else if (n >= max_seq) {
        code = LZ4TT_LW_TOO_MANY;
      } else {  // the last literals close the block
        lz4tt_lw_put(t, n, d, s, (int32_t)lit_len, (int32_t)lit_end, 0, 0);
        n++;
        d = (int32_t)lit_end;
      }
      break;
    }
    const int32_t lo = d, ls = s;
    s += (int32_t)lit_len;
    d = (int32_t)lit_end;
    if (s + 2 > src_end) {
      code = LZ4TT_ERR_MALFORMED;
      break;
    }
    const int32_t dist = (int32_t)comp[s] | ((int32_t)comp[s + 1] << 8);
    s += 2;
    int64_t m_len = token & LZ4TT_ML_MASK;
    if (m_len == LZ4TT_ML_MASK) m_len = lz4tt_read_len_ext(comp, s, src_end, m_len);
    m_len += LZ4TT_MIN_MATCH;
    if ((int64_t)d + m_len > dest_cap) {
      code = LZ4TT_ERR_MALFORMED;
      break;
    }
    if (n >= max_seq) {
      code = LZ4TT_LW_TOO_MANY;
      break;
    }
    if (dist - d > reach) reach = dist - d;
    lz4tt_lw_put(t, n, lo, ls, (int32_t)lit_len, d, dist, (int32_t)m_len);
    n++;
    d += (int32_t)m_len;
  }
  return {code, n, d, reach};
}

// A node whose byte is known.
LZ4TT_HD int32_t lz4tt_lr_known(uint32_t byte) {
  return (int32_t)(0x80000000u | byte);
}

// Whether record k writes more than LZ4TT_LR_LONG nodes.
LZ4TT_HD bool lz4tt_lr_long(const Lz4ttLwTables& t, int32_t k) {
  return (int64_t)t.lit_len[k] + t.m_len[k] > LZ4TT_LR_LONG;
}

// The nodes of record k of a block whose output starts at node base; comp
// is the block's row. Its bytes from, from + step, ...
LZ4TT_HD void lz4tt_lr_fill(const uint8_t* comp, const Lz4ttLwTables& t,
                            int32_t k, int32_t* nodes, int64_t base,
                            int32_t from, int32_t step) {
  const int64_t lo = base + t.lit_out[k];
  const int32_t ls = t.lit_src[k], ll = t.lit_len[k];
  for (int32_t x = from; x < ll; x += step)
    nodes[lo + x] = lz4tt_lr_known(comp[ls + x]);
  const int64_t mo = base + t.m_out[k];
  const int32_t md = t.m_dist[k], ml = t.m_len[k];
  if (md == 0) {
    for (int32_t x = from; x < ml; x += step) nodes[mo + x] = lz4tt_lr_known(0);
  } else {
    // byte x of the match is byte (x mod md) of the period before it
    int32_t q = from % md;
    const int32_t adv = step % md;
    for (int32_t x = from; x < ml; x += step) {
      nodes[mo + x] = (int32_t)(mo - md + q);
      q += adv;
      if (q >= md) q -= md;
    }
  }
}

// One round's step of node j, in place; whether it is still open.
LZ4TT_HD bool lz4tt_lr_step(int32_t* nodes, int64_t j) {
  const int32_t v = nodes[j];
  if (v < 0) return false;
  const int32_t w = nodes[v];
  nodes[j] = w;
  return w >= 0;
}
