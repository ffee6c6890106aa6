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

// A walk code of a chunk of a block (the chunked walk below): it reached a
// token start at or past its limit, where the next chunk goes on.
enum { LZ4TT_LW_GOES_ON = -1 };

// Walk a block of src_end compressed bytes from the token start s, with d
// bytes of output and n records before it, until it stops or reaches a
// token start at or past limit (LZ4TT_LW_GOES_ON; limit src_end + 1: to
// its end). out_total is the output decoded when the walk stopped (K1's
// out_len); reach counts this walk's records only.
LZ4TT_HD Lz4ttLwResult lz4tt_lw_walk_from(const uint8_t* comp, int32_t src_end,
                                          int32_t dest_cap,
                                          const Lz4ttLwTables& t,
                                          int32_t max_seq, int32_t s,
                                          int32_t d, int32_t n, int32_t limit) {
  int32_t reach = 0, code = LZ4TT_OK;
  for (;;) {
    // K1's run of 3-byte sequences (no literals, a match of 4-18 bytes),
    // four tokens read at once; no other rule applies this far from both
    // ends
    while (s + 21 <= src_end && s + 10 <= limit &&
           (int64_t)d + 80 <= dest_cap && n + 4 <= max_seq) {
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
    if (s >= limit) {
      code = LZ4TT_LW_GOES_ON;
      break;
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

// Walk one block of src_end compressed bytes (raw: stored as they are).
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
  return lz4tt_lw_walk_from(comp, src_end, dest_cap, t, max_seq, 0, 0, 0,
                            src_end + 1);
}

// ---------------------------------------------------------------------------
// The chunked walk: a long block's walk in parallel, exactly.
//
// The rules of the walk that depend on d (the output position: dest_cap,
// the last-literals rule's dest_cap - 8) or on n (max_seq) can only stop
// it, never send it to another token. So the token starts a walk visits
// from an offset are a function of the offset alone. A block is cut into
// chunks of `chunk` compressed bytes; for every offset i of a chunk but
// the block's last, lz4tt_lw_tables writes
//
//   exit(i): the first token start at or past the chunk's end on the path
//            from i, or LZ4TT_LW_STOP where the path stops first by a rule
//            that does not depend on d or n (the literal run within
//            LZ4TT_COPY_LENGTH of src_end, a truncated offset);
//   cnt(i), out(i): the records and output bytes of the path up to exit
//            (out saturated at INT32_MAX, past any dest_cap that matters);
//
// by one backward pass (exit(i) = exit(next(i))), a team's window of
// offsets at a time; inside a run of 0xFF length bytes the run's end is
// carried back too, so that no offset reads the run again. lz4tt_lw_hops
// then follows a block's chunk entries (entry(c + 1) = exit(entry(c)))
// with running record and output counts, and each chunk walks from its
// true entry with its true d and n
// (lz4tt_lw_walk_from, every rule applied) up to the next chunk's first
// token. The first chunk that stops gives the block's code, n_seq and
// out_total; chunks after it (their counts past a stop that depended on
// d) are ignored, and the block's reach is the largest of its chunks' up
// to that one (lz4tt_lw_finish). A block of one chunk is the walk above.
// ---------------------------------------------------------------------------

enum { LZ4TT_LW_STOP = -1 };
// The bytes past a chunk that its tables pass keeps beside the chunk's
// own, and the offsets of the tables it keeps at hand (a ring).
enum { LZ4TT_LW_MARGIN = 64, LZ4TT_LW_RING = 256 };

// The bytes of a block as a chunk's tables pass reads them: positions in
// [c0, hi) from the team's copy (stage), the rest in place.
struct Lz4ttLwBytes {
  const uint8_t* comp;
  const uint8_t* stage;
  int32_t c0, hi;
  LZ4TT_HD uint32_t operator[](int32_t p) const {
    return p < hi ? stage[p - c0] : comp[p];
  }
};

// The first byte at or past p that is not 0xFF, or src_end; read directly.
LZ4TT_HD int32_t lz4tt_lw_ff_scan(const uint8_t* comp, int32_t p,
                                  int32_t src_end) {
  while (p + 4 <= src_end && lz4tt_read32(comp, p) == 0xFFFFFFFFu) p += 4;
  while (p < src_end && comp[p] == 0xFF) p++;
  return p;
}

// Where a chunk's tables pass find the end of a run of 0xFF bytes: ff16[j]
// the offset past chunk start c0 of the first byte at or after c0 + j that
// is not 0xFF, `chunk` where that lies past the chunk (then ffe: the first
// at or past c1, or src_end).
struct Lz4ttLwFF {
  const uint8_t* comp;
  const uint16_t* ff16;
  int32_t c0, c1, ffe, src_end, chunk;
  LZ4TT_HD int32_t operator()(int32_t p) const {
    if (p < c1) {
      const int32_t v = ff16[p - c0];
      return v == chunk ? ffe : c0 + v;
    }
    return p < ffe ? ffe : lz4tt_lw_ff_scan(comp, p, src_end);
  }
};

// A length's extension from s (the walk's lz4tt_read_len_ext), with the
// first byte at or past s that is not 0xFF found by ff.
template <class B, class FF>
LZ4TT_HD int64_t lz4tt_lw_ext(const B& by, int32_t& s, int32_t src_end,
                              const FF& ff) {
  const int32_t k = ff(s);
  if (k < src_end) {
    const int64_t v = 255 * (int64_t)(k - s) + by[k];
    s = k + 1;
    return v;
  }
  const int64_t v = 255 * (int64_t)(src_end - s) + 255;
  s = src_end;
  return v;
}

// The token at i < src_end by the walk's grammar without the rules on d
// and n: the next token start and the output of its record, or a stop.
struct Lz4ttLwStep {
  int32_t next, out;
  bool stop;
};

template <class B, class FF>
LZ4TT_HD Lz4ttLwStep lz4tt_lw_step(const B& by, int32_t i, int32_t src_end,
                                   const FF& ff) {
  const int32_t token = by[i];
  int32_t s = i + 1;
  int64_t lit = token >> LZ4TT_ML_BITS;
  if (lit == LZ4TT_RUN_MASK) lit += lz4tt_lw_ext(by, s, src_end, ff);
  if ((int64_t)s + lit > (int64_t)src_end - LZ4TT_COPY_LENGTH) return {0, 0, true};
  s += (int32_t)lit;
  if (s + 2 > src_end) return {0, 0, true};
  s += 2;
  int64_t ml = token & LZ4TT_ML_MASK;
  if (ml == LZ4TT_ML_MASK) ml += lz4tt_lw_ext(by, s, src_end, ff);
  const int64_t out = lit + ml + LZ4TT_MIN_MATCH;
  return {s, out > INT32_MAX ? INT32_MAX : (int32_t)out, false};
}

LZ4TT_HD int32_t lz4tt_lw_sat(int64_t v) {
  return v > INT32_MAX ? INT32_MAX : (int32_t)v;
}

// dst[0, n) = src[0, n) by the team: 16-byte copies where both are
// 16-byte aligned, else bytes; then a sync.
template <class Team>
LZ4TT_HD void lz4tt_lw_stage(const Team& t, const uint8_t* src, int32_t n,
                             uint8_t* dst) {
  int32_t done = 0;
  if (((((uintptr_t)src) | ((uintptr_t)dst)) & 15) == 0) {
    done = n & ~15;
    for (int32_t j = 16 * t.lane(); j < done; j += 16 * t.size())
      lz4tt_store16(dst + j, src + j);
  }
  for (int32_t j = done + t.lane(); j < n; j += t.size()) dst[j] = src[j];
  t.sync();
}

// A team's own memory for a chunk's tables pass: ff16 (uint16[chunk]),
// stage (uint8[chunk + LZ4TT_LW_MARGIN]: the chunk's bytes and those after
// it) and ring (int32[3 * LZ4TT_LW_RING]: the tables of the last offsets
// written; null where the tables themselves are at hand).
struct Lz4ttLwScratch {
  uint16_t* ff16;
  uint8_t* stage;
  int32_t* ring;
};

// The exit tables of the chunk [c0, c1) of a block of src_end > c1 bytes:
// tab, int32[3 * (c1 - c0)], offset i's exit, cnt and out at 3 * (i - c0).
// The team copies the chunk's bytes to its stage, then takes size()
// offsets a step, from the chunk's end back: each lane parses its
// offset's token; a token that ends past the step's offsets takes its
// exit from the tables written before (the ring for the last
// LZ4TT_LW_RING offsets), one that ends inside them from its lane, by
// pointer jumping over shuffles. The tables are read back by the team's
// lanes after a sync.
template <class Team>
LZ4TT_HD void lz4tt_lw_tables(const Team& t, const uint8_t* comp,
                              int32_t src_end, int32_t c0, int32_t c1,
                              int32_t* tab, const Lz4ttLwScratch& sc) {
  const int P = t.size(), lane = t.lane();
  const int32_t chunk = c1 - c0;
  const int32_t hi =
      c1 + LZ4TT_LW_MARGIN < src_end ? c1 + LZ4TT_LW_MARGIN : src_end;
  lz4tt_lw_stage(t, comp + c0, hi - c0, sc.stage);
  const Lz4ttLwBytes by = {comp, sc.stage, c0, hi};
  // the first byte at or past c1 that is not 0xFF (a long run's end)
  int32_t ffe = c1;
  for (;;) {
    const int32_t p = ffe + lane;
    const unsigned m = t.ballot(p >= src_end || by[p] != 0xFF);
    if (m) {
      ffe += lz4tt_ffs(m) - 1;
      break;
    }
    ffe += P;
  }
  if (ffe > src_end) ffe = src_end;
  const Lz4ttLwFF ff = {comp, sc.ff16, c0, c1, ffe, src_end, chunk};
  int32_t carry = chunk;  // ff16 of the offset after the step's offsets
  for (int32_t top = c1; top > c0; top -= P) {
    const int32_t i0 = top - P, i = i0 + lane;
    const bool valid = i >= c0;
    // the ends of 0xFF runs over the step's offsets
    const unsigned hit = t.ballot(valid && by[i] != 0xFF);
    const unsigned above = hit >> lane;
    const int32_t f = above ? i + lz4tt_ffs(above) - 1 - c0 : carry;
    if (valid) sc.ff16[i - c0] = (uint16_t)f;
    carry = t.shfl(f, 0);
    t.sync();
    const Lz4ttLwStep st = valid ? lz4tt_lw_step(by, i, src_end, ff)
                                 : Lz4ttLwStep{0, 0, true};
    // x: the exit where the path leaves the step's offsets (at or past
    // top, or LZ4TT_LW_STOP), else the next token start inside them (in
    // [max(i0, c0), top)); n and o count the path from i up to x
    int32_t x = LZ4TT_LW_STOP, n = 1, o = st.out;
    if (!st.stop) {
      x = st.next;
      if (x >= top && x < c1) {
        const int32_t* y = sc.ring != nullptr && x < top + LZ4TT_LW_RING
                               ? sc.ring + 3 * ((x - c0) & (LZ4TT_LW_RING - 1))
                               : tab + 3 * (x - c0);
        const int32_t ye = y[0];
        if (ye != LZ4TT_LW_STOP) {
          n += y[1];
          o = lz4tt_lw_sat((int64_t)o + y[2]);
        }
        x = ye;
      }
    }
    for (;;) {
      const bool inside = x >= c0 && x >= i0 && x < top;
      if (!t.ballot(inside)) break;
      const int src = inside ? x - i0 : lane;
      const int32_t sx = t.shfl(x, src), sn = t.shfl(n, src),
                    so = t.shfl(o, src);
      if (inside) {
        n += sn;
        o = lz4tt_lw_sat((int64_t)o + so);
        x = sx;
      }
    }
    const int32_t e = x;
    if (valid) {
      int32_t* x = tab + 3 * (i - c0);
      x[0] = e;
      x[1] = n;
      x[2] = o;
      if (sc.ring != nullptr) {
        x = sc.ring + 3 * ((i - c0) & (LZ4TT_LW_RING - 1));
        x[0] = e;
        x[1] = n;
        x[2] = o;
      }
    }
    t.sync();
  }
}

// A block's chunk entries from its chunks' tables (chunk c < nc - 1 at
// tab + 3 * chunk * c, lz4tt_lw_tables'): ent[c] the first token start of
// the walk's path in chunk c (-1: none starts there, or the path stopped
// before it), n0[c] and d0[c] the records and output before it (d0
// saturated at INT32_MAX). The last chunk takes the path's token start
// past the one before, whatever it is.
LZ4TT_HD void lz4tt_lw_hops(int32_t nc, int32_t chunk, const int32_t* tab,
                            int32_t* ent, int32_t* n0, int32_t* d0) {
  int32_t e = 0, n = 0;
  int64_t d = 0;
  bool alive = true;
  for (int32_t c = 0; c < nc; c++) {
    const int32_t c0 = c * chunk, c1 = c0 + chunk;
    n0[c] = n;
    d0[c] = lz4tt_lw_sat(d);
    if (!alive || (c < nc - 1 && e >= c1)) {
      ent[c] = -1;
      continue;
    }
    ent[c] = e;
    if (c == nc - 1) break;
    const int32_t* x = tab + (int64_t)3 * chunk * c + 3 * (e - c0);
    const int32_t ex = x[0], cn = x[1], ou = x[2];
    if (ex == LZ4TT_LW_STOP) {
      alive = false;
    } else {
      n += cn;
      d += ou;
      e = ex;
    }
  }
}

// Chunk c of nc of a block, from its entry (lz4tt_lw_hops): its walk up to
// the next chunk's first token, or the whole block's walk when nc is 1.
LZ4TT_HD Lz4ttLwResult lz4tt_lw_chunk(const uint8_t* comp, int32_t src_end,
                                      int32_t dest_cap, bool raw,
                                      const Lz4ttLwTables& t, int32_t max_seq,
                                      int32_t c, int32_t nc, int32_t chunk,
                                      int32_t ent, int32_t n0, int32_t d0) {
  if (nc == 1) return lz4tt_lw_walk(comp, src_end, dest_cap, raw, t, max_seq);
  if (ent < 0) return {LZ4TT_LW_GOES_ON, 0, 0, 0};
  const int32_t limit = c == nc - 1 ? src_end + 1 : (c + 1) * chunk;
  return lz4tt_lw_walk_from(comp, src_end, dest_cap, t, max_seq, ent, d0, n0,
                            limit);
}

// The block's result from its chunks' (code, n, d, reach each int32[nc]):
// the first chunk that stopped, and the largest reach up to it.
LZ4TT_HD Lz4ttLwResult lz4tt_lw_finish(int32_t nc, const int32_t* code,
                                       const int32_t* n, const int32_t* d,
                                       const int32_t* reach) {
  int32_t r = 0;
  for (int32_t c = 0; c < nc; c++) {
    if (reach[c] > r) r = reach[c];
    if (code[c] != LZ4TT_LW_GOES_ON) return {code[c], n[c], d[c], r};
  }
  return {LZ4TT_ERR_MALFORMED, 0, 0, r};  // not reached: the last chunk stops
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
