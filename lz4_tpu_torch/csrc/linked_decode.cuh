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
// of distance d holds the index of its parent, a byte a multiple of d
// before it, always an earlier node. Rounds of pointer doubling (an open
// node takes its parent's node) resolve every node; a node at depth D from
// a known byte is resolved after ceil(log2(D + 1)) synchronous rounds. The
// rounds run in place: a node only ever moves up its chain, so a node read
// while another thread writes it is still its own ancestor or its value,
// and a round is never slower than the synchronous one.
//
// The resolve (lz4tt_rs_*, below the walk) keeps the nodes of one output
// segment at a time in shared memory, resolves them there in output
// order, and leaves only the chains that leave their segment to rounds.
// Its first design, a node for every byte of the batch in device memory
// and rounds over all of them, lives on in design_variants.py, which
// times it beside this one.
#pragma once

#include "lz4_decode.cuh"

// A walk code besides K1's: a block needs more records than its table has
// (never with sequences.max_seq_for: a sequence but the last takes at
// least 3 compressed bytes).
enum { LZ4TT_LW_TOO_MANY = 3 };

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

// ---------------------------------------------------------------------------
// The resolve by segments (lz4tt_linked_resolve), in five launches.
//
// 1. lz4tt_rs_segment, a CTA a segment of `seg` nodes (a power of two, a
//    multiple of 32; segment g is [g * seg, (g + 1) * seg) of the batch):
//    the segment's nodes in shared memory, from the window and from the
//    records that cover it (found by a team search of block_at and of the
//    block's ascending lit_out). A match byte j of distance d points to
//    bp + ((j - bp) mod d), bp = max(m_out, s0) - d: in the segment where
//    the match starts in it (its bytes all point into the period before
//    its start there, so a run of any length is one hop deep), else into
//    the d bytes before the segment, never more than 65,535 bytes before
//    s0. One pass in output order, a tile of 2 size() nodes at a time
//    with a barrier, follows each node up its chain while it points into
//    the segment: a parent in an earlier tile is final, one in the same tile
//    is followed as far as it has got (in place, as in the rounds). After
//    it each node is known or points before s0 (an exit). Every known byte
//    goes to out from the segment, once; an open node sets its bit in
//    `open` and keeps s0 - exit (1..65,535) in `off`. The segment's exits
//    (its nodes' parents below s0, marked per record as the fill places
//    it, lz4tt_rs_exits) go to `exits`, or'ed in shared memory over the
//    64 KiB before s0 first.
// 2. lz4tt_linked_resolve's count: exits &= open (the open exits: the
//    list), and the open exits a chunk of words.
// 3. init: word_base[w], the open exits before word w (an exit's rank),
//    and the first chunk's positions (below).
// 4. resolve, all CTAs resident (a cooperative launch): the list in
//    chunks of list_cap ranks, in rank (output) order. A chunk's entries
//    take their positions (pos[rank(q) - base] = q) and their exits (s0 -
//    off[q]), each exit once made the index of its own entry or its known
//    byte (lz4tt_rs_entry: a pointer always goes back, to a lower rank, so
//    an earlier chunk's exits are known in out); rounds over the chunk
//    only, in place (lz4tt_rs_round: an entry takes the entry it points
//    to), each thread until its entries are known; each entry's byte to
//    out at its position. A grid barrier between the parts.
//    The rounds are bounded (lz4tt_rs_rounds): a thread's own rounds, then
//    rounds of the whole grid behind barriers, enough for any chain of the
//    chunk; the entries still open after them (none, unless the list is
//    faulty) are counted, and the caller raises.
// 5. finish: every other open node's byte, the byte at its exit (off[j] !=
//    0, not listed), known in out since step 1 or 4. A chain leaves its
//    segment only through exits, and an exit's exit is an exit, so the
//    list is closed under its pointers; every byte is written once.
// ---------------------------------------------------------------------------

enum {
  LZ4TT_RS_REACH = 65536,                    // exits lie within this of s0
  LZ4TT_RS_EXIT_WORDS = LZ4TT_RS_REACH / 32,  // a segment's exits bitmap
  LZ4TT_RS_LONG = 64,  // a record writing more nodes of a segment: the team
  LZ4TT_RS_PROBES = 32,  // a team search's probes a level, at least
  LZ4TT_RS_BYTES = 8,    // literal bytes a thread loads at once
  LZ4TT_RS_BATCH = 8,    // list entries a thread steps at once
};

// A walked batch: tables int32[6, n, max_seq] (lz4tt_lw_*), block b's
// output at w + block_at[b] for b < n_ok, n_nodes = w + block_at[n_ok].
struct Lz4ttRsBatch {
  const uint8_t* comp;
  int64_t comp_stride;
  int32_t* tables;
  int32_t max_seq, n;
  const int32_t* n_seq;
  const int64_t* block_at;
  int32_t n_ok;
  const uint8_t* window;
  int32_t w, n_nodes;
};

// What the resolve writes: out (uint8[n_nodes]); off (uint16[n_nodes]);
// open and exits, bitmaps of ceil(n_nodes / 32) words (exits zeroed before
// step 1, the open exits after step 2); word_base (int32 a word); list and
// pos, a chunk of the open exits' entries and their positions.
struct Lz4ttRsMaps {
  uint8_t* out;
  uint16_t* off;
  uint32_t* open;
  uint32_t* exits;
  int32_t* word_base;
  int32_t* list;
  int32_t* pos;
};

// A segment's shared memory: nodes int32[seg]; exits uint32[EXIT_WORDS]
// over [s0 - REACH, s0); longs int32[size()] (the long records); cnt
// int32[4] (two long-record counts, the open nodes, a search's answer).
struct Lz4ttRsShared {
  int32_t* nodes;
  uint32_t* exits;
  int32_t* longs;
  int32_t* cnt;
};

// A node whose byte is known: the byte with the sign bit set.
LZ4TT_HD int32_t lz4tt_lr_known(uint32_t byte) {
  return (int32_t)(0x80000000u | byte);
}

// Loads and stores of nodes and list entries that other threads write at
// the same time (the card's L1 is not coherent; the compiler must reload).
LZ4TT_HD int32_t lz4tt_rs_load(const int32_t* p) {
  return *(const volatile int32_t*)p;
}
LZ4TT_HD void lz4tt_rs_store(int32_t* p, int32_t v) { *(volatile int32_t*)p = v; }

// The largest k in [a, b) with key[k] <= x, by the team (key ascending,
// key[a] <= x): each level probes max(4 size(), PROBES) evenly spaced keys
// (their loads in flight together) and keeps the bracket that holds x;
// slot: an int32 of the team's.
template <class Team, class K>
LZ4TT_HD int32_t lz4tt_rs_search(const Team& t, const K* key, int32_t a,
                                 int32_t b, int64_t x, int32_t* slot) {
  const int P =
      4 * t.size() > LZ4TT_RS_PROBES ? 4 * t.size() : LZ4TT_RS_PROBES;
  while (b - a > 1) {
    const int32_t step = (int32_t)(((int64_t)b - a + P - 1) / P);
    for (int r = t.rank(); r < P; r += t.size()) {
      const int64_t i = a + (int64_t)r * step;
      if (i >= b) break;
      const int64_t nx = i + step;
      if ((int64_t)key[i] <= x && (nx >= b || (int64_t)key[nx] > x))
        *slot = (int32_t)i;
    }
    t.sync();
    a = *slot;
    t.sync();  // read before the next level writes it
    b = a + step < b ? a + step : b;
  }
  return a;
}

// One record of a block's tables (lz4tt_lw_put's fields); lit past every
// offset: none.
struct Lz4ttRsRec {
  int32_t lit, ls, ll, mo, md, ml;
};

LZ4TT_HD Lz4ttRsRec lz4tt_rs_rec(const Lz4ttLwTables& tb, int32_t k) {
  return {tb.lit_out[k], tb.lit_src[k], tb.lit_len[k],
          tb.m_out[k],   tb.m_dist[k],  tb.m_len[k]};
}

// The nodes of record c of a block (its row src) in the block offsets [lo,
// hi) of a segment starting at s0, the block's byte 0 at frame position
// base; those from + i * step of each clipped run.
LZ4TT_HD void lz4tt_rs_fill(const uint8_t* src, const Lz4ttRsRec& c,
                            int64_t base, int32_t lo, int32_t hi, int32_t s0,
                            int32_t* nodes, int32_t from, int32_t step) {
  int32_t a = c.lit > lo ? c.lit : lo;
  int32_t e = c.lit + c.ll < hi ? c.lit + c.ll : hi;
  const int64_t o = base - s0;  // nodes[o + x]: block offset x's node
  const int32_t ls = c.ls - c.lit;  // src[ls + x]: block offset x's byte
  // LZ4TT_RS_BYTES literal bytes at a time, loaded before any is stored (a
  // byte store may alias them, so the compiler keeps each load behind
  // the store before it)
  for (int32_t x = a + from; x < e; x += LZ4TT_RS_BYTES * step) {
    uint8_t v[LZ4TT_RS_BYTES];
#pragma unroll
    for (int u = 0; u < LZ4TT_RS_BYTES; u++)
      v[u] = x + u * step < e ? src[ls + x + u * step] : 0;
#pragma unroll
    for (int u = 0; u < LZ4TT_RS_BYTES; u++)
      if (x + u * step < e) nodes[o + x + u * step] = lz4tt_lr_known(v[u]);
  }
  a = c.mo > lo ? c.mo : lo;
  e = c.mo + c.ml < hi ? c.mo + c.ml : hi;
  if (a + from >= e) return;
  if (c.md == 0) {
    for (int32_t x = a + from; x < e; x += step) nodes[o + x] = lz4tt_lr_known(0);
    return;
  }
  // byte j (frame) points to bp + ((j - bp) mod md), carried from j to j +
  // step; j - bp <= seg + 65,535
  const int64_t mf = base + c.mo;
  const int64_t bp = (mf > s0 ? mf : s0) - c.md;
  int32_t q = (int32_t)(base + a + from - bp) % c.md;
  const int32_t adv = step % c.md;
  for (int32_t x = a + from; x < e; x += step) {
    nodes[o + x] = (int32_t)(bp + q);
    q += adv;
    if (q >= c.md) q -= c.md;
  }
}

// Bits [lo, hi) of words (bit l in word l >> 5), those in the words from,
// from + step, ... of the range, by atomic ors of the team.
template <class Team>
LZ4TT_HD void lz4tt_rs_mark(const Team& t, uint32_t* words, int32_t lo,
                            int32_t hi, int32_t from, int32_t step) {
  if (lo >= hi) return;
  const int32_t w0 = lo >> 5, w1 = (hi - 1) >> 5;
  for (int32_t w = w0 + from; w <= w1; w += step) {
    uint32_t bits = 0xFFFFFFFFu;
    if (w == w0) bits &= 0xFFFFFFFFu << (lo & 31);
    if (w == w1) bits &= 0xFFFFFFFFu >> (31 - ((hi - 1) & 31));
    t.or_shared(words + w, bits);
  }
}

// The exits of record c in a segment (as lz4tt_rs_fill places its nodes):
// the parents below s0 of its match bytes in [lo, hi), bits of the
// segment's exits bitmap (over [s0 - REACH, s0)). A node whose parent lies
// before s0 is open with that exit, and every other open node's chain
// leaves through such a node, so these are all the segment's exits. Byte
// j's parent is bp + ((j - bp) mod md): the residues of the clipped bytes
// are one or two runs, and those below s0 - bp point before s0.
template <class Team>
LZ4TT_HD void lz4tt_rs_exits(const Team& t, const Lz4ttRsRec& c,
                             int64_t base, int32_t lo, int32_t hi, int32_t s0,
                             uint32_t* exits, int32_t from, int32_t step) {
  const int32_t a = c.mo > lo ? c.mo : lo;
  const int32_t e = c.mo + c.ml < hi ? c.mo + c.ml : hi;
  if (c.md == 0 || a >= e) return;
  const int64_t mf = base + c.mo;
  const int64_t bp = (mf > s0 ? mf : s0) - c.md;
  const int32_t lim = (int32_t)(s0 - bp);  // <= md
  if (lim <= 0) return;
  const int32_t n = e - a, d = c.md;
  const int32_t r0 = (int32_t)(base + a - bp) % d;
  const int32_t at = (int32_t)(bp - (s0 - LZ4TT_RS_REACH));  // residue 0
  int32_t run[4] = {r0, r0 + n, 0, 0};  // residues [r0, r0 + n) mod d
  if (n >= d) {
    run[0] = 0;
    run[1] = d;
  } else if (r0 + n > d) {
    run[1] = d;
    run[3] = r0 + n - d;
  }
  for (int k = 0; k < 4; k += 2)
    lz4tt_rs_mark(t, exits, at + run[k],
                  at + (run[k + 1] < lim ? run[k + 1] : lim), from, step);
}

// The nodes record c writes in [lo, hi).
LZ4TT_HD int32_t lz4tt_rs_nodes(const Lz4ttRsRec& c, int32_t lo, int32_t hi) {
  const int32_t le = c.lit + c.ll, me = c.mo + c.ml;
  const int32_t a = (le < hi ? le : hi) - (c.lit > lo ? c.lit : lo);
  const int32_t b = (me < hi ? me : hi) - (c.mo > lo ? c.mo : lo);
  return (a > 0 ? a : 0) + (b > 0 ? b : 0);
}

// Step 1 for the segment at s0 (a multiple of seg, below n_nodes), by the
// team: rank(), size() (a multiple of 32 on the card), sync(); add(p, v),
// an atomic add in shared memory returning the old value; add_all(p, v),
// *p += v summed over the team (every thread calls it); put_bit(words, j,
// on, valid), bit j of words set to on (every thread, 32 consecutive j a
// warp: the word stored whole where valid); or_shared(p, v) and
// or_global(p, v), atomic ors in shared and device memory. The segment's
// open nodes end in sh.cnt[2] (read after a sync); its exits are marked as
// its records are filled (lz4tt_rs_exits).
template <class Team>
LZ4TT_HD void lz4tt_rs_segment(const Team& t, const Lz4ttRsBatch& bt,
                               const Lz4ttRsMaps& m, int32_t s0, int32_t seg,
                               const Lz4ttRsShared& sh) {
  const int T = t.size(), r = t.rank();
  const int64_t end = (int64_t)s0 + seg;
  const int32_t s1 = end < bt.n_nodes ? (int32_t)end : bt.n_nodes;
  const int32_t L = s1 - s0;
  int32_t* nodes = sh.nodes;
  for (int i = r; i < LZ4TT_RS_EXIT_WORDS; i += T) sh.exits[i] = 0;
  if (r == 0) sh.cnt[0] = sh.cnt[1] = sh.cnt[2] = 0;
  const int32_t wend = s1 < bt.w ? s1 : bt.w;
  for (int32_t j = s0 + r; j < wend; j += T)
    nodes[j - s0] = lz4tt_lr_known(bt.window[j]);
  t.sync();
  // the blocks over [x0, x1), offsets past the window
  const int32_t x0 = (s0 > bt.w ? s0 : bt.w) - bt.w, x1 = s1 - bt.w;
  if (x0 < x1) {
    const int64_t plane = (int64_t)bt.n * bt.max_seq;
    int it = 0;
    for (int32_t b = lz4tt_rs_search(t, bt.block_at, 0, bt.n_ok, x0,
                                     &sh.cnt[3]);
         b < bt.n_ok && bt.block_at[b] < x1; b++) {
      const int64_t at = bt.block_at[b];
      const int32_t lo = x0 > at ? (int32_t)(x0 - at) : 0;
      const int64_t top = bt.block_at[b + 1] - at;
      const int32_t hi = x1 - at < top ? (int32_t)(x1 - at) : (int32_t)top;
      if (lo >= hi) continue;
      int32_t* row = bt.tables + (int64_t)b * bt.max_seq;
      const Lz4ttLwTables tb = {row,             row + plane,
                                row + 2 * plane, row + 3 * plane,
                                row + 4 * plane, row + 5 * plane};
      const int32_t ns = bt.n_seq[b];
      const uint8_t* src = bt.comp + b * bt.comp_stride;
      const int64_t base = bt.w + at;
      const int32_t k0 =
          lo == 0 ? 0 : lz4tt_rs_search(t, tb.lit_out, 0, ns, lo, &sh.cnt[3]);
      // size() records at a time: a thread each, the long ones by the team;
      // the next size() records' loads issued before this chunk's fill
      const Lz4ttRsRec none = {INT32_MAX, 0, 0, 0, 0, 0};
      Lz4ttRsRec cur = k0 + r < ns ? lz4tt_rs_rec(tb, k0 + r) : none;
      for (int32_t kk = k0;; kk += T) {
        int32_t* n_long = &sh.cnt[it & 1];
        // the next chunk's count: whoever still reads it read a 0 (below)
        if (r == 0) sh.cnt[(it + 1) & 1] = 0;
        const bool more = (int64_t)kk + T < ns && tb.lit_out[kk + T] < hi;
        const Lz4ttRsRec nxt =
            (int64_t)kk + T + r < ns ? lz4tt_rs_rec(tb, kk + T + r) : none;
        if (cur.lit < hi) {
          if (lz4tt_rs_nodes(cur, lo, hi) > LZ4TT_RS_LONG) {
            sh.longs[t.add(n_long, 1)] = kk + r;
          } else {
            lz4tt_rs_fill(src, cur, base, lo, hi, s0, nodes, 0, 1);
            lz4tt_rs_exits(t, cur, base, lo, hi, s0, sh.exits, 0, 1);
          }
        }
        t.sync();
        const int32_t nl = *n_long;
        if (nl) {  // the same for the whole team
          for (int32_t q = 0; q < nl; q++) {
            const Lz4ttRsRec c = lz4tt_rs_rec(tb, sh.longs[q]);
            lz4tt_rs_fill(src, c, base, lo, hi, s0, nodes, r, T);
            lz4tt_rs_exits(t, c, base, lo, hi, s0, sh.exits, r, T);
          }
          t.sync();  // the longs read before the next chunk writes them
        }
        it++;
        cur = nxt;
        if (!more) break;
      }
    }
  }
  t.sync();
  // the pass in output order, a tile of 2 T nodes at a time (a thread's
  // two in order)
  for (int32_t t0 = 0; t0 < L; t0 += 2 * T) {
    for (int32_t i = t0 + r; i < t0 + 2 * T && i < L; i += T) {
      int32_t p = nodes[i];
      while (p >= s0) p = lz4tt_rs_load(nodes + (p - s0));
      lz4tt_rs_store(nodes + i, p);
    }
    t.sync();
  }
  // known bytes to out; open nodes, their offsets and exits; size() nodes
  // a step (whole warps: a warp's 32 nodes are one word of the bitmaps)
  int32_t n_open = 0;
  for (int32_t i0 = 0; i0 < L; i0 += T) {
    const int32_t i = i0 + r, j = s0 + i;
    const int32_t v = i < L ? nodes[i] : -1;
    if (v >= 0) {
      m.off[j] = (uint16_t)(s0 - v);
      n_open++;
    } else if (i < L) {
      m.out[j] = (uint8_t)v;
      m.off[j] = 0;
    }
    t.put_bit(m.open, j, v >= 0, (j & ~31) < s1);
  }
  t.add_all(&sh.cnt[2], n_open);
  t.sync();
  const int32_t g0 = (s0 >> 5) - LZ4TT_RS_EXIT_WORDS;
  for (int i = r; i < LZ4TT_RS_EXIT_WORDS; i += T)
    if (sh.exits[i]) t.or_global(&m.exits[g0 + i], sh.exits[i]);
}

// The list entry of open exit p (rank among the open exits).
LZ4TT_HD int32_t lz4tt_rs_rank(const Lz4ttRsMaps& m, int32_t p) {
  return m.word_base[p >> 5] +
         lz4tt_popc(m.exits[p >> 5] & ((1u << (p & 31)) - 1u));
}

LZ4TT_HD bool lz4tt_rs_listed(const Lz4ttRsMaps& m, int32_t p) {
  return (m.exits[p >> 5] >> (p & 31)) & 1u;
}

// Where exit p's value is while the list holds the open exits of ranks
// [base, base + its length): its list entry, or -1 (its byte is in out).
LZ4TT_HD int32_t lz4tt_rs_where(const Lz4ttRsMaps& m, int32_t p,
                                int32_t base) {
  return lz4tt_rs_listed(m, p) ? lz4tt_rs_rank(m, p) - base : -1;
}

// The list entry of exit p while the list holds the open exits of ranks
// [base, base + its length): the index of p's own entry where p is listed
// there (always below the index of the entry that points to p: exits lie
// before their nodes), else p's known byte from out (p resolved in its
// segment, or in an earlier chunk of the list).
LZ4TT_HD int32_t lz4tt_rs_entry(const Lz4ttRsMaps& m, int32_t p,
                                int32_t base) {
  const int32_t k = lz4tt_rs_where(m, p, base);
  return k >= 0 ? k : lz4tt_lr_known(m.out[p]);
}

// One round of a thread's list entries (i = me, me + lanes, ... below
// len) in place, LZ4TT_RS_BATCH at a time with their loads in flight
// together: an open entry (the index of an earlier one) takes that entry,
// known or an index further back. An index at or past its own (no correct
// list has one) is kept as it is, open. Returns the entries it leaves
// open.
LZ4TT_HD int32_t lz4tt_rs_round(const Lz4ttRsMaps& m, int64_t me,
                                int64_t lanes, int32_t len) {
  int32_t left = 0;
  for (int64_t i0 = me; i0 < len; i0 += LZ4TT_RS_BATCH * lanes) {
    int32_t v[LZ4TT_RS_BATCH];
#pragma unroll
    for (int u = 0; u < LZ4TT_RS_BATCH; u++) {
      const int64_t i = i0 + u * lanes;
      v[u] = i < len ? lz4tt_rs_load(m.list + i) : -1;
    }
#pragma unroll
    for (int u = 0; u < LZ4TT_RS_BATCH; u++) {
      const int64_t i = i0 + u * lanes;
      if (v[u] >= 0) {  // open: a known entry stays as it is
        if (v[u] < i) v[u] = lz4tt_rs_load(m.list + v[u]);
        lz4tt_rs_store(m.list + i, v[u]);
        left += v[u] >= 0;
      }
    }
  }
  return left;
}

// Synchronous rounds that resolve any chain of up to len list entries
// (ceil(log2(len + 1)), a chain's end being a known byte) or more.
LZ4TT_HD int32_t lz4tt_rs_rounds_for(int32_t len) {
  int32_t r = 1;
  for (int64_t span = 1; span < len; span <<= 1) r++;
  return r;
}

// Step 4's rounds over a chunk of the list (len entries, lz4tt_rs_entry's)
// by the grid g: rank(), size(), leader(), sync() (a barrier of
// every thread, memory included) and add_all(p, v) (*p += v summed over
// the grid), every thread of it calling. Each thread steps its own entries
// until they are known, for up to `own` rounds; then, while any entry of
// the chunk is open, every thread steps its entries once a round with a
// barrier between rounds, for up to lz4tt_rs_rounds_for(len) rounds: the
// rounds in place are never slower than synchronous ones, so these end
// every chain of a correct list. tally: three int32 of the grid's, the
// open entries' sums, tally[turn % 3] zero when called; turn goes on from
// one call to the next. Returns the entries left open (0 unless the list
// is faulty), the same on every thread; rounds: this thread's.
template <class Grid>
LZ4TT_HD int32_t lz4tt_rs_rounds(const Grid& g, const Lz4ttRsMaps& m,
                                 int32_t len, int32_t own, int32_t* tally,
                                 int32_t& turn, int32_t& rounds) {
  const int64_t me = g.rank(), lanes = g.size();
  int32_t left = me < len ? 1 : 0;
  rounds = 0;
  while (left && rounds < own) {
    left = lz4tt_rs_round(m, me, lanes, len);
    rounds++;
  }
  const int32_t most = lz4tt_rs_rounds_for(len);
  for (int32_t r = 0;; r++) {
    // the slot after this one was last read before the barrier of the
    // turn before; it is zeroed before the barrier its adds follow
    g.add_all(tally + turn % 3, left);
    if (g.leader()) tally[(turn + 1) % 3] = 0;
    g.sync();
    const int32_t open = lz4tt_rs_load(tally + turn % 3);
    turn++;
    if (!open || r == most) return open;
    left = lz4tt_rs_round(m, me, lanes, len);
    rounds++;
  }
}

// The open exits of word w whose ranks lie in [base, base + len): a mask.
LZ4TT_HD uint32_t lz4tt_rs_in_chunk(const Lz4ttRsMaps& m, int64_t w,
                                    int32_t base, int32_t len) {
  uint32_t bits = m.exits[w];
  int32_t k = m.word_base[w];
  const int32_t end = k + lz4tt_popc(bits);
  if (!bits || k >= base + len || end <= base) return 0;
  if (k >= base && end <= base + len) return bits;
  uint32_t mask = 0;
  for (; bits; bits &= bits - 1, k++)
    if (k >= base && k < base + len) mask |= bits & (~bits + 1u);
  return mask;
}

// The exit of open node j: s0 - off[j].
LZ4TT_HD int32_t lz4tt_rs_exit(const Lz4ttRsMaps& m, int32_t j, int32_t seg) {
  return (j & ~(seg - 1)) - m.off[j];
}
