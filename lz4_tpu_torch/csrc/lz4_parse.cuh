// The LZ4 sequence parser of one block: the token walk of
// lz4_tpu/native/src/tpulz4.cpp::tpulz4_parse_sequences (:1683-1763), which
// emits one record per sequence with absolute offsets and copies nothing:
//
//   lit_out[k], lit_src[k], lit_len[k]: out[lit_out, +lit_len) =
//                                        comp[lit_src, +lit_len)
//   m_out[k], m_dist[k], m_len[k]:      out[m_out, +m_len) = the match of
//                                        distance m_dist
//
// Its rules, which are not K1's:
//   - a length extension reaching 0x7E000000 is malformed;
//   - a literal run past the end of the block is malformed; literals that
//     end exactly at the end close the block (a literals-only sequence);
//   - a match offset cut off, or reaching before the output start
//     (d - dist < 0), is malformed;
//   - a null offset gives a zero-length match (m_dist 0, m_len 0) that
//     still advances the output cursor: its bytes stay as they are;
//   - there is no last-literals rule and no output bound: the caller
//     compares out_total with its output size.
// The result is the number of sequences, or LZ4TT_PARSE_MALFORMED, or
// LZ4TT_PARSE_TOO_MANY when a block needs more than max_seq of them (the
// codes of tpulz4.cpp:99-100). A sequence that fails after its literal
// run was checked keeps its three literal entries, as in the serial walk.
//
// The walk is serial, but compressible data is mostly one kind of
// sequence: no literals, a match of 4-18 bytes (a token of at most 14) and
// a 2-byte offset, 3 bytes in all (99.6 % of the main path's alphabet-4
// sequences). So a team (lz4tt_common.cuh) takes team.size() of them a
// step (lz4tt_parse_run): lane k reads the 3 bytes at s + 3k, a ballot
// finds the first lane that is not such a sequence, a scan of the match
// lengths gives each lane its output position, a second ballot the first
// lane whose match reaches before the output start, and the lanes before
// both write their records, each table with one coalesced store. Where
// the run stops, the chain (lz4tt_parse_chain) takes the short sequences
// (no length extension: most of text's) that start in the next
// team.size() bytes: lane k reads the one that would start at s + k, and
// one shuffle a sequence follows the starts from s. The leader walks any
// other sequence alone by the serial rules (lz4tt_parse_seq), which also
// meet every end of the walk. The block's bytes are read from a window of
// it in shared memory, which the team fills with 16-byte loads. Every
// table entry is written once, the zeros past the row's entries included.
//
// Reads stay below src_len and writes below max_seq entries, whatever the
// input.
#pragma once

#include "lz4tt_common.cuh"

enum { LZ4TT_PARSE_MALFORMED = -2, LZ4TT_PARSE_TOO_MANY = -3 };
// lz4tt_parse_seq's other results: the block ended well, or the walk goes on
enum { LZ4TT_PARSE_DONE = 0, LZ4TT_PARSE_MORE = 1 };

#define LZ4TT_LEN_CAP 0x7E000000

// Bytes of its block a team keeps in shared memory (lz4tt_parse_fill).
#define LZ4TT_PARSE_WIN 2048
// The window is filled again when fewer bytes than this are left in it
// after the walk's position: a step of the run reads 96.
#define LZ4TT_PARSE_AHEAD 128

// A block's bytes as the walk reads them: src[i] from the window win,
// which holds src[lo, hi), else from device memory. The walk keeps its
// position s at least LZ4TT_PARSE_AHEAD bytes before hi, or hi at the
// block's end, so near(i) reads the window alone for i in [s, s + 128)
// below the block's end: the run's bytes, a token and, after a literal
// run of at most 14 bytes, its offset.
struct Lz4ttParseSrc {
  const uint8_t* src;
  const uint8_t* win;
  int32_t lo, hi;
  LZ4TT_HD int32_t operator[](int32_t i) const {
    return i < hi ? win[i - lo] : src[i];
  }
  LZ4TT_HD int32_t near(int32_t i) const {
#ifdef LZ4TT_PARSE_CHECK
    LZ4TT_PARSE_CHECK(i, lo, hi);  // a host build's check of the promise
#endif
    return win[i - lo];
  }
};

// 0xFF-run length extension with the parser's cap; false when malformed.
LZ4TT_HD bool lz4tt_parse_len_ext(const Lz4ttParseSrc& src, int32_t& s,
                                  int32_t src_end, int32_t& len) {
  int32_t b = 0xFF;
  while (s < src_end) {
    b = src[s++];
    if (b != 0xFF) break;
    len += 0xFF;
    if (len >= LZ4TT_LEN_CAP) return false;
  }
  len += b;
  return true;
}

// The six tables of one block: row pointers into int32[N, max_seq] arrays.
struct Lz4ttSeqRow {
  int32_t* lit_out;
  int32_t* lit_src;
  int32_t* lit_len;
  int32_t* m_out;
  int32_t* m_dist;
  int32_t* m_len;
};

// Row b of tables int32[6, n, max_seq].
LZ4TT_HD Lz4ttSeqRow lz4tt_seq_row(int32_t* tables, int64_t n, int64_t max_seq,
                                   int64_t b) {
  int32_t* r = tables + b * max_seq;
  const int64_t f = n * max_seq;
  return {r, r + f, r + 2 * f, r + 3 * f, r + 4 * f, r + 5 * f};
}

// Where the walk stands: input read s, output d, sequences written n, and
// lit = 1 when the sequence at n failed after writing its literal entries.
struct Lz4ttParseAt {
  int32_t s, d, n, lit;
};

// One sequence at w by the serial rules, w.s inside the window as
// Lz4ttParseSrc says. Returns LZ4TT_PARSE_MORE with w past it,
// LZ4TT_PARSE_DONE with w past the block's last sequence, or a code.
LZ4TT_HD int32_t lz4tt_parse_seq(const Lz4ttParseSrc& src, int32_t src_len,
                                 int32_t max_seq, const Lz4ttSeqRow& row,
                                 Lz4ttParseAt& w) {
  int32_t s = w.s;
  const int32_t n = w.n;
  if (s >= src_len) return LZ4TT_PARSE_MALFORMED;
  if (n >= max_seq) return LZ4TT_PARSE_TOO_MANY;
  const int32_t token = src.near(s++);
  int32_t lit_len = token >> LZ4TT_ML_BITS;
  if (lit_len == LZ4TT_RUN_MASK && !lz4tt_parse_len_ext(src, s, src_len, lit_len))
    return LZ4TT_PARSE_MALFORMED;
  if ((int64_t)s + lit_len > src_len) return LZ4TT_PARSE_MALFORMED;
  row.lit_out[n] = w.d;
  row.lit_src[n] = s;
  row.lit_len[n] = lit_len;
  w.lit = 1;
  s += lit_len;
  int32_t d = w.d + lit_len;
  int32_t code = LZ4TT_PARSE_MORE;
  int32_t dist = 0, m_len = 0, step = 0;
  if (s == src_len) {  // the final literals-only sequence
    code = LZ4TT_PARSE_DONE;
  } else {
    if (s + 2 > src_len) return LZ4TT_PARSE_MALFORMED;
    dist = lit_len < LZ4TT_RUN_MASK ? src.near(s) | (src.near(s + 1) << 8)
                                    : src[s] | (src[s + 1] << 8);
    s += 2;
    if (d - dist < 0) return LZ4TT_PARSE_MALFORMED;
    m_len = token & LZ4TT_ML_MASK;
    if (m_len == LZ4TT_ML_MASK && !lz4tt_parse_len_ext(src, s, src_len, m_len))
      return LZ4TT_PARSE_MALFORMED;
    step = m_len + LZ4TT_MIN_MATCH;
    m_len = dist == 0 ? 0 : step;  // a null offset copies nothing
  }
  row.m_out[n] = d;
  row.m_dist[n] = dist;
  row.m_len[n] = m_len;
  w = {s, d + step, n + 1, 0};
  return code;
}

// The 16 bytes src[i, i + 16) into a (bytes outside [0, src_len) are 0):
// one vector load when all lie in the block, else byte by byte; the
// address of src + i is 16-byte aligned.
LZ4TT_HD void lz4tt_parse_chunk(const uint8_t* src, int32_t i, int32_t src_len,
                                uint32_t a[4]) {
  if (i >= 0 && i + 16 <= src_len) {
    const lz4tt_u4 v = lz4tt_load16(src + i);
    a[0] = v.x;
    a[1] = v.y;
    a[2] = v.z;
    a[3] = v.w;
    return;
  }
  for (int k = 0; k < 4; k++) a[k] = 0;
  for (int j = 0; j < 16; j++)
    if (i + j >= 0 && i + j < src_len) a[j >> 2] |= (uint32_t)src[i + j] << (8 * (j & 3));
}

// Fill the team's window (LZ4TT_PARSE_WIN bytes of shared memory, 16-byte
// aligned) with the block's bytes from the 16-byte aligned address at or
// before src + s; each lane loads its chunks, four at once, before it
// stores them. Reads stay in [0, src_len).
template <class Team>
LZ4TT_HD void lz4tt_parse_fill(const Team& t, Lz4ttParseSrc& r, int32_t s,
                               int32_t src_len, uint8_t* win) {
  const int32_t lo = s - (int32_t)((uintptr_t)(r.src + s) & 15);
  const int32_t chunks = LZ4TT_PARSE_WIN / 16, w = t.size();
  t.sync();  // every lane is done with the old window
  for (int32_t c = t.lane(); c < chunks; c += 4 * w) {
    uint32_t a[4][4];
#pragma unroll
    for (int u = 0; u < 4; u++)
      if (c + u * w < chunks) lz4tt_parse_chunk(r.src, lo + 16 * (c + u * w), src_len, a[u]);
#pragma unroll
    for (int u = 0; u < 4; u++)
      if (c + u * w < chunks) lz4tt_store16w(win + 16 * (c + u * w), a[u]);
  }
  t.sync();  // the window the lanes wrote
  r.win = win;
  r.lo = lo;
  r.hi = src_len - lo < LZ4TT_PARSE_WIN ? src_len : lo + LZ4TT_PARSE_WIN;
}

// Keep the window's promise (Lz4ttParseSrc) for the walk's position s.
template <class Team>
LZ4TT_HD void lz4tt_parse_ahead(const Team& t, Lz4ttParseSrc& r, int32_t s,
                                int32_t src_len, uint8_t* win) {
  if (r.hi < src_len && s + LZ4TT_PARSE_AHEAD > r.hi)
    lz4tt_parse_fill(t, r, s, src_len, win);
}

// p[f, e) = 0 by the team: single entries up to the first 16-byte aligned
// address, 16-byte stores, then the tail.
template <class Team>
LZ4TT_HD void lz4tt_team_zero32(const Team& t, int32_t* p, int32_t f, int32_t e) {
  if (e <= f) return;
  int32_t head = (int32_t)(((16 - ((uintptr_t)(p + f) & 15)) & 15) >> 2);
  if (head > e - f) head = e - f;
  const int32_t a0 = f + head;
  const int32_t a1 = a0 + ((e - a0) & ~3);
  for (int32_t j = t.lane(); j < head; j += t.size()) p[f + j] = 0;
  for (int32_t c = a0 + 4 * t.lane(); c < a1; c += 4 * t.size())
    lz4tt_zero16((uint8_t*)(p + c));
  for (int32_t j = a1 + t.lane(); j < e; j += t.size()) p[j] = 0;
}

// The run: lane k takes the sequence at s + 3k if it is a 3-byte one (no
// literals, a token of at most 14: read only if its bytes lie in the block
// and the table has room for it), up to the first lane that is not; a
// scan of the match lengths gives each its output position, and the lanes
// before the first whose match reaches before the output start write
// their records. Returns the sequences taken.
template <class Team>
LZ4TT_HD int32_t lz4tt_parse_run(const Team& t, const Lz4ttParseSrc& src,
                                 int32_t src_len, int32_t max_seq,
                                 const Lz4ttSeqRow& row, Lz4ttParseAt& at) {
  const int w = t.size(), lane = t.lane();
  const int32_t p = at.s + 3 * lane;
  int32_t token = LZ4TT_ML_MASK, dist = 0;
  if (p + 3 <= src_len && at.n + lane < max_seq) {
    token = src.near(p);
    dist = src.near(p + 1) | (src.near(p + 2) << 8);
  }
  const unsigned odd = t.ballot(token >= LZ4TT_ML_MASK);
  const int f = odd ? lz4tt_ffs(odd) - 1 : w;  // lanes before f are 3-byte
  if (f == 0) return 0;
  const int32_t m = (token & LZ4TT_ML_MASK) + LZ4TT_MIN_MATCH;
  const int32_t incl = lz4tt_team_scan(t, lane < f ? m : 0);
  const int32_t d = at.d + incl - m;
  const unsigned far = t.ballot(lane < f && d - dist < 0);
  const int g = far ? lz4tt_ffs(far) - 1 : f;
  if (lane < g) {
    const int32_t k = at.n + lane;
    row.lit_out[k] = d;
    row.lit_src[k] = p + 1;
    row.lit_len[k] = 0;
    row.m_out[k] = d;
    row.m_dist[k] = dist;
    row.m_len[k] = dist == 0 ? 0 : m;
  }
  if (g > 0) {
    at.d += t.shfl(incl, g - 1);
    at.s += 3 * g;
    at.n += g;
  }
  return g;
}

// The chain: short sequences that start in [s, s + team.size()). A short
// sequence has at most one length-extension byte for its literals and one
// for its match (neither 0xFF), and all its bytes lie in the block and
// within LZ4TT_PARSE_AHEAD of s, in the window; it is not the block's
// last. Lane k reads the sequence that would start at s + k; the starts
// from s are followed with one shuffle a sequence, a scan of literals +
// match places them, and the chain's lanes before the first whose match
// reaches before the output start, or that has no room in the table,
// write their records. Returns true when the chain ran past the lanes, so
// that the sequence at the new s is still to be seen; false when it
// stopped at a sequence that is not short or fails, which the serial
// rules then take.
template <class Team>
LZ4TT_HD bool lz4tt_parse_chain(const Team& t, const Lz4ttParseSrc& src,
                                int32_t src_len, int32_t max_seq,
                                const Lz4ttSeqRow& row, Lz4ttParseAt& at) {
  const int w = t.size(), lane = t.lane();
  const int32_t q = at.s + lane;
  const int32_t lim = src_len - at.s < LZ4TT_PARSE_AHEAD ? src_len
                                                         : at.s + LZ4TT_PARSE_AHEAD;
  // next: the next start's lane; lsrc: the literals' offset
  int32_t next = -1, lit = 0, lsrc = 0, m = 0, dist = 0;
  if (q < src_len) {
    const int32_t token = src.near(q);
    int32_t e = q + 1;  // the next byte of the sequence
    bool ok = true;
    lit = token >> LZ4TT_ML_BITS;
    if (lit == LZ4TT_RUN_MASK) {
      const int32_t b = e < lim ? src.near(e++) : 0xFF;
      ok = b != 0xFF;
      lit += b;
    }
    lsrc = e;
    const int32_t off = e + lit;
    if (ok && off + 2 <= lim) {
      dist = src.near(off) | (src.near(off + 1) << 8);
      e = off + 2;
    } else {
      ok = false;
    }
    m = (token & LZ4TT_ML_MASK) + LZ4TT_MIN_MATCH;
    if (ok && m == LZ4TT_ML_MASK + LZ4TT_MIN_MATCH) {
      const int32_t b = e < lim ? src.near(e++) : 0xFF;
      ok = b != 0xFF;
      m += b;
    }
    if (ok) next = lane + (e - q);
  }
  unsigned chain = 0;
  int cur = 0;
  for (;;) {
    const int32_t nx = t.shfl(next, cur);
    if (nx < 0) break;
    chain |= 1u << cur;
    cur = nx;
    if (cur >= w) break;
  }
  if (!chain) return false;
  const bool on = (chain >> lane) & 1;
  const int32_t rank = lz4tt_popc(chain & ((1u << lane) - 1));
  const int32_t step = lit + m;
  const int32_t incl = lz4tt_team_scan(t, on ? step : 0);
  const int32_t lit_out = at.d + incl - step, m_out = lit_out + lit;
  const unsigned bad = t.ballot(on && (m_out - dist < 0 || at.n + rank >= max_seq));
  const unsigned taken = bad ? chain & ((1u << (lz4tt_ffs(bad) - 1)) - 1) : chain;
  if ((taken >> lane) & 1) {
    const int32_t k = at.n + rank;
    row.lit_out[k] = lit_out;
    row.lit_src[k] = lsrc;
    row.lit_len[k] = lit;
    row.m_out[k] = m_out;
    row.m_dist[k] = dist;
    row.m_len[k] = dist == 0 ? 0 : m;
  }
  if (taken) {
    const int last = lz4tt_fls(taken);
    at.s += t.shfl(next, last);
    at.d += t.shfl(incl, last);
    at.n += lz4tt_popc(taken);
  }
  return !bad && cur >= w;
}

// Parse one block into its row of the tables by the team, the zero tails
// included; win: the team's LZ4TT_PARSE_WIN bytes of shared memory,
// 16-byte aligned. Returns the number of sequences or a code; *out_total
// is the decoded length of an OK block, 0 otherwise.
template <class Team>
LZ4TT_HD int32_t lz4tt_parse_block(const Team& t, const uint8_t* block,
                                   int32_t src_len, int32_t max_seq,
                                   const Lz4ttSeqRow& row, uint8_t* win,
                                   int32_t* out_total) {
  Lz4ttParseSrc src = {block, win, 0, 0};
  Lz4ttParseAt at = {0, 0, 0, 0};
  int32_t code = LZ4TT_PARSE_MORE;
  while (code == LZ4TT_PARSE_MORE) {
    // the run, if the token at s could start one
    lz4tt_parse_ahead(t, src, at.s, src_len, win);
    if (at.s < src_len && src.near(at.s) < LZ4TT_ML_MASK &&
        lz4tt_parse_run(t, src, src_len, max_seq, row, at) == t.size())
      continue;
    lz4tt_parse_ahead(t, src, at.s, src_len, win);
    if (lz4tt_parse_chain(t, src, src_len, max_seq, row, at)) continue;
    // the sequence at s is not a short one, or fails
    lz4tt_parse_ahead(t, src, at.s, src_len, win);
    if (t.leader()) code = lz4tt_parse_seq(src, src_len, max_seq, row, at);
    code = t.bcast(code);
    at = {t.bcast(at.s), t.bcast(at.d), t.bcast(at.n), t.bcast(at.lit)};
  }
  // the zero tails: past the literal entries of a failed sequence in the
  // first three tables, past the last sequence in the others
  lz4tt_team_zero32(t, row.lit_out, at.n + at.lit, max_seq);
  lz4tt_team_zero32(t, row.lit_src, at.n + at.lit, max_seq);
  lz4tt_team_zero32(t, row.lit_len, at.n + at.lit, max_seq);
  lz4tt_team_zero32(t, row.m_out, at.n, max_seq);
  lz4tt_team_zero32(t, row.m_dist, at.n, max_seq);
  lz4tt_team_zero32(t, row.m_len, at.n, max_seq);
  *out_total = code == LZ4TT_PARSE_DONE ? at.d : 0;
  return code == LZ4TT_PARSE_DONE ? at.n : code;
}
