// K7's per-block body: the parallel compressor of
// lz4_tpu/kernels/parallel_compress.py::_compress_block (:174-320), byte
// for byte, written against a "block team" of threads that share one
// block: a CTA on the card (csrc/lz4tt_cta_team.cuh), one thread
// (Lz4ttBlockSerial) or a team of host threads in the host build.
//
// A block team offers, besides rank(), size() and sync():
//   exclusive_sum(v, &total)  the sum of v over the threads before this one
//   inclusive_min(v, &total)  the least v over this thread and those before
//   digit_rank(d, valid, base) for a valid thread, base[d] plus the valid
//                             threads before it with digit d; base[] then
//                             advances by the tile's counts
//   any(p)                    p on any thread
//   add(p, v)                 atomic *p += v, returning the old value
// Each is a collective: every thread of the team calls it, in the same
// order. The per-position and per-sequence parts below are plain functions
// of a row, so that the host build runs the same code.
//
// A block of n bytes, read as zeros past n (the JAX layout's padding), goes
// through the JAX module's phases:
//  1. each position's 4-byte word and its position, sorted stably by word
//     (four 8-bit LSD passes over the team's scratch): the sorted
//     predecessor with the same word is the nearest earlier equal word;
//  2. run stops at distances 1-4 from reverse scans, then each position's
//     match length and distance (extension, runs, clamps);
//  3. the greedy walk of each 512-byte segment, once to count and once to
//     write the selected matches in order;
//  4. merging, back-extension, sizes and their scan, and emission: a
//     thread a sequence, literal runs past LZ4TT_PC_LONG bytes copied by
//     the whole team.
// The team's scratch is 4 regions of S int32 (lz4tt_pc_region), reused
// from phase to phase.
#pragma once

#include "lz4tt_common.cuh"

enum {
  LZ4TT_PC_SEG = 512,
  LZ4TT_PC_EXT_STEPS = 15,
  LZ4TT_PC_BEXT = 7,
  LZ4TT_PC_LONG = 64,
  LZ4TT_PC_RADIX = 256,
  LZ4TT_PC_NO_STOP = 0x7FFFFFFF,
};

// One thread as a block team.
struct Lz4ttBlockSerial {
  LZ4TT_HD int rank() const { return 0; }
  LZ4TT_HD int size() const { return 1; }
  LZ4TT_HD void sync() const {}
  LZ4TT_HD int32_t exclusive_sum(int32_t v, int32_t* total) const {
    *total = v;
    return 0;
  }
  LZ4TT_HD int32_t inclusive_min(int32_t v, int32_t* total) const {
    *total = v;
    return v;
  }
  LZ4TT_HD int32_t digit_rank(uint32_t d, bool valid, int32_t* base) const {
    return valid ? base[d]++ : 0;
  }
  LZ4TT_HD bool any(bool p) const { return p; }
  LZ4TT_HD int32_t add(int32_t* p, int32_t v) const {
    const int32_t old = *p;
    *p += v;
    return old;
  }
};

// Words in one of the four scratch regions of a team, for rows of up to
// `width` bytes; at least 32 so that the match and group tables fit.
LZ4TT_HD int64_t lz4tt_pc_region(int64_t width) {
  const int64_t s = (width + 15) & ~(int64_t)15;
  return s < 32 ? 32 : s;
}

LZ4TT_HD int64_t lz4tt_pc_team_words(int64_t width) {
  return 4 * lz4tt_pc_region(width);
}

// Entries of each match, group and sequence table in a region of s words.
LZ4TT_HD int64_t lz4tt_pc_table(int64_t s) { return s / 4 + 2; }

// Byte i of a block of n bytes; 0 at and past n.
LZ4TT_HD uint32_t lz4tt_pc_byte(const uint8_t* x, int32_t n, int64_t i) {
  return i < n ? (uint32_t)x[i] : 0u;
}

// The little-endian word at i, bytes past n read as 0.
LZ4TT_HD uint32_t lz4tt_pc_word(const uint8_t* x, int32_t n, int64_t i) {
  if (i + 4 <= n) return lz4tt_read32(x, i);
  return lz4tt_pc_byte(x, n, i) | (lz4tt_pc_byte(x, n, i + 1) << 8) |
         (lz4tt_pc_byte(x, n, i + 2) << 16) | (lz4tt_pc_byte(x, n, i + 3) << 24);
}

// Match length at i against the candidate j < i (4 bytes equal by
// construction): word steps while i + 4k + 4 <= n, then, only when all
// EXT_STEPS of them held, up to 3 single bytes while i + length < n
// (_extend_match, :84-109).
LZ4TT_HD int32_t lz4tt_pc_extend(const uint8_t* x, int32_t n, int32_t i,
                                 int32_t j) {
  int32_t len = LZ4TT_MIN_MATCH;
  for (int k = 1; k <= LZ4TT_PC_EXT_STEPS; k++) {
    const int32_t off = 4 * k;
    if (i + off + 4 > n || lz4tt_read32(x, j + off) != lz4tt_read32(x, i + off))
      return len;
    len += 4;
  }
  for (int k = 0; k < 3; k++) {
    if (i + len >= n || x[j + len] != x[i + len]) break;
    len++;
  }
  return len;
}

// x[i] == x[i - d] inside the block: where a run at distance d goes on.
LZ4TT_HD bool lz4tt_pc_eq(const uint8_t* x, int32_t n, int32_t i, int d) {
  return i >= d && i < n && x[i] == x[i - d];
}

struct Lz4ttPcPos {
  int32_t mlen, dist;
};

// Position i's clamped match length (0: none) and distance, from its
// candidate (-1: none) and stop[d - 1], the first position at or after i
// where the run at distance d stops (n at the latest) (:185-207).
LZ4TT_HD Lz4ttPcPos lz4tt_pc_position(const uint8_t* x, int32_t n, int32_t i,
                                      int32_t cand, const int32_t stop[4]) {
  if (cand >= 0 && i - cand >= LZ4TT_MAX_DISTANCE) cand = -1;
  int32_t best_len = cand >= 0 ? lz4tt_pc_extend(x, n, i, cand) : 0;
  int32_t best_dist = cand >= 0 ? i - cand : 0;
  for (int d = 1; d <= 4; d++) {
    const int32_t rl = stop[d - 1] - i;
    if (rl > best_len) {
      best_len = rl;
      best_dist = d;
    }
  }
  const int32_t seg_end = (i / LZ4TT_PC_SEG + 1) * LZ4TT_PC_SEG;
  const int32_t bound = seg_end < n - LZ4TT_LAST_LITERALS
                            ? seg_end : n - LZ4TT_LAST_LITERALS;
  const int32_t limit = bound - i < best_len ? bound - i : best_len;
  const bool ok = i + LZ4TT_MF_LIMIT <= n && limit >= LZ4TT_MIN_MATCH;
  return {ok ? limit : 0, best_dist};
}

// The greedy walk of segment seg (_resolve_segments, :151-171): from its
// start, select the match at p when mlen[p] >= 4 and advance by it, else
// advance one byte. Writes the selected matches at m_pos/m_len/m_dist
// when m_pos is not null; returns how many there are.
LZ4TT_HD int32_t lz4tt_pc_walk(const int32_t* mlen, const int32_t* dist,
                               int32_t n, int32_t seg, int32_t* m_pos,
                               int32_t* m_len, int32_t* m_dist) {
  int32_t p = seg * LZ4TT_PC_SEG;
  const int32_t end = p + LZ4TT_PC_SEG < n ? p + LZ4TT_PC_SEG : n;
  int32_t c = 0;
  while (p < end) {
    const int32_t l = mlen[p];
    if (l >= LZ4TT_MIN_MATCH) {
      if (m_pos != nullptr) {
        m_pos[c] = p;
        m_len[c] = l;
        m_dist[c] = dist[p];
      }
      c++;
      p += l;
    } else {
      p++;
    }
  }
  return c;
}

// Whether selected match s starts a group: it does not start where match
// s - 1 ends at the same distance (continuation merging, :224-244).
LZ4TT_HD bool lz4tt_pc_head(const int32_t* m_pos, const int32_t* m_len,
                            const int32_t* m_dist, int32_t s) {
  return s == 0 || m_pos[s] != m_pos[s - 1] + m_len[s - 1] ||
         m_dist[s] != m_dist[s - 1];
}

// Bytes before i that also stand before i - dist, up to BEXT (_extend_back,
// :126-148).
LZ4TT_HD int32_t lz4tt_pc_back(const uint8_t* x, int32_t i, int32_t dist) {
  int32_t t = 0;
  while (t < LZ4TT_PC_BEXT && i - dist - (t + 1) >= 0 &&
         x[i - (t + 1)] == x[i - dist - (t + 1)])
    t++;
  return t;
}

struct Lz4ttPcSeq {
  int32_t lit_start, lit_len, m_len, dist;
  bool match;
};

// Sequence k of a block with G match groups (g_pos, g_end, g_dist): its
// literal gap, and for k < G the group's match extended back into the gap;
// k == G is the last, literals only (:246-261).
LZ4TT_HD Lz4ttPcSeq lz4tt_pc_seq(const uint8_t* x, int32_t n,
                                 const int32_t* g_pos, const int32_t* g_end,
                                 const int32_t* g_dist, int32_t G, int32_t k) {
  const int32_t start = k == 0 ? 0 : g_end[k - 1];
  if (k == G) return {start, n - start, 0, 0, false};
  const int32_t gap = g_pos[k] - start;
  int32_t bk = lz4tt_pc_back(x, g_pos[k], g_dist[k]);
  bk = bk < gap ? bk : gap;
  return {start, gap - bk, g_end[k] - g_pos[k] + bk, g_dist[k], true};
}

// Extension bytes of a run value v (emitted while v >= 255 after 15).
LZ4TT_HD int32_t lz4tt_pc_ext(int32_t v) {
  return v >= LZ4TT_RUN_MASK ? 1 + (v - LZ4TT_RUN_MASK) / 255 : 0;
}

LZ4TT_HD int32_t lz4tt_pc_size(const Lz4ttPcSeq& s) {
  const int32_t run = s.m_len > LZ4TT_MIN_MATCH ? s.m_len - LZ4TT_MIN_MATCH : 0;
  return 1 + lz4tt_pc_ext(s.lit_len) + s.lit_len +
         (s.match ? 2 + lz4tt_pc_ext(run) : 0);
}

// Output byte o, if it lies before cap.
LZ4TT_HD void lz4tt_pc_put(uint8_t* out, int64_t cap, int64_t o, uint32_t v) {
  if (o < cap) out[o] = (uint8_t)v;
}

// The extension bytes of run value v >= 15 at o; returns the next offset.
LZ4TT_HD int64_t lz4tt_pc_put_ext(uint8_t* out, int64_t cap, int64_t o,
                                  int32_t v) {
  int32_t rem = v - LZ4TT_RUN_MASK;
  for (; rem >= 255; rem -= 255) lz4tt_pc_put(out, cap, o++, 255);
  lz4tt_pc_put(out, cap, o++, (uint32_t)rem);
  return o;
}

// Sequence s at o but its literal bytes: token, literal-length extension,
// then after the literals the offset and match-length extension. Returns
// the offset of its first literal byte.
LZ4TT_HD int64_t lz4tt_pc_emit(uint8_t* out, int64_t cap, int64_t o,
                               const Lz4ttPcSeq& s) {
  const int32_t run = s.m_len > LZ4TT_MIN_MATCH ? s.m_len - LZ4TT_MIN_MATCH : 0;
  const uint32_t lit_tok = s.lit_len < LZ4TT_RUN_MASK ? s.lit_len : LZ4TT_RUN_MASK;
  const uint32_t ml_tok = !s.match ? 0u : run < LZ4TT_ML_MASK ? run : LZ4TT_ML_MASK;
  lz4tt_pc_put(out, cap, o++, (lit_tok << LZ4TT_ML_BITS) | ml_tok);
  if (s.lit_len >= LZ4TT_RUN_MASK) o = lz4tt_pc_put_ext(out, cap, o, s.lit_len);
  const int64_t lit = o;
  if (s.match) {
    o += s.lit_len;
    lz4tt_pc_put(out, cap, o++, (uint32_t)s.dist & 0xFF);
    lz4tt_pc_put(out, cap, o++, (uint32_t)s.dist >> 8);
    if (run >= LZ4TT_ML_MASK) lz4tt_pc_put_ext(out, cap, o, run);
  }
  return lit;
}

// Literal bytes [from, len) in steps of `step` of a run of len bytes at o.
LZ4TT_HD void lz4tt_pc_copy(uint8_t* out, int64_t cap, int64_t o,
                            const uint8_t* lit, int32_t len, int32_t from,
                            int32_t step) {
  for (int32_t t = from; t < len && o + t < cap; t += step) out[o + t] = lit[t];
}

// a[0, m) -> its exclusive prefix sums, by the team; returns the total.
template <class Team>
LZ4TT_HD int32_t lz4tt_pc_scan(const Team& t, int32_t* a, int32_t m) {
  int32_t carry = 0;
  for (int32_t tile = 0; tile < m; tile += t.size()) {
    const int32_t i = tile + t.rank();
    int32_t total;
    const int32_t e = t.exclusive_sum(i < m ? a[i] : 0, &total);
    if (i < m) a[i] = carry + e;
    carry += total;
  }
  t.sync();
  return carry;
}

// One stable LSD pass: (ks, vs)[0, n) -> (kd, vd) by the 8-bit digit at
// `shift`, from hist (this digit's counts, turned into start offsets).
template <class Team>
LZ4TT_HD void lz4tt_pc_pass(const Team& t, const int32_t* ks,
                            const int32_t* vs, int32_t* kd, int32_t* vd,
                            int32_t n, int shift, int32_t* hist) {
  lz4tt_pc_scan(t, hist, LZ4TT_PC_RADIX);
  for (int32_t tile = 0; tile < n; tile += t.size()) {
    const int32_t i = tile + t.rank();
    const bool valid = i < n;
    const int32_t k = valid ? ks[i] : 0;
    const int32_t v = valid ? vs[i] : 0;
    const int32_t at = t.digit_rank(((uint32_t)k >> shift) & 0xFF, valid, hist);
    if (valid) {
      kd[at] = k;
      vd[at] = v;
    }
  }
  t.sync();
}

// Compress one block x[0, n) into out[0, cap) by the team; returns the
// compressed length, or -1 when it exceeds cap (out then holds its first
// cap bytes). Bytes of out past the output are left as they are.
// scratch: lz4tt_pc_team_words(width) int32 with n <= width (s: one
// region); hist: 4 x 256 int32 and queue: one int32 the team shares.
template <class Team>
LZ4TT_HD int32_t lz4tt_pc_block(const Team& t, const uint8_t* x, int32_t n,
                                uint8_t* out, int32_t cap, int32_t* scratch,
                                int64_t s, int32_t* hist, int32_t* queue) {
  const int T = t.size(), r = t.rank();
  int32_t* R0 = scratch;
  int32_t* R1 = R0 + s;
  int32_t* R2 = R1 + s;
  int32_t* R3 = R2 + s;
  const int64_t M = lz4tt_pc_table(s);

  // 1. the words and positions, with the four digits' counts
  for (int c = r; c < 4 * LZ4TT_PC_RADIX; c += T) hist[c] = 0;
  if (r == 0) *queue = 0;
  t.sync();
  for (int32_t i = r; i < n; i += T) {
    const uint32_t w = lz4tt_pc_word(x, n, i);
    R0[i] = (int32_t)w;
    R1[i] = i;
    for (int p = 0; p < 4; p++)
      t.add(&hist[p * LZ4TT_PC_RADIX + ((w >> (8 * p)) & 0xFF)], 1);
  }
  t.sync();
  // four passes: R0/R1 -> R2/R3 -> R0/R1 -> R2/R3 -> R0/R1
  for (int p = 0; p < 4; p++) {
    const bool even = (p & 1) == 0;
    lz4tt_pc_pass(t, even ? R0 : R2, even ? R1 : R3, even ? R2 : R0,
                  even ? R3 : R1, n, 8 * p, hist + p * LZ4TT_PC_RADIX);
  }
  // each position's candidate, in R2
  for (int32_t k = r; k < n; k += T)
    R2[R1[k]] = k > 0 && R0[k - 1] == R0[k] ? R1[k - 1] : -1;
  t.sync();

  // 2. run stops from the end, a tile at a time (thread r takes position
  // hi - 1 - r, so a forward min is a min over later positions); each
  // position's length in R0 and distance in R1
  int32_t carry[4] = {n, n, n, n};
  for (int32_t hi = n; hi > 0; hi -= T) {
    const int32_t i = hi - 1 - r;
    const bool valid = i >= 0;
    int32_t stop[4];
    for (int d = 1; d <= 4; d++) {
      int32_t total;
      const int32_t v = valid && !lz4tt_pc_eq(x, n, i, d) ? i : LZ4TT_PC_NO_STOP;
      const int32_t m = t.inclusive_min(v, &total);
      stop[d - 1] = m < carry[d - 1] ? m : carry[d - 1];
      carry[d - 1] = total < carry[d - 1] ? total : carry[d - 1];
    }
    if (valid) {
      const Lz4ttPcPos at = lz4tt_pc_position(x, n, i, R2[i], stop);
      R0[i] = at.mlen;
      R1[i] = at.dist;
    }
  }
  t.sync();

  // 3. the walk: matches a segment in R3, their offsets, then the matches
  // in order in R2
  const int32_t n_seg = (n + LZ4TT_PC_SEG - 1) / LZ4TT_PC_SEG;
  for (int32_t g = r; g < n_seg; g += T)
    R3[g] = lz4tt_pc_walk(R0, R1, n, g, nullptr, nullptr, nullptr);
  t.sync();
  const int32_t m = lz4tt_pc_scan(t, R3, n_seg);
  int32_t* m_pos = R2;
  int32_t* m_len = R2 + M;
  int32_t* m_dist = R2 + 2 * M;
  for (int32_t g = r; g < n_seg; g += T)
    lz4tt_pc_walk(R0, R1, n, g, m_pos + R3[g], m_len + R3[g], m_dist + R3[g]);
  t.sync();

  // 4. groups of merged matches in R0
  int32_t* g_pos = R0;
  int32_t* g_end = R0 + M;
  int32_t* g_dist = R0 + 2 * M;
  int32_t G = 0;
  for (int32_t tile = 0; tile < m; tile += T) {
    const int32_t k = tile + r;
    const bool valid = k < m;
    const bool head = valid && lz4tt_pc_head(m_pos, m_len, m_dist, k);
    int32_t total;
    const int32_t g = G + t.exclusive_sum(head ? 1 : 0, &total);
    if (head) {
      g_pos[g] = m_pos[k];
      g_dist[g] = m_dist[k];
    }
    if (valid && (k + 1 == m || lz4tt_pc_head(m_pos, m_len, m_dist, k + 1)))
      g_end[g + (head ? 1 : 0) - 1] = m_pos[k] + m_len[k];
    G += total;
  }
  t.sync();

  // sequence sizes in R1, then their offsets
  for (int32_t k = r; k <= G; k += T)
    R1[k] = lz4tt_pc_size(lz4tt_pc_seq(x, n, g_pos, g_end, g_dist, G, k));
  t.sync();
  const int32_t total = lz4tt_pc_scan(t, R1, G + 1);

  // emission: a thread a sequence; long literal runs queued in R1 + M for
  // the whole team
  int32_t* longs = R1 + M;
  for (int32_t k = r; k <= G; k += T) {
    const Lz4ttPcSeq q = lz4tt_pc_seq(x, n, g_pos, g_end, g_dist, G, k);
    const int64_t lit = lz4tt_pc_emit(out, cap, R1[k], q);
    if (q.lit_len <= LZ4TT_PC_LONG)
      lz4tt_pc_copy(out, cap, lit, x + q.lit_start, q.lit_len, 0, 1);
    else
      longs[t.add(queue, 1)] = k;
  }
  t.sync();
  const int32_t n_long = *queue;
  for (int32_t j = 0; j < n_long; j++) {
    const int32_t k = longs[j];
    const Lz4ttPcSeq q = lz4tt_pc_seq(x, n, g_pos, g_end, g_dist, G, k);
    lz4tt_pc_copy(out, cap, R1[k] + 1 + lz4tt_pc_ext(q.lit_len),
                  x + q.lit_start, q.lit_len, r, T);
  }
  t.sync();
  return total > cap ? -1 : total;
}
