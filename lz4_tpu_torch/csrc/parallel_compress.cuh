// K7's bodies: the parallel compressor of
// lz4_tpu/kernels/parallel_compress.py::_compress_block (:174-320), byte
// for byte, written against a "block team" of threads that work on one
// window of a row: a CTA on the card (csrc/lz4tt_cta_team.cuh), one thread
// (Lz4ttBlockSerial) or a team of host threads in the host build.
//
// A block team offers, besides rank(), size() and sync():
//   exclusive_sum(v, &total)  the sum of v over the threads before this one
//   exclusive_min(v, &total)  the least v over the threads before this one
//                             (INT32_MAX on the first)
//   any(p)                    p on any thread
//   add(p, v)                 atomic *p += v, returning the old value
//   slot(p)                   add(p, 1), for threads that share p
//   warp_size()               the threads of a warp: 32 on the card, 1 on
//                             the host; the warp_* collectives are a warp's
//   warp_min(v), warp_suffix_min(v), warp_bcast(v, lane)
//                             the least v of the warp, of this lane and the
//                             lanes after it; v of a lane
//   warp_count(p), warp_rank(p)
//                             the lanes of the warp with p, those below
//                             this one
//   sort_pass(ks, vs, kd, vd, m, shift, mask)
//                             a stable counting sort of ks[0, m) (and vs)
//                             by the digit (k >> shift) & mask, into kd, vd
// Each is a collective: every thread of the team calls it, in the same
// order. The per-position and per-sequence parts below are plain functions
// of a row, so that the host build runs the same code.
//
// A row of n bytes, read as zeros past n (the JAX layout's padding), is cut
// into windows of wl positions (65,536 on the card; a multiple of 512 up
// to that), each a team's work, and goes through the JAX module's phases:
//
// 1. (lz4tt_pc_window, a window) Each position's candidate, the nearest
//    earlier position with the same 4-byte word, dropped 65,536 or more
//    away: a window and the 65,535 positions before it hold every
//    candidate it can keep. Their keys, a 15-bit hash of the word above
//    the position, are sorted (three passes of 5 bits: few digits keep
//    the scattered writes few streams; the keys are distinct, so this
//    puts each hash's positions in order); a position walks back through
//    its hash's earlier positions to the first with its word, out of
//    reach, or the hash's start. When a walk takes more than walk_limit
//    steps, the window sorts (word, position) stably instead (four
//    passes) and takes each sorted predecessor with the same word, so the
//    worst case stays the sort's. Then the run stops at distances 1-4:
//    the first position at or after each where the run goes no further,
//    unclamped (the distance choice compares run lengths past any window
//    end): each warp goes through a chunk of the window from its end, a
//    position a lane, with the first stops of the chunks after it, the
//    last chunk's from a scan past the window's end. Then each position's
//    clamped match length (in shared memory, 2 bytes a position) and
//    distance; the greedy walk of each 512-byte segment (a window holds
//    whole segments), marking its matches, which each warp then gathers
//    from its chunk in order; and the window's matches merged where they
//    continue
//    one another, into groups kept for the last part with a header: their
//    count, the summed sizes of the groups that lie wholly in the window,
//    the back-extensions of the first and the last.
// 2. (lz4tt_pc_row, a row, one thread) The carries, window by window: the
//    first group of a window continues the row's last one when it starts
//    where that ends at the same distance (a run of one byte is one group
//    across the whole row); the previous group's end starts each literal
//    run, the output offset runs on, and a group or literal run that spans
//    windows gets its length, and so its size, where it ends. It writes
//    each window's carries and the row's length.
// 3. (lz4tt_pc_emit_window, a window) Every sequence whose group starts in
//    the window (and the last, literals only, in the row's last window)
//    writes its token, extensions and offset; literal bytes are copied by
//    the window that holds their source positions, runs past
//    LZ4TT_PC_LONG bytes by the whole team.
#pragma once

#include "lz4tt_common.cuh"

enum {
  LZ4TT_PC_SEG = 512,
  LZ4TT_PC_EXT_STEPS = 15,
  LZ4TT_PC_BEXT = 7,
  LZ4TT_PC_LONG = 64,
  LZ4TT_PC_WIN = 65536,       // a window's positions on the card
  LZ4TT_PC_BACK = 65535,      // the positions before a window it reaches
  LZ4TT_PC_POS_BITS = 17,     // a key's position within the keys' span
  LZ4TT_PC_WALK = 64,         // a hash walk's steps before the exact sort
  LZ4TT_PC_NO_STOP = 0x7FFFFFFF,
};

// A window's header in its store, then its groups: g_pos, g_end, g_dist,
// lz4tt_pc_groups(wl) entries each. Part 1 writes H to BEXTL, part 2 the
// carries.
enum {
  LZ4TT_PC_H = 0,          // groups
  LZ4TT_PC_LOCAL_SUM,      // sizes of groups 1 .. H - 2
  LZ4TT_PC_BEXT0,          // back-extension bound of group 0
  LZ4TT_PC_BEXTL,          // ... of group H - 1
  LZ4TT_PC_IS_HEAD,        // group 0 starts a sequence (else continues)
  LZ4TT_PC_SEQ_OFF,        // group 0's sequence: output offset,
  LZ4TT_PC_LIT_START,      //   literal start,
  LZ4TT_PC_LIT_LEN,        //   literal length,
  LZ4TT_PC_BK,             //   back-extension,
  LZ4TT_PC_MLEN0,          //   match length (the whole chain's)
  LZ4TT_PC_BASE_OFF,       // output offset of group 1's sequence
  LZ4TT_PC_MLENL,          // match length of group H - 1's chain (H >= 2)
  LZ4TT_PC_TRAIL_S,        // the literal run after the last group whose
  LZ4TT_PC_TRAIL_E,        //   sequence starts in a later window: its
  LZ4TT_PC_TRAIL_OUT,      //   [start, end) and output offset of start
  LZ4TT_PC_HDR = 16,
};

// A row's record: its length (or -1 past cap), then the last sequence's
// output offset, literal start and length.
enum { LZ4TT_PC_ROW_WORDS = 4 };

// A stable counting sort, by one thread (sort_pass of the host teams).
LZ4TT_HD void lz4tt_pc_sort_serial(const uint32_t* ks, const int32_t* vs,
                                   uint32_t* kd, int32_t* vd, int32_t m,
                                   int shift, uint32_t mask) {
  int32_t c[256];
  for (int i = 0; i < 256; i++) c[i] = 0;
  for (int32_t i = 0; i < m; i++) c[(ks[i] >> shift) & mask]++;
  int32_t run = 0;
  for (int i = 0; i < 256; i++) {
    const int32_t x = c[i];
    c[i] = run;
    run += x;
  }
  for (int32_t i = 0; i < m; i++) {
    const int32_t at = c[(ks[i] >> shift) & mask]++;
    kd[at] = ks[i];
    if (vd != nullptr) vd[at] = vs[i];
  }
}

// One thread as a block team.
struct Lz4ttBlockSerial {
  LZ4TT_HD int rank() const { return 0; }
  LZ4TT_HD int size() const { return 1; }
  LZ4TT_HD void sync() const {}
  LZ4TT_HD int32_t exclusive_sum(int32_t v, int32_t* total) const {
    *total = v;
    return 0;
  }
  LZ4TT_HD int32_t exclusive_min(int32_t v, int32_t* total) const {
    *total = v;
    return LZ4TT_PC_NO_STOP;
  }
  LZ4TT_HD bool any(bool p) const { return p; }
  LZ4TT_HD int32_t add(int32_t* p, int32_t v) const {
    const int32_t old = *p;
    *p += v;
    return old;
  }
  LZ4TT_HD int32_t slot(int32_t* p) const { return add(p, 1); }
  LZ4TT_HD int warp_size() const { return 1; }
  LZ4TT_HD int32_t warp_min(int32_t v) const { return v; }
  LZ4TT_HD int32_t warp_suffix_min(int32_t v) const { return v; }
  LZ4TT_HD int32_t warp_bcast(int32_t v, int) const { return v; }
  LZ4TT_HD int32_t warp_count(bool p) const { return p ? 1 : 0; }
  LZ4TT_HD int32_t warp_rank(bool) const { return 0; }
  LZ4TT_HD void sort_pass(const uint32_t* ks, const int32_t* vs, uint32_t* kd,
                          int32_t* vd, int32_t m, int shift,
                          uint32_t mask) const {
    lz4tt_pc_sort_serial(ks, vs, kd, vd, m, shift, mask);
  }
};

// Windows of a row of n bytes (at least one).
LZ4TT_HD int32_t lz4tt_pc_windows(int64_t n, int32_t wl) {
  return n <= wl ? 1 : (int32_t)((n + wl - 1) / wl);
}

// Positions of a window for rows of up to `width` bytes, and the keys'
// span (the window and its look-back), at least 32.
LZ4TT_HD int64_t lz4tt_pc_win_len(int64_t width, int32_t wl) {
  const int64_t w = width < wl ? width : wl;
  return w < 32 ? 32 : (w + 15) & ~(int64_t)15;
}

LZ4TT_HD int64_t lz4tt_pc_span(int64_t width, int32_t wl) {
  return lz4tt_pc_win_len(width, wl) + (width > wl ? LZ4TT_PC_BACK + 1 : 0);
}

// Groups a window holds at most (a match takes at least 4 positions).
LZ4TT_HD int64_t lz4tt_pc_groups(int64_t width, int32_t wl) {
  return lz4tt_pc_win_len(width, wl) / 4 + 2;
}

// Int32 words of a team's scratch (four arrays of the span, then a
// window's distances, 2 bytes each) and of a window's store.
LZ4TT_HD int64_t lz4tt_pc_team_words(int64_t width, int32_t wl) {
  return 4 * lz4tt_pc_span(width, wl) + lz4tt_pc_win_len(width, wl) / 2;
}

// A window's candidates, then its match lengths, in shared memory: 2 bytes
// a position, each 512-position segment 4 bytes after the one before, so
// that the walks' segments start in different banks.
LZ4TT_HD constexpr int32_t lz4tt_pc_mi(int32_t i) {
  return i + 2 * (i / LZ4TT_PC_SEG);
}

LZ4TT_HD constexpr int64_t lz4tt_pc_mlen_len(int32_t wl) {
  return lz4tt_pc_mi(wl) + 2;
}

LZ4TT_HD int64_t lz4tt_pc_window_words(int64_t width, int32_t wl) {
  return LZ4TT_PC_HDR + 3 * lz4tt_pc_groups(width, wl);
}

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

// A word's 15-bit hash, above a key's position bits.
LZ4TT_HD uint32_t lz4tt_pc_key(uint32_t w, int32_t at) {
  return ((w * 2654435761u) >> LZ4TT_PC_POS_BITS << LZ4TT_PC_POS_BITS) |
         (uint32_t)at;
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
LZ4TT_HD bool lz4tt_pc_eq(const uint8_t* x, int32_t n, int64_t i, int d) {
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

// The greedy walk of the segment at s < we (_resolve_segments, :151-171),
// over the window's lengths from ws: from s, select the match at p when
// its length is at least 4 and advance by it, else advance one byte. Marks
// each selected match in its length's bit 15.
LZ4TT_HD void lz4tt_pc_walk(uint16_t* mlen, int32_t ws, int32_t we,
                            int32_t s) {
  int32_t p = s;
  const int32_t end = p + LZ4TT_PC_SEG < we ? p + LZ4TT_PC_SEG : we;
  while (p < end) {
    const int32_t l = mlen[lz4tt_pc_mi(p - ws)];
    if (l >= LZ4TT_MIN_MATCH) {
      mlen[lz4tt_pc_mi(p - ws)] = (uint16_t)(l | 0x8000);
      p += l;
    } else {
      p++;
    }
  }
}

// Whether the walk selected the match at window position i.
LZ4TT_HD bool lz4tt_pc_selected(const uint16_t* mlen, int32_t i) {
  return (mlen[lz4tt_pc_mi(i)] & 0x8000) != 0;
}

// Whether selected match s > 0 starts a group: it does not start where
// match s - 1 ends at the same distance (continuation merging, :224-244).
LZ4TT_HD bool lz4tt_pc_head(const int32_t* m_pos, const int32_t* m_len,
                            const int32_t* m_dist, int32_t s) {
  return m_pos[s] != m_pos[s - 1] + m_len[s - 1] ||
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

// The sequence of group j > 0 of a window (its literal run starts where
// group j - 1 ends), its match extended back into that run, of length
// m_len before the extension (-1: to the group's end).
LZ4TT_HD Lz4ttPcSeq lz4tt_pc_local_seq(const uint8_t* x, const int32_t* g_pos,
                                       const int32_t* g_end,
                                       const int32_t* g_dist, int32_t j,
                                       int32_t m_len) {
  const int32_t start = g_end[j - 1];
  const int32_t gap = g_pos[j] - start;
  int32_t bk = lz4tt_pc_back(x, g_pos[j], g_dist[j]);
  bk = bk < gap ? bk : gap;
  const int32_t len = m_len < 0 ? g_end[j] - g_pos[j] + bk : m_len;
  return {start, gap - bk, len, g_dist[j], true};
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

// Source bytes [from, to) of a literal run that starts at source s and
// output o, in steps of `step` from from + first.
LZ4TT_HD void lz4tt_pc_copy(uint8_t* out, int64_t cap, const uint8_t* x,
                            int64_t s, int64_t o, int64_t from, int64_t to,
                            int32_t first, int32_t step) {
  for (int64_t p = from + first; p < to && o + (p - s) < cap; p += step)
    out[o + (p - s)] = x[p];
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

// The first position at or after `from` where each run at distance 1-4
// stops (n at the latest), by the team: 16 positions a thread a step.
template <class Team>
LZ4TT_HD void lz4tt_pc_stops_after(const Team& t, const uint8_t* x, int32_t n,
                                   int32_t from, int32_t after[4]) {
  for (int d = 0; d < 4; d++) after[d] = from < n ? LZ4TT_PC_NO_STOP : n;
  for (int64_t b = from; b < n; b += 16 * (int64_t)t.size()) {
    bool open = false;
    for (int d = 1; d <= 4; d++) {
      int32_t v = LZ4TT_PC_NO_STOP;
      for (int64_t i = b + 16 * t.rank(); i < b + 16 * (t.rank() + 1); i++)
        if (!lz4tt_pc_eq(x, n, i, d)) {
          v = (int32_t)(i < n ? i : n);
          break;
        }
      int32_t total;
      t.exclusive_min(v, &total);
      after[d - 1] = total < after[d - 1] ? total : after[d - 1];
      open |= after[d - 1] == LZ4TT_PC_NO_STOP;
    }
    if (!open) break;
  }
}

// Part 1 of window w of a row x[0, n) by the team: its groups and header
// into `store` (lz4tt_pc_window_words). scratch: lz4tt_pc_team_words int32
// for rows of up to the width it was sized for; mlen: lz4tt_pc_mlen_len(wl)
// uint16 (shared memory on the card), first the candidates' distances
// (0: none), then the match lengths.
template <class Team>
LZ4TT_HD void lz4tt_pc_window(const Team& t, const uint8_t* x, int32_t n,
                              int32_t w, int32_t wl, int32_t walk_limit,
                              int32_t* scratch, int64_t span, int64_t groups,
                              uint16_t* mlen, int32_t* store) {
  const int T = t.size(), r = t.rank();
  const int32_t ws = w * wl;
  const int32_t we = ws + wl < n ? ws + wl : n;
  const int32_t lo = ws - LZ4TT_PC_BACK > 0 ? ws - LZ4TT_PC_BACK : 0;
  const int32_t m = we > lo ? we - lo : 0;
  uint32_t* A = reinterpret_cast<uint32_t*>(scratch);
  uint32_t* B = A + span;
  int32_t* C = scratch + 2 * span;
  int32_t* D = scratch + 3 * span;
  uint16_t* E = reinterpret_cast<uint16_t*>(scratch + 4 * span);  // dists
  int32_t* g_pos = store + LZ4TT_PC_HDR;
  int32_t* g_end = g_pos + groups;
  int32_t* g_dist = g_end + groups;

  // 1. candidates: keys sorted by hash, then each position's walk back
  for (int32_t i = r; i < m; i += T)
    A[i] = lz4tt_pc_key(lz4tt_pc_word(x, n, lo + i), i);
  t.sync();
  t.sort_pass(A, nullptr, B, nullptr, m, LZ4TT_PC_POS_BITS, 0x1Fu);
  t.sort_pass(B, nullptr, A, nullptr, m, LZ4TT_PC_POS_BITS + 5, 0x1Fu);
  t.sort_pass(A, nullptr, B, nullptr, m, LZ4TT_PC_POS_BITS + 10, 0x1Fu);
  bool over = false;
  for (int32_t k = r; k < m; k += T) {
    const uint32_t key = B[k];
    const int32_t p = lo + (int32_t)(key & ((1u << LZ4TT_PC_POS_BITS) - 1));
    if (p < ws) continue;
    const uint32_t word = lz4tt_pc_word(x, n, p);
    int32_t cand = -1;
    for (int32_t q = k - 1, steps = 0; q >= 0; q--) {
      const uint32_t kk = B[q];
      if ((kk ^ key) >> LZ4TT_PC_POS_BITS) break;
      const int32_t at = lo + (int32_t)(kk & ((1u << LZ4TT_PC_POS_BITS) - 1));
      if (p - at >= LZ4TT_MAX_DISTANCE) break;
      if (steps++ >= walk_limit) {
        over = true;
        break;
      }
      if (lz4tt_pc_word(x, n, at) == word) {
        cand = at;
        break;
      }
    }
    mlen[lz4tt_pc_mi(p - ws)] = (uint16_t)(cand < 0 ? 0 : p - cand);
  }
  if (t.any(over)) {  // the exact sort: (word, position), four passes
    for (int32_t i = r; i < m; i += T) {
      B[i] = lz4tt_pc_word(x, n, lo + i);
      C[i] = lo + i;
    }
    t.sync();
    for (int p = 0; p < 4; p++) {
      const bool even = (p & 1) == 0;
      t.sort_pass(even ? B : A, even ? C : D, even ? A : B, even ? D : C, m,
                  8 * p, 0xFFu);
    }
    for (int32_t k = r; k < m; k += T) {
      const int32_t p = C[k];
      const bool near = k > 0 && B[k - 1] == B[k] &&
                        p - C[k - 1] < LZ4TT_MAX_DISTANCE;
      if (p >= ws) mlen[lz4tt_pc_mi(p - ws)] = (uint16_t)(near ? p - C[k - 1] : 0);
    }
  }
  t.sync();

  // 2. run stops and each position's length and distance. The team's
  // warps (t.warp_size() threads; one thread on the host) take chunks of
  // the window in reverse order, so the chunks after a warp's belong to the
  // warps before it; a warp goes through its chunk from the end, a
  // position a lane, carrying the stops from step to step
  int32_t after[4], stop[4];
  lz4tt_pc_stops_after(t, x, n, we, after);
  const int W = t.warp_size(), n_warp = T / W, lane = r % W;
  const int32_t len = we - ws > 0 ? we - ws : 0;
  const int32_t per = ((len + n_warp - 1) / n_warp + W - 1) / W * W;
  const int32_t off = (n_warp - 1 - r / W) * per;
  const int32_t c0 = ws + (off < len ? off : len);
  const int32_t c1 = c0 + per < we ? c0 + per : we;
  for (int d = 1; d <= 4; d++) {
    int32_t first = LZ4TT_PC_NO_STOP;
    for (int32_t b = c0; b < c1 && first == LZ4TT_PC_NO_STOP; b += W) {
      const int32_t i = b + lane;
      first = t.warp_min(i < c1 && !lz4tt_pc_eq(x, n, i, d)
                             ? i : LZ4TT_PC_NO_STOP);
    }
    int32_t total;
    const int32_t later = t.warp_bcast(
        t.exclusive_min(lane == 0 ? first : LZ4TT_PC_NO_STOP, &total), 0);
    stop[d - 1] = later < after[d - 1] ? later : after[d - 1];
  }
  for (int32_t b = c0 + (c1 - c0 + W - 1) / W * W - W; b >= c0; b -= W) {
    const int32_t i = b + lane;
    const bool valid = i < c1;
    int32_t mine[4];
    for (int d = 1; d <= 4; d++) {
      const int32_t v = t.warp_suffix_min(
          valid && !lz4tt_pc_eq(x, n, i, d) ? i : LZ4TT_PC_NO_STOP);
      mine[d - 1] = v < stop[d - 1] ? v : stop[d - 1];
      stop[d - 1] = t.warp_bcast(mine[d - 1], 0);
    }
    if (valid) {
      const int32_t cd = mlen[lz4tt_pc_mi(i - ws)];
      const Lz4ttPcPos at = lz4tt_pc_position(x, n, i, cd ? i - cd : -1, mine);
      mlen[lz4tt_pc_mi(i - ws)] = (uint16_t)at.mlen;
      E[i - ws] = (uint16_t)at.dist;
    }
  }
  t.sync();

  // 3. the walk: each segment's selected matches marked in mlen (bit 15),
  // then gathered in order, a warp a chunk as in 2, into B, C, D
  int32_t* m_pos = scratch + span;
  const int32_t n_seg = (len + LZ4TT_PC_SEG - 1) / LZ4TT_PC_SEG;
  for (int32_t g = r; g < n_seg; g += T)
    lz4tt_pc_walk(mlen, ws, we, ws + g * LZ4TT_PC_SEG);
  t.sync();
  int32_t mine_n = 0;
  for (int32_t b = c0; b < c1; b += W) {
    const int32_t i = b + lane;
    mine_n += t.warp_count(i < c1 && lz4tt_pc_selected(mlen, i - ws));
  }
  int32_t n_match;
  const int32_t before =
      t.exclusive_sum(lane == 0 ? mine_n : 0, &n_match);  // chunks after
  int32_t at = n_match - t.warp_bcast(before, 0) - mine_n;
  for (int32_t b = c0; b < c1; b += W) {
    const int32_t i = b + lane;
    const bool sel = i < c1 && lz4tt_pc_selected(mlen, i - ws);
    const int32_t k = at + t.warp_rank(sel);  // every lane, then the chosen
    if (sel) {
      m_pos[k] = i;
      C[k] = mlen[lz4tt_pc_mi(i - ws)] & 0x7FFF;
      D[k] = E[i - ws];
    }
    at += t.warp_count(sel);
  }
  t.sync();

  // 4. the window's groups (match 0 always starts one here; part 2 says
  // whether it continues the row's last) and the sizes of groups 1 .. H - 2
  int32_t G = 0;
  for (int32_t tile = 0; tile < n_match; tile += T) {
    const int32_t k = tile + r;
    const bool valid = k < n_match;
    const bool head = valid && (k == 0 || lz4tt_pc_head(m_pos, C, D, k));
    int32_t total;
    const int32_t g = G + t.exclusive_sum(head ? 1 : 0, &total);
    if (head) {
      g_pos[g] = m_pos[k];
      g_dist[g] = D[k];
    }
    if (valid && (k + 1 == n_match || lz4tt_pc_head(m_pos, C, D, k + 1)))
      g_end[g + (head ? 1 : 0) - 1] = m_pos[k] + C[k];
    G += total;
  }
  t.sync();
  int32_t sum = 0;
  for (int32_t tile = 1; tile < G - 1; tile += T) {
    const int32_t j = tile + r;
    const int32_t v = j < G - 1 ? lz4tt_pc_size(lz4tt_pc_local_seq(
                                      x, g_pos, g_end, g_dist, j, -1))
                                : 0;
    int32_t total;
    t.exclusive_sum(v, &total);
    sum += total;
  }
  if (r == 0) {
    store[LZ4TT_PC_H] = G;
    store[LZ4TT_PC_LOCAL_SUM] = sum;
    store[LZ4TT_PC_BEXT0] = G > 0 ? lz4tt_pc_back(x, g_pos[0], g_dist[0]) : 0;
    store[LZ4TT_PC_BEXTL] =
        G > 1 ? lz4tt_pc_back(x, g_pos[G - 1], g_dist[G - 1]) : 0;
  }
  t.sync();
}

// Part 2 for a row of n bytes whose windows' stores lie `stride` words
// apart from `store`: each window's carries and the row's record; returns
// the row's compressed length, or -1 past cap.
LZ4TT_HD int32_t lz4tt_pc_row(int32_t n, int32_t wl, int32_t cap,
                              int32_t* store, int64_t stride, int64_t groups,
                              int32_t* row) {
  const int32_t nw = lz4tt_pc_windows(n, wl);
  for (int32_t w = 0; w < nw; w++) {
    int32_t* st = store + w * stride;
    st[LZ4TT_PC_IS_HEAD] = 0;
    st[LZ4TT_PC_TRAIL_S] = st[LZ4TT_PC_TRAIL_E] = st[LZ4TT_PC_TRAIL_OUT] = 0;
  }
  int32_t prev_end = 0, out_off = 0, run_from = 0;
  // the last group so far, whose chain may go on: where its match length
  // goes, its start, distance, back-extension, literal length and end
  int32_t* pend = nullptr;
  int32_t p_pos = 0, p_dist = 0, p_bk = 0, p_lit = 0, p_end = 0;
  auto close = [&]() {
    if (pend == nullptr) return;
    const int32_t m_len = p_end - p_pos + p_bk;
    *pend = m_len;
    out_off += lz4tt_pc_size({0, p_lit, m_len, 0, true});
    pend = nullptr;
  };
  // the literal run [s, e) at output o, for the windows run_from .. last
  auto trail = [&](int32_t last, int32_t s, int32_t e, int32_t o) {
    for (int32_t v = run_from; v <= last; v++) {
      int32_t* st = store + v * stride;
      st[LZ4TT_PC_TRAIL_S] = s;
      st[LZ4TT_PC_TRAIL_E] = e;
      st[LZ4TT_PC_TRAIL_OUT] = o;
    }
  };
  for (int32_t w = 0; w < nw; w++) {
    int32_t* st = store + w * stride;
    const int32_t h = st[LZ4TT_PC_H];
    if (h == 0) continue;
    const int32_t* g_pos = st + LZ4TT_PC_HDR;
    const int32_t* g_end = g_pos + groups;
    const int32_t* g_dist = g_end + groups;
    if (pend != nullptr && g_pos[0] == p_end && g_dist[0] == p_dist) {
      p_end = g_end[0];
    } else {
      close();
      const int32_t gap = g_pos[0] - prev_end;
      const int32_t bk = st[LZ4TT_PC_BEXT0] < gap ? st[LZ4TT_PC_BEXT0] : gap;
      const int32_t lit = gap - bk;
      trail(w - 1, prev_end, g_pos[0] - bk, out_off + 1 + lz4tt_pc_ext(lit));
      st[LZ4TT_PC_IS_HEAD] = 1;
      st[LZ4TT_PC_SEQ_OFF] = out_off;
      st[LZ4TT_PC_LIT_START] = prev_end;
      st[LZ4TT_PC_LIT_LEN] = lit;
      st[LZ4TT_PC_BK] = bk;
      pend = st + LZ4TT_PC_MLEN0;
      p_pos = g_pos[0];
      p_dist = g_dist[0];
      p_bk = bk;
      p_lit = lit;
      p_end = g_end[0];
    }
    if (h >= 2) {
      close();
      st[LZ4TT_PC_BASE_OFF] = out_off;
      out_off += st[LZ4TT_PC_LOCAL_SUM];
      const int32_t gap = g_pos[h - 1] - g_end[h - 2];
      const int32_t bk = st[LZ4TT_PC_BEXTL] < gap ? st[LZ4TT_PC_BEXTL] : gap;
      pend = st + LZ4TT_PC_MLENL;
      p_pos = g_pos[h - 1];
      p_dist = g_dist[h - 1];
      p_bk = bk;
      p_lit = gap - bk;
      p_end = g_end[h - 1];
    }
    prev_end = p_end;
    run_from = w;
  }
  close();
  const int32_t lit = n - prev_end;
  trail(nw - 1, prev_end, n, out_off + 1 + lz4tt_pc_ext(lit));
  const int32_t total = out_off + lz4tt_pc_size({prev_end, lit, 0, 0, false});
  row[0] = total > cap ? -1 : total;
  row[1] = out_off;
  row[2] = prev_end;
  row[3] = lit;
  return row[0];
}

// Part 3 of window w of a row x[0, n) by the team: its sequences' bytes
// into out[0, cap) from its store and the row's record. scratch: as part
// 1's; queue: one int32 the team shares.
template <class Team>
LZ4TT_HD void lz4tt_pc_emit_window(const Team& t, const uint8_t* x, int32_t n,
                                   int32_t w, int32_t wl, const int32_t* store,
                                   int64_t groups, const int32_t* row,
                                   uint8_t* out, int32_t cap, int32_t* scratch,
                                   int64_t span, int32_t* queue) {
  const int T = t.size(), r = t.rank();
  const int32_t ws = w * wl;
  const int32_t we = ws + wl < n ? ws + wl : n;
  const int32_t h = store[LZ4TT_PC_H];
  const int32_t* g_pos = store + LZ4TT_PC_HDR;
  const int32_t* g_end = g_pos + groups;
  const int32_t* g_dist = g_end + groups;
  int32_t* sizes = scratch;
  int32_t* longs = scratch + span;
  if (r == 0) *queue = 0;

  // group 0's sequence when it starts one here, and the row's last
  // sequence in the row's last window: the header bytes
  const bool head0 = h > 0 && store[LZ4TT_PC_IS_HEAD];
  const Lz4ttPcSeq q0 = {store[LZ4TT_PC_LIT_START], store[LZ4TT_PC_LIT_LEN],
                         store[LZ4TT_PC_MLEN0], h > 0 ? g_dist[0] : 0, true};
  const int64_t lit0 = store[LZ4TT_PC_SEQ_OFF] + 1 + lz4tt_pc_ext(q0.lit_len);
  if (r == 0 && head0) lz4tt_pc_emit(out, cap, store[LZ4TT_PC_SEQ_OFF], q0);
  if (r == T - 1 && w == lz4tt_pc_windows(n, wl) - 1)
    lz4tt_pc_emit(out, cap, row[1], {row[2], row[3], 0, 0, false});

  // groups 1 .. h - 1: sizes, offsets, header bytes, short literal runs
  for (int32_t j = 1 + r; j < h; j += T)
    sizes[j - 1] = lz4tt_pc_size(lz4tt_pc_local_seq(
        x, g_pos, g_end, g_dist, j, j == h - 1 ? store[LZ4TT_PC_MLENL] : -1));
  t.sync();
  lz4tt_pc_scan(t, sizes, h > 1 ? h - 1 : 0);
  for (int32_t j = 1 + r; j < h; j += T) {
    const Lz4ttPcSeq q = lz4tt_pc_local_seq(
        x, g_pos, g_end, g_dist, j, j == h - 1 ? store[LZ4TT_PC_MLENL] : -1);
    const int64_t o = store[LZ4TT_PC_BASE_OFF] + sizes[j - 1];
    const int64_t lit = lz4tt_pc_emit(out, cap, o, q);
    if (q.lit_len <= LZ4TT_PC_LONG)
      lz4tt_pc_copy(out, cap, x, q.lit_start, lit, q.lit_start,
                    q.lit_start + q.lit_len, 0, 1);
    else
      longs[t.add(queue, 1)] = j;
  }
  t.sync();

  // literal bytes by the whole team: group 0's run from the window's
  // start, the long runs, the run after the window's last group
  if (head0)
    lz4tt_pc_copy(out, cap, x, q0.lit_start, lit0,
                  q0.lit_start > ws ? q0.lit_start : ws,
                  q0.lit_start + q0.lit_len, r, T);
  const int32_t n_long = *queue;
  for (int32_t i = 0; i < n_long; i++) {
    const int32_t j = longs[i];
    const Lz4ttPcSeq q = lz4tt_pc_local_seq(
        x, g_pos, g_end, g_dist, j, j == h - 1 ? store[LZ4TT_PC_MLENL] : -1);
    const int64_t lit = store[LZ4TT_PC_BASE_OFF] + sizes[j - 1] + 1 +
                        lz4tt_pc_ext(q.lit_len);
    lz4tt_pc_copy(out, cap, x, q.lit_start, lit, q.lit_start,
                  q.lit_start + q.lit_len, r, T);
  }
  const int32_t ts = store[LZ4TT_PC_TRAIL_S], te = store[LZ4TT_PC_TRAIL_E];
  lz4tt_pc_copy(out, cap, x, ts, store[LZ4TT_PC_TRAIL_OUT], ts > ws ? ts : ws,
                te < we ? te : we, r, T);
  t.sync();
}
