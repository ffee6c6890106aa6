// LZ4 block decode of one block by one team (see lz4tt_common.cuh), in the
// two contracts of lz4_tpu/kernels/jax_codec.py::_decompress_one.
//
// Safe (kFast = false; agrees with lz4_pallas.py::_decompress_kernel): the
// exact compressed length src_end is known, dest_cap bounds the output.
//   - a token read at or past src_end                      -> MALFORMED
//   - literals reaching into the last COPY_LENGTH bytes of either buffer
//     are the end of the block: past dest_cap              -> DEST_TOO_SMALL,
//     not ending exactly at src_end                        -> MALFORMED
//   - a match offset cut off, reaching before the output start, or a
//     match running past dest_cap                          -> MALFORMED
//   - dest_cap == 0: OK only for the one-byte block "\0", else
//                                                             DEST_TOO_SMALL
// Fast (kFast = true, jax_codec.py:123-235 with fast=True): the exact
// decoded length dest_cap is known and drives the end; src_end is only the
// number of bytes available. It reports src_read, the bytes consumed.
//   - literals reaching into the last COPY_LENGTH bytes of the output are
//     the end of the block, and must end exactly at dest_cap -> MALFORMED
//   - literals reaching past src_end                       -> MALFORMED (in
//     jax_codec the next offset read fails instead; the code is the same)
//   - tokens and matches as in the safe contract
//   - dest_cap == 0: OK when comp[0] is 0, else MALFORMED; src_read 1.
//     comp[0] is read even when src_end is 0, as jax_codec reads it: the
//     caller's row must hold at least one byte.
// A null match offset (0) writes zeros, as in every tier of the framework.
//
// With a history (kHist, the safe contract only; tpulz4.cpp:1060-1202,
// tpulz4_decompress_safe_ext): the h.len <= 65,536 bytes that end at h.end
// are the output before position 0 (a linked block's earlier output, or a
// dictionary's tail), and matches may reach into them; only a match that
// reaches before them is MALFORMED. They are read, never written: before
// the walk the team copies their last LZ4TT_RING bytes into the ring, and
// a match farther back than the ring serves reads them where they lie.
// h.len == 0 decodes exactly as the kernel without a history.
//
// Reads stay in the words that hold bytes below src_end (and comp[0]);
// writes are exactly the decoded bytes [0, out_len), below dest_cap,
// whatever the input.
//
// A row's stated length is not checked on the host (the wrappers would
// have to read it back and wait for the card): lz4tt_decode_row, which
// the kernel runs, makes a length outside [0, the row's stride] the
// row's MALFORMED, with out_len and src_read 0, before any read of the
// row and with nothing written, so every read and write stays in its row.
//
// The token walk is serial, so the leader lane runs it alone
// (lz4tt_decode_walk): it checks each sequence and queues its literal run
// and match, when at most LZ4TT_LANE_COPY bytes each, as copies for the
// team. The team runs a batch of queued copies one a lane
// (lz4tt_run_copies) into a ring of the last LZ4TT_RING output bytes in
// its scratch (shared memory on the card), writes the ring out to the row
// (16-byte stores where the row allows), and copies longer runs and
// matches with all its lanes.
//
// A block of at most LZ4TT_WHOLE bytes may instead keep its whole output in
// the scratch (the ring Lz4ttWhole, in the CTA-a-row kernel's shared
// memory): every match, at any distance, reads the scratch, and the row is
// written once, when the block ends, with 16-byte stores. That kernel also
// splits the row between two teams (lz4tt_split_row, at the end): one
// walks, the other runs the copies behind it. The walk, its checks and the
// bytes written are the same.
#pragma once

#include "lz4tt_common.cuh"

// Output bytes kept in the ring (a power of two, a multiple of 16); the
// longest literal run or match that is queued as one lane's copy; the
// copies queued at most between two team steps, and the output after
// which the leader stops queueing.
enum {
  LZ4TT_RING = 4096,
  LZ4TT_LANE_COPY = 64,
  LZ4TT_BATCH = 32,
  LZ4TT_BATCH_BYTES = 512,
};
// The ring is written out to the row once more than LZ4TT_RING_FLUSH bytes
// wait after a batch; a match farther back than LZ4TT_RING_NEAR reads the
// row. A batch adds less than LZ4TT_BATCH_BYTES + 2 * LZ4TT_LANE_COPY =
// 640 bytes, so fewer than 2,704 wait: a copy never overwrites a byte that
// waits or that a copy of the same batch reads within LZ4TT_RING_NEAR, and
// every byte farther back is in the row.
enum { LZ4TT_RING_FLUSH = 2048, LZ4TT_RING_NEAR = 3072 };
// The most output a block may have to keep all of it in the ring.
enum { LZ4TT_WHOLE = 65536 };

// The history of a block: the len bytes end[-len, 0), the output before
// position 0. Output position p < 0 is end[p].
struct Lz4ttHist {
  const uint8_t* end;
  int32_t len;
};

// The m bytes (1 <= m <= 16) at output position p into a[0..3]: from the
// row, or, before position 0, from the history; a piece that straddles
// the two is read a byte at a time.
template <bool kHist>
LZ4TT_HD void lz4tt_load_window(const uint8_t* out, const Lz4ttHist& h,
                                int32_t p, int32_t m, uint32_t a[4]) {
  if (!kHist || p >= 0) {
    lz4tt_load_upto16(out, p, m, a);
  } else if (p + m <= 0) {
    lz4tt_load_upto16(h.end, p, m, a);
  } else {
#pragma unroll
    for (int k = 0; k < 4; k++) {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 4; i++) {
        const int32_t q = p + 4 * k + i;
        if (4 * k + i < m) w |= (uint32_t)(q < 0 ? h.end[q] : out[q]) << (8 * i);
      }
      a[k] = w;
    }
  }
}

enum {
  LZ4TT_DEC_DONE = 0,
  LZ4TT_DEC_CONT = 1,
  LZ4TT_DEC_LIT = 2,
  LZ4TT_DEC_MATCH = 3,
};

// 0xFF-run length extension (decompress.template:27-33, safe variant):
// a run cut off by the end of the input adds a final 0xFF.
LZ4TT_HD int64_t lz4tt_read_len_ext(const uint8_t* comp, int32_t& s,
                                    int32_t src_end, int64_t len) {
  uint32_t b = 0xFF;
  while (s < src_end) {
    b = comp[s];
    s++;
    if (b != 0xFF) break;
    len += 0xFF;
  }
  return len + b;
}

// Where output position pos lives in a ring of kSize bytes: the ring is
// offset like the row's address, so a 16-byte aligned piece of the row is
// one of the ring. The ring of LZ4TT_WHOLE bytes holds a block's whole
// output (kWhole): nothing goes to the row before the block ends.
template <int kSize>
struct Lz4ttRingOf {
  static constexpr int32_t kBytes = kSize;
  static constexpr bool kWhole = kSize == LZ4TT_WHOLE;
  uint8_t* buf;
  int32_t mis;  // the row's address mod 16
  LZ4TT_HD uint8_t& at(int32_t pos) const {
    return buf[(pos + mis) & (kSize - 1)];
  }
  // 16 bytes from position pos (wrapping), by five aligned word loads
  LZ4TT_HD void load16(int32_t pos, uint32_t a[4]) const {
    const int32_t i = (pos + mis) & (kSize - 1);
    const int32_t w = i & ~3;
    uint32_t v[5];
#pragma unroll
    for (int k = 0; k < 5; k++) v[k] = lz4tt_ld32(buf + ((w + 4 * k) & (kSize - 1)));
#pragma unroll
    for (int k = 0; k < 4; k++) a[k] = lz4tt_funnel_r(v[k], v[k + 1], 8 * (i & 3));
  }
};
using Lz4ttRing = Lz4ttRingOf<LZ4TT_RING>;
using Lz4ttWhole = Lz4ttRingOf<LZ4TT_WHOLE>;

// Ring bytes [f, e) to out[f, e) by the team: bytes up to the first
// 16-byte aligned address, 16-byte stores, then the tail.
template <class Team, class R>
LZ4TT_HD void lz4tt_ring_flush(const Team& t, const R& r, uint8_t* out,
                               int32_t f, int32_t e) {
  if (e <= f) return;
  int32_t head = (16 - ((f + r.mis) & 15)) & 15;
  if (head > e - f) head = e - f;
  const int32_t a0 = f + head;
  const int32_t a1 = a0 + ((e - a0) & ~15);
  for (int32_t j = t.lane(); j < head; j += t.size()) out[f + j] = r.at(f + j);
  for (int32_t c = a0 + 16 * t.lane(); c < a1; c += 16 * t.size())
    lz4tt_store16(out + c, &r.at(c));
  for (int32_t j = a1 + t.lane(); j < e; j += t.size()) out[j] = r.at(j);
}

// A literal run or match of more than LZ4TT_LANE_COPY bytes by the team,
// into the row and, for its last LZ4TT_RING bytes, the ring (a whole ring:
// into the ring alone). A match reads the row (written out before this
// job; a whole ring: the ring): byte j is period[j mod dist], so every
// lane reads only bytes below d; dist 0 writes zeros.
// The literals are read eight a lane before they are written, so a long
// run waits for memory once per eight steps, not once per step.
template <class Team, class R>
LZ4TT_HD void lz4tt_team_literals(const Team& t, const R& r,
                                  uint8_t* out, int32_t d,
                                  const uint8_t* comp, int32_t s, int32_t n) {
  for (int32_t j0 = t.lane(); j0 < n; j0 += 8 * t.size()) {
    uint8_t v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int32_t j = j0 + k * t.size();
      v[k] = j < n ? comp[s + j] : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int32_t j = j0 + k * t.size();
      if (j < n) {
        if (!R::kWhole) out[d + j] = v[k];
        if (R::kWhole || j >= n - LZ4TT_RING) r.at(d + j) = v[k];
      }
    }
  }
}

template <bool kHist = false, class Team, class R>
LZ4TT_HD void lz4tt_team_match(const Team& t, const R& r, uint8_t* out,
                               int32_t d, int32_t dist, int32_t n,
                               const Lz4ttHist& h = Lz4ttHist{nullptr, 0}) {
  if (dist == 0) {
    for (int32_t j = t.lane(); j < n; j += t.size()) {
      if (!R::kWhole) out[d + j] = 0;
      if (R::kWhole || j >= n - LZ4TT_RING) r.at(d + j) = 0;
    }
    return;
  }
  const int32_t p0 = d - dist;  // before 0 only with a history
  int32_t k = t.lane() % dist;
  const int32_t step = t.size() % dist;
  for (int32_t j = t.lane(); j < n; j += t.size()) {
    const int32_t q = p0 + k;
    const uint8_t v = R::kWhole ? r.at(q) : kHist && q < 0 ? h.end[q] : out[q];
    if (!R::kWhole) out[d + j] = v;
    if (R::kWhole || j >= n - LZ4TT_RING) r.at(d + j) = v;
    k += step;
    if (k >= dist) k -= dist;
  }
}

// The match of distance dist and length n <= LZ4TT_LANE_COPY at d, by one
// lane into the ring, 16 bytes at a time, all loads of a piece before its
// stores: its source bytes (all below d) come from the ring when they lie
// within LZ4TT_RING_NEAR (a whole ring: always), else from the row, which
// holds everything that far back (see LZ4TT_RING_FLUSH), or before
// position 0 from the history. A match of period dist < 16 shorter
// than itself repeats the period from registers (byte j is byte j mod
// dist); a longer period copies piece by piece, each piece reading bytes
// an earlier one wrote. dist 0 writes zeros.
template <bool kHist = false, class R>
LZ4TT_HD void lz4tt_lane_match(const R& r, const uint8_t* out,
                               int32_t d, int32_t dist, int32_t n,
                               const Lz4ttHist& h = Lz4ttHist{nullptr, 0}) {
  uint32_t a[4] = {0u, 0u, 0u, 0u};
  if (dist > 0 && dist < 16 && dist < n) {
    r.load16(d - dist, a);
    int k = 0;
    for (int32_t j = 0; j < n; j++) {
      r.at(d + j) = (uint8_t)lz4tt_byte16(a, k);
      if (++k == dist) k = 0;
    }
    return;
  }
  for (int32_t c = 0; c < n; c += 16) {
    const int32_t m = n - c < 16 ? n - c : 16;
    if (!R::kWhole && dist > LZ4TT_RING_NEAR)
      lz4tt_load_window<kHist>(out, h, d - dist + c, m, a);
    else if (dist > 0)
      r.load16(d - dist + c, a);
#pragma unroll
    for (int j = 0; j < 16; j++) {
      if (j >= m) break;
      r.at(d + c + j) = (uint8_t)lz4tt_byte16(a, j);
    }
  }
}

// The literal run comp[s, s + n), 1 <= n <= LZ4TT_LANE_COPY, at d, by one
// lane into the ring.
template <class R>
LZ4TT_HD void lz4tt_lane_literals(const R& r, int32_t d,
                                  const uint8_t* comp, int32_t s, int32_t n) {
  uint32_t a[4];
  for (int32_t c = 0; c < n; c += 16) {
    const int32_t m = n - c < 16 ? n - c : 16;
    lz4tt_load_upto16(comp, s + c, m, a);
#pragma unroll
    for (int j = 0; j < 16; j++) {
      if (j >= m) break;
      r.at(d + c + j) = (uint8_t)lz4tt_byte16(a, j);
    }
  }
}

enum { LZ4TT_DEC_TOKEN, LZ4TT_DEC_OFFSET, LZ4TT_DEC_END };

// The short copies the leader queues for its team, one a lane: at output
// position d, len <= LZ4TT_LANE_COPY bytes of literals comp[src, ...) if
// src >= 0, else of the match of distance -1 - src.
struct Lz4ttCopies {
  int32_t d[LZ4TT_BATCH], src[LZ4TT_BATCH], len[LZ4TT_BATCH];
};

// The leader's walk state between batches: the next token (or the offset
// of the token read last) at s, output decoded up to d.
struct Lz4ttDecState {
  int32_t mode, s, d, token, e;
};

// Walk tokens from z, checking each sequence and queueing its short copies
// in q, until the queue is full (CONT), a literal run or match is longer
// than LZ4TT_LANE_COPY (LIT, MATCH: a = its output position, b = its
// literals' offset or its distance, c = its length), or the block ends
// (DONE: a = out_len, b = src_read, c = err). n is the number of queued
// copies; CONT also gives a = the output decoded so far.
// hist_len is the bytes of history before the output (0 without one).
template <bool kFast>
LZ4TT_HD Lz4ttJob lz4tt_decode_walk(Lz4ttDecState& z, Lz4ttCopies& q,
                                    const uint8_t* comp, int32_t src_end,
                                    int32_t dest_cap, int32_t hist_len = 0) {
  int32_t n = 0;
  int32_t s = z.s, d = z.d, token = z.token;
  const int32_t d0 = d;
  Lz4ttJob j;
  for (;;) {
    if (z.mode == LZ4TT_DEC_END) {
      j = {LZ4TT_DEC_DONE, n, d, s, z.e};
      break;
    }
    int32_t dist = -1;  // read with the token when it has no literals
    if (z.mode == LZ4TT_DEC_TOKEN) {
      // The common sequence of compressible data, four at a time: no
      // literals and a match of 4-18 bytes (a token of at most 14) that
      // starts inside the output, with both ends far enough away that no
      // other check applies. The next four are 3 bytes each if they are
      // such sequences, so their tokens and offsets are read at once; the
      // first that is not leaves the run to the general walk below.
      while (n <= LZ4TT_BATCH - 4 && d - d0 < LZ4TT_BATCH_BYTES &&
             s + 21 <= src_end && (int64_t)d + 80 <= dest_cap) {
        int32_t tk[4], ds[4];
#pragma unroll
        for (int k = 0; k < 4; k++) {
          tk[k] = comp[s + 3 * k];
          ds[k] = (int32_t)comp[s + 3 * k + 1] | ((int32_t)comp[s + 3 * k + 2] << 8);
        }
        int k = 0;
#pragma unroll
        for (; k < 4; k++) {
          if (tk[k] > 14 || d + hist_len < ds[k]) break;
          q.d[n] = d;
          q.src[n] = -1 - ds[k];
          q.len[n] = tk[k] + LZ4TT_MIN_MATCH;
          n++;
          d += tk[k] + LZ4TT_MIN_MATCH;
          s += 3;
        }
        if (k < 4) break;
      }
      if (n > LZ4TT_BATCH - 2 || d - d0 >= LZ4TT_BATCH_BYTES) {
        j = {LZ4TT_DEC_CONT, n, d, 0, 0};
        break;
      }
      if (s >= src_end) {
        z.e = LZ4TT_ERR_MALFORMED;
        z.mode = LZ4TT_DEC_END;
        continue;
      }
      token = comp[s];
      const int32_t b1 = s + 1 < src_end ? comp[s + 1] : 0;
      const int32_t b2 = s + 2 < src_end ? comp[s + 2] : 0;
      s++;
      int64_t lit_len = token >> LZ4TT_ML_BITS;
      if (lit_len == LZ4TT_RUN_MASK) lit_len = lz4tt_read_len_ext(comp, s, src_end, lit_len);
      const int64_t lit_end = (int64_t)d + lit_len;
      const int64_t lit_src_end = (int64_t)s + lit_len;
      bool last = false;
      if (kFast) {
        if (lit_src_end > src_end) {
          z.e = LZ4TT_ERR_MALFORMED;
          z.mode = LZ4TT_DEC_END;
          continue;
        }
        if (lit_end > (int64_t)dest_cap - LZ4TT_COPY_LENGTH) {
          if (lit_end != dest_cap) {
            z.e = LZ4TT_ERR_MALFORMED;
            z.mode = LZ4TT_DEC_END;
            continue;
          }
          last = true;
        }
      } else if (lit_end > (int64_t)dest_cap - LZ4TT_COPY_LENGTH ||
                 lit_src_end > (int64_t)src_end - LZ4TT_COPY_LENGTH) {
        if (lit_end > dest_cap) {
          z.e = LZ4TT_ERR_DEST_TOO_SMALL;
        } else if (lit_src_end != src_end) {
          z.e = LZ4TT_ERR_MALFORMED;
        } else {
          last = true;
        }
        if (!last) {
          z.mode = LZ4TT_DEC_END;
          continue;
        }
      }
      // here s + lit_len <= src_end and lit_end <= dest_cap
      const int32_t n_lit = (int32_t)lit_len;
      z.mode = last ? LZ4TT_DEC_END : LZ4TT_DEC_OFFSET;
      if (n_lit > LZ4TT_LANE_COPY) {
        j = {LZ4TT_DEC_LIT, n, d, s, n_lit};
        s += n_lit;
        d += n_lit;
        break;
      }
      if (n_lit > 0) {
        q.d[n] = d;
        q.src[n] = s;
        q.len[n] = n_lit;
        n++;
      } else if (s + 2 <= src_end) {
        dist = b1 | (b2 << 8);
      }
      s += n_lit;
      d += n_lit;
      if (last) continue;
    }
    // LZ4TT_DEC_OFFSET
    if (s + 2 > src_end) {
      z.e = LZ4TT_ERR_MALFORMED;
      z.mode = LZ4TT_DEC_END;
      continue;
    }
    if (dist < 0) dist = (int32_t)comp[s] | ((int32_t)comp[s + 1] << 8);
    s += 2;
    int64_t m_len = token & LZ4TT_ML_MASK;
    if (m_len == LZ4TT_ML_MASK) m_len = lz4tt_read_len_ext(comp, s, src_end, m_len);
    m_len += LZ4TT_MIN_MATCH;
    if (d + hist_len - dist < 0 || (int64_t)d + m_len > dest_cap) {
      z.e = LZ4TT_ERR_MALFORMED;
      z.mode = LZ4TT_DEC_END;
      continue;
    }
    z.mode = LZ4TT_DEC_TOKEN;
    const int32_t n_match = (int32_t)m_len;
    if (n_match > LZ4TT_LANE_COPY) {
      j = {LZ4TT_DEC_MATCH, n, d, dist, n_match};
      d += n_match;
      break;
    }
    q.d[n] = d;
    q.src[n] = -1 - dist;
    q.len[n] = n_match;
    n++;
    d += n_match;
  }
  z.s = s;
  z.d = d;
  z.token = token;
  return j;
}

// The n queued copies, one a lane, in waves: a copy runs once every byte it
// reads of the output lies below the first copy still waiting, so each
// wave reads only what earlier waves (or batches) wrote.
template <bool kHist = false, class Team, class R>
LZ4TT_HD void lz4tt_run_copies(const Team& t, const R& r,
                               const Lz4ttCopies& q, int32_t n,
                               const uint8_t* comp, const uint8_t* out,
                               const Lz4ttHist& h = Lz4ttHist{nullptr, 0}) {
  for (int32_t i0 = 0; i0 < n; i0 += t.size()) {
    const int32_t i = i0 + t.lane();
    bool todo = i < n;
    int32_t d = 0, src = 0, len = 0, need = 0;
    if (todo) {
      d = q.d[i];
      src = q.src[i];
      len = q.len[i];
      const int32_t dist = -1 - src;
      if (src < 0 && dist > 0) need = d - dist + (len < dist ? len : dist);
    }
    for (;;) {
      const unsigned waiting = t.ballot(todo);
      if (!waiting) break;
      const int32_t frontier = t.shfl(d, lz4tt_ffs(waiting) - 1);
      if (todo && need <= frontier) {
        if (src >= 0)
          lz4tt_lane_literals(r, d, comp, src, len);
        else
          lz4tt_lane_match<kHist>(r, out, d, -1 - src, len, h);
        todo = false;
      }
      t.sync();
    }
  }
}

// ring: R::kBytes bytes (LZ4TT_RING, or LZ4TT_WHOLE >= dest_cap for a
// whole ring), 16-byte aligned, and q, both owned by this team. With kHist,
// h is the block's history (the safe contract only, a ring of LZ4TT_RING).
template <bool kFast, bool kHist = false, class R = Lz4ttRing, class Team>
LZ4TT_HD void lz4tt_decode_block(const Team& t, const uint8_t* comp,
                                 int32_t src_end, uint8_t* out,
                                 int32_t dest_cap, uint8_t* ring,
                                 Lz4ttCopies& q, int32_t* out_len,
                                 int32_t* src_read, int32_t* err,
                                 const Lz4ttHist& h = Lz4ttHist{nullptr, 0}) {
  if (dest_cap == 0) {
    *out_len = 0;
    *src_read = 1;
    if (kFast)
      *err = comp[0] == 0 ? LZ4TT_OK : LZ4TT_ERR_MALFORMED;
    else
      *err = src_end == 1 && comp[0] == 0 ? LZ4TT_OK : LZ4TT_ERR_DEST_TOO_SMALL;
    return;
  }
  static_assert(!(kHist && R::kWhole), "a whole ring has no room for a history");
  const R r = {ring, (int32_t)((uintptr_t)out & 15)};
  const int32_t hist_len = kHist ? h.len : 0;
  if (kHist) {  // the ring's bytes before position 0: the history's tail
    const int32_t k = hist_len < LZ4TT_RING ? hist_len : LZ4TT_RING;
    for (int32_t j = t.lane(); j < k; j += t.size()) r.at(-1 - j) = h.end[-1 - j];
    t.sync();
  }
  Lz4ttDecState z = {LZ4TT_DEC_TOKEN, 0, 0, 0, LZ4TT_OK};
  int32_t f = 0;  // output [f, d) is only in the ring
  for (;;) {
    Lz4ttJob j = {};
    if (t.leader())
      j = lz4tt_decode_walk<kFast>(z, q, comp, src_end, dest_cap, hist_len);
    j = lz4tt_bcast_job(t, j);
    t.sync();  // the queue the leader wrote
    lz4tt_run_copies<kHist>(t, r, q, j.n, comp, out, h);
    const int32_t d = j.a;
    if (R::kWhole) {  // the row is written once, when the block ends
      if (j.kind == LZ4TT_DEC_DONE) lz4tt_ring_flush(t, r, out, 0, d);
    } else if (j.kind == LZ4TT_DEC_CONT) {
      if (d - f > LZ4TT_RING_FLUSH) {
        const int32_t e = d - ((d + r.mis) & 15);
        lz4tt_ring_flush(t, r, out, f, e);
        f = e;
      }
    } else {
      lz4tt_ring_flush(t, r, out, f, d);
      f = d;
    }
    if (j.kind == LZ4TT_DEC_DONE) {
      *out_len = d;
      *src_read = j.b;
      *err = j.c;
      return;
    }
    if (j.kind == LZ4TT_DEC_LIT) {
      t.sync();  // the flush read ring bytes the copy may overwrite
      lz4tt_team_literals(t, r, out, d, comp, j.b, j.c);
      f = d + j.c;
    } else if (j.kind == LZ4TT_DEC_MATCH) {
      t.sync();  // the match reads bytes the flush wrote
      lz4tt_team_match<kHist>(t, r, out, d, j.b, j.c, h);
      f = d + j.c;
    }
    t.sync();  // the next batch reads what this one wrote
  }
}

// lz4tt_decode_block on a row of comp_stride bytes whose stated length
// (src_end: the exact size, or the bytes available when kFast) may lie
// outside [0, comp_stride]: such a row is MALFORMED, with *out_len and
// *src_read 0, and nothing of it is read (comp[0] included) or written.
// The test is uniform across the team. A bad row walks as a row of no
// bytes, whose first token check ends it, rather than returning here: on
// an H100 (the fast read's 3,072 rows) K1 takes about 0.7 % longer with
// this test than without it, and about 1.3 % with an early return.
template <bool kFast, bool kHist = false, class R = Lz4ttRing, class Team>
LZ4TT_HD void lz4tt_decode_row(const Team& t, const uint8_t* comp,
                               int64_t comp_stride, int32_t src_end,
                               uint8_t* out, int32_t dest_cap, uint8_t* ring,
                               Lz4ttCopies& q, int32_t* out_len,
                               int32_t* src_read, int32_t* err,
                               const Lz4ttHist& h = Lz4ttHist{nullptr, 0}) {
  const bool bad = (uint64_t)(uint32_t)src_end > (uint64_t)comp_stride;
  if (bad && dest_cap == 0) {  // the body would read comp[0]
    *out_len = 0;
    *src_read = 0;
    *err = LZ4TT_ERR_MALFORMED;
    return;
  }
  lz4tt_decode_block<kFast, kHist, R>(t, comp, bad ? 0 : src_end, out,
                                      dest_cap, ring, q, out_len, src_read,
                                      err, h);
}

// The safe decode of one row with the walk decoupled from the copies (the
// CTA-a-row kernel's): two teams share the row. The walker's leader walks
// the tokens (lz4tt_decode_walk) and fills the LZ4TT_SLOTS slots in turn,
// a batch of queued copies and its job each; the copier runs each slot's
// copies and job, in order, into a whole ring (Lz4ttWhole: out_max <=
// LZ4TT_WHOLE), and writes the row out when the walk ends. The walker
// never waits for a copy, only for a slot to come free. The pipe P orders
// the two: wait_empty(t, s) / fill(t, s) on the walker's side,
// wait_full(t, s) / empty(t, s) on the copier's; every member of a team
// calls them (named barriers on the card, semaphores in the host build).
enum { LZ4TT_SLOTS = 4 };

struct Lz4ttSlot {
  Lz4ttCopies q;
  Lz4ttJob j;
};

template <class Team, class P>
LZ4TT_HD void lz4tt_split_walk(const Team& t, const P& p, Lz4ttSlot* slots,
                               const uint8_t* comp, int32_t src_end,
                               int32_t dest_cap) {
  Lz4ttDecState z = {LZ4TT_DEC_TOKEN, 0, 0, 0, LZ4TT_OK};
  int32_t i = 0;
  for (;; i++) {
    const int32_t s = i % LZ4TT_SLOTS;
    if (i >= LZ4TT_SLOTS) p.wait_empty(t, s);
    int32_t kind = 0;
    if (t.leader()) {
      slots[s].j = lz4tt_decode_walk<false>(z, slots[s].q, comp, src_end,
                                            dest_cap);
      kind = slots[s].j.kind;
    }
    kind = t.bcast(kind);
    p.fill(t, s);
    if (kind == LZ4TT_DEC_DONE) break;
  }
  // the copier empties every slot it took but the last: take those signals
  for (int32_t k = i + 1; k < i + LZ4TT_SLOTS; k++)
    if (k >= LZ4TT_SLOTS) p.wait_empty(t, k % LZ4TT_SLOTS);
}

template <class Team, class P>
LZ4TT_HD void lz4tt_split_copy(const Team& t, const P& p, const Lz4ttWhole& r,
                               const Lz4ttSlot* slots, const uint8_t* comp,
                               uint8_t* out, int32_t* out_len, int32_t* err) {
  for (int32_t i = 0;; i++) {
    const int32_t s = i % LZ4TT_SLOTS;
    p.wait_full(t, s);
    const Lz4ttJob j = slots[s].j;
    lz4tt_run_copies(t, r, slots[s].q, j.n, comp, out);
    if (j.kind == LZ4TT_DEC_LIT)
      lz4tt_team_literals(t, r, out, j.a, comp, j.b, j.c);
    else if (j.kind == LZ4TT_DEC_MATCH)
      lz4tt_team_match(t, r, out, j.a, j.b, j.c);
    t.sync();  // the next batch and the write-out read what this one wrote
    if (j.kind == LZ4TT_DEC_DONE) {
      lz4tt_ring_flush(t, r, out, 0, j.a);
      *out_len = j.a;
      *err = j.c;
      return;
    }
    p.empty(t, s);
  }
}

// One row of the split decode in the safe contract, by the walker team
// (walker) or the copier team: the row guard and the empty capacity of
// lz4tt_decode_row and lz4tt_decode_block, then each team's part. ring:
// LZ4TT_WHOLE bytes, 16-byte aligned; slots: LZ4TT_SLOTS; both shared by
// the two teams. The copier sets *out_len and *err.
template <class Team, class P>
LZ4TT_HD void lz4tt_split_row(const Team& t, bool walker, const P& p,
                              const uint8_t* comp, int64_t comp_stride,
                              int32_t src_end, uint8_t* out, int32_t dest_cap,
                              uint8_t* ring, Lz4ttSlot* slots,
                              int32_t* out_len, int32_t* err) {
  const bool bad = (uint64_t)(uint32_t)src_end > (uint64_t)comp_stride;
  if (dest_cap == 0) {
    if (!walker) {
      *out_len = 0;
      *err = bad ? LZ4TT_ERR_MALFORMED
                 : src_end == 1 && comp[0] == 0 ? LZ4TT_OK
                                                : LZ4TT_ERR_DEST_TOO_SMALL;
    }
    return;
  }
  if (walker) {
    lz4tt_split_walk(t, p, slots, comp, bad ? 0 : src_end, dest_cap);
  } else {
    const Lz4ttWhole r = {ring, (int32_t)((uintptr_t)out & 15)};
    lz4tt_split_copy(t, p, r, slots, comp, out, out_len, err);
  }
}
