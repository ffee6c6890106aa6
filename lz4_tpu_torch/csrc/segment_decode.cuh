// Segment decode of one block from its sequence tables (lz4_parse.cuh) by
// one team (see lz4tt_common.cuh): what
// lz4_tpu/kernels/segment_decode.py::_segment_kernel (:96-153) computes.
// Bytes [0, out_max) of the output row are
//   - literal runs copied from the compressed block,
//   - matches, with overlap, in sequence order,
//   - zeros wherever no sequence writes (null-match holes and the tail).
//
// The JAX kernel trusts its tables (segment_decode.py:21-25). This body
// does not: lz4tt_segment_ok holds every sequence to its row and to the
// order of the output, and a block with one sequence that fails is
// MALFORMED and its row [0, out_max) zeros, so no read leaves
// [0, comp_len) and no write leaves [0, out_max), whatever the tables hold.
//
// Order: sequence k's record is five positions in the output that may not
// go back: the end of sequence k - 1 (0 for the first), lit_out,
// lit_out + lit_len, m_out, m_out + m_len (empty runs and matches
// included). Tables from the parser always pass (a null offset leaves
// m_len 0 and a hole before the next lit_out). So every sequence writes
// after the ones before it, and the block decodes front to back.
//
// A sequence is four pieces, each [p[j], p[j + 1]) of its five positions:
// the gap before its literals (zeros), its literals, the gap before its
// match (zeros) and its match. The team takes a window of team.size()
// sequences, lane i sequence k0 + i, and checks them at once; then it
// queues the window's short pieces (at most LZ4TT_LANE_COPY bytes) as
// K1's copies (lz4_decode.cuh: Lz4ttCopies, a zero gap being a match of
// distance 0), runs them with lz4tt_run_copies into the ring and writes the
// ring out with lz4tt_ring_flush; a longer piece goes to
// lz4tt_team_literals or lz4tt_team_match after a full flush. A batch takes
// whole lanes while it holds at most LZ4TT_BATCH copies and fewer than
// LZ4TT_BATCH_BYTES before the lane, so it adds under 512 + 4 * 64 = 768
// bytes: fewer than 2,816 wait for the flush, and every byte a copy reads
// more than LZ4TT_RING_NEAR back lies more than 2,048 before the batch,
// in the row (see lz4_decode.cuh). The tail [end, out_max) is zeroed once.
#pragma once

#include "lz4_decode.cuh"

// The six tables of one block: row pointers into int32[6, N, max_seq].
struct Lz4ttSeqTables {
  const int32_t* lit_out;
  const int32_t* lit_src;
  const int32_t* lit_len;
  const int32_t* m_out;
  const int32_t* m_dist;
  const int32_t* m_len;
};

// Row b of tables int32[6, n, max_seq].
LZ4TT_HD Lz4ttSeqTables lz4tt_seq_tables(const int32_t* tables, int64_t n,
                                         int64_t max_seq, int64_t b) {
  const int32_t* r = tables + b * max_seq;
  const int64_t f = n * max_seq;
  return {r, r + f, r + 2 * f, r + 3 * f, r + 4 * f, r + 5 * f};
}

// One sequence's record.
struct Lz4ttSeq {
  int32_t lit_out, lit_src, lit_len, m_out, m_dist, m_len;
};

LZ4TT_HD Lz4ttSeq lz4tt_seq_load(const Lz4ttSeqTables& s, int32_t k) {
  return {s.lit_out[k], s.lit_src[k], s.lit_len[k],
          s.m_out[k],   s.m_dist[k],  s.m_len[k]};
}

// Sequence q, after a sequence that ended at prev_end, keeps the order of
// the output and stays inside its block: its literals inside the
// compressed block, its match reading only bytes before it (distance >= 1)
// and ending inside the row.
LZ4TT_HD bool lz4tt_segment_ok(const Lz4ttSeq& q, int64_t prev_end,
                               int32_t comp_len, int32_t out_max) {
  const int64_t lo = q.lit_out, ll = q.lit_len, mo = q.m_out, ml = q.m_len;
  if (ll < 0 || ml < 0 || lo < prev_end || lo + ll > mo || mo + ml > out_max)
    return false;
  if (ll > 0 && (q.lit_src < 0 || (int64_t)q.lit_src + ll > comp_len)) return false;
  if (ml > 0 && (q.m_dist < 1 || mo - q.m_dist < 0)) return false;
  return true;
}

// out[f, e) = 0 by the team: bytes up to the first 16-byte aligned
// address, 16-byte stores, then the tail.
template <class Team>
LZ4TT_HD void lz4tt_team_zero(const Team& t, uint8_t* out, int32_t f, int32_t e) {
  if (e <= f) return;
  int32_t head = (int32_t)((16 - (((uintptr_t)out + f) & 15)) & 15);
  if (head > e - f) head = e - f;
  const int32_t a0 = f + head;
  const int32_t a1 = a0 + ((e - a0) & ~15);
  for (int32_t j = t.lane(); j < head; j += t.size()) out[f + j] = 0;
  for (int32_t c = a0 + 16 * t.lane(); c < a1; c += 16 * t.size()) lz4tt_zero16(out + c);
  for (int32_t j = a1 + t.lane(); j < e; j += t.size()) out[j] = 0;
}

// p[j] for a j known only at run time, by selects rather than an indexed
// (local-memory) array.
template <int N>
LZ4TT_HD int32_t lz4tt_pick(const int32_t (&p)[N], int j) {
  int32_t r = p[0];
#pragma unroll
  for (int i = 1; i < N; i++) r = j == i ? p[i] : r;
  return r;
}

// Decode one block into out[0, out_max); returns its code. ring:
// LZ4TT_RING bytes, 16-byte aligned, and q, both owned by this team.
template <class Team>
LZ4TT_HD int32_t lz4tt_segment_block(const Team& t, const uint8_t* comp,
                                     int32_t comp_len, const Lz4ttSeqTables& s,
                                     int32_t ns, int32_t max_seq, uint8_t* out,
                                     int32_t out_max, uint8_t* ring,
                                     Lz4ttCopies& q) {
  if (ns < 0 || ns > max_seq) {
    lz4tt_team_zero(t, out, 0, out_max);
    return LZ4TT_ERR_MALFORMED;
  }
  const Lz4ttRing r = {ring, (int32_t)((uintptr_t)out & 15)};
  const int w = t.size(), lane = t.lane();
  int32_t d = 0;  // output decoded: the end of the sequences before k0
  int32_t f = 0;  // output [f, d) is only in the ring
  Lz4ttSeq next = {};
  if (lane < ns) next = lz4tt_seq_load(s, lane);
  for (int32_t k0 = 0; k0 < ns; k0 += w) {
    const Lz4ttSeq cur = next;  // sequence k0 + lane; the next window's loads fly
    const int32_t nw = ns - k0 < w ? ns - k0 : w;
    if (k0 + w + lane < ns) next = lz4tt_seq_load(s, k0 + w + lane);
    const bool live = lane < nw;  // lanes past the last sequence hold stale records
    // wrapping, as a garbage record's end only matters once it is checked
    const int32_t end = (int32_t)((uint32_t)cur.m_out + (uint32_t)cur.m_len);
    int32_t prev = t.shfl(end, lane > 0 ? lane - 1 : 0);
    if (lane == 0) prev = d;
    if (t.ballot(live && !lz4tt_segment_ok(cur, prev, comp_len, out_max))) {
      t.sync();  // the ring's write-outs before the zeros
      lz4tt_team_zero(t, out, 0, out_max);
      return LZ4TT_ERR_MALFORMED;
    }
    // the five positions and the sources of the four pieces: a literal
    // run's offset, or -1 - distance for a match (-1, distance 0, zeros)
    const int32_t pos[5] = {prev, cur.lit_out, cur.lit_out + cur.lit_len,
                            cur.m_out, cur.m_out + cur.m_len};
    const int32_t src[4] = {-1, cur.lit_src, -1, -1 - cur.m_dist};
    int32_t j0 = 0, pc = 0;  // the next piece: lane j0's piece pc
    while (j0 < nw) {
      const bool mine = lane >= j0 && lane < nw;
      const int lo = lane == j0 ? pc : 0;
      int big = 4;  // this lane's first long piece from lo
#pragma unroll
      for (int j = 3; j >= 0; j--)
        if (j >= lo && pos[j + 1] - pos[j] > LZ4TT_LANE_COPY) big = j;
      const unsigned longs = t.ballot(mine && big < 4);
      const int lj = longs ? lz4tt_ffs(longs) - 1 : w;  // lane of the first long piece
      const int hi = !mine ? lo : lane < lj ? 4 : lane == lj ? big : lo;
      int32_t cnt = 0, bytes = 0;
#pragma unroll
      for (int j = 0; j < 4; j++) {
        const int32_t n = pos[j + 1] - pos[j];
        if (j >= lo && j < hi && n > 0) {
          cnt++;
          bytes += n;
        }
      }
      // inclusive scan of (copies << 16 | bytes) over the lanes
      const int32_t own = (cnt << 16) | bytes;
      const int32_t incl = lz4tt_team_scan(t, own);
      const int32_t ex = incl - own;
      const bool in = mine && lane <= lj && (ex >> 16) + cnt <= LZ4TT_BATCH &&
                      (ex & 0xFFFF) < LZ4TT_BATCH_BYTES;
      const int m = j0 + lz4tt_popc(t.ballot(in)) - 1;  // the batch's last lane
      if (in) {
        int32_t i = ex >> 16;
#pragma unroll
        for (int j = 0; j < 4; j++) {
          const int32_t n = pos[j + 1] - pos[j];
          if (j >= lo && j < hi && n > 0) {
            q.d[i] = pos[j];
            q.src[i] = src[j];
            q.len[i] = n;
            i++;
          }
        }
      }
      const int32_t n_q = t.shfl(incl >> 16, m);
      d = t.shfl(lz4tt_pick(pos, hi), m);
      t.sync();  // the queue the lanes wrote
      lz4tt_run_copies(t, r, q, n_q, comp, out);
      if (m != lj) {
        if (d - f > LZ4TT_RING_FLUSH) {
          const int32_t e = d - ((d + r.mis) & 15);
          lz4tt_ring_flush(t, r, out, f, e);
          f = e;
        }
        j0 = m + 1;
        pc = 0;
      } else {  // lane lj's piece big, by the team
        lz4tt_ring_flush(t, r, out, f, d);
        const int32_t j = t.shfl(big, lj);
        const int32_t at = t.shfl(lz4tt_pick(pos, big), lj);
        const int32_t to = t.shfl(lz4tt_pick(pos, big + 1), lj);
        const int32_t from = t.shfl(lz4tt_pick(src, big), lj);
        t.sync();  // the flush read ring bytes the piece may overwrite
        if (from >= 0)
          lz4tt_team_literals(t, r, out, at, comp, from, to - at);
        else
          lz4tt_team_match(t, r, out, at, -1 - from, to - at);
        d = f = to;
        j0 = j == 3 ? lj + 1 : lj;
        pc = j == 3 ? 0 : j + 1;
      }
      t.sync();  // the next batch reads what this one wrote
    }
  }
  lz4tt_ring_flush(t, r, out, f, d);
  lz4tt_team_zero(t, out, d, out_max);
  return LZ4TT_OK;
}
