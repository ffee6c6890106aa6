// LZ4 HC compression of one block by one team (see lz4tt_common.cuh).
//
// The algorithm of lz4_tpu/kernels/jax_hc.py::_compress_hc_one (:256-475)
// and of the host HC (lz4_tpu_torch/core/lz4_hc_ref.py, after
// compress_hc.template:17-162 and hashtable.template:23-161), so the
// output is byte-identical to every tier at every level 1..17: a 15-bit
// head table and 16-bit chain deltas indexed off & 0xFFFF, the repetition
// fast path and its chain propagation, the lazy three-match optimizer with
// the match0 restore and the OPTIMAL_ML corrections, and the reference's
// dest checks ((run_len >> 8), (ml >> 8)), so that a tight dest_cap fails
// on exactly the rows where jax_hc fails. Every read of the block stays
// below its length.
//
// Every lane of the team runs the same phase machine on the same scalar
// state, so control flow stays uniform. The lanes split only byte work:
// compares past the first 32 (forward) or 8 (backward) bytes, one byte a
// lane and a ballot a step; literal copies; length extensions; the head
// table's reset. Table writes (the inserts, the repetition's propagation)
// are the leader's alone, between two syncs, and every lane reads the
// tables only between writes. The chain walk stays serial: its order
// decides which candidate wins a tie.
#pragma once

#include "lz4_compress.cuh"  // lz4tt_put, lz4tt_copy, lz4tt_common_*

enum {
  LZ4TT_HC_HASH_LOG = 15,
  LZ4TT_HC_OPTIMAL_ML = 18,  // ML_MASK - 1 + MIN_MATCH
  LZ4TT_HC_MASK = LZ4TT_MAX_DISTANCE - 1,
  // One team's tables: the head table int32[1 << 15] (reset to -1 for
  // each block), then the chain uint16[1 << 16] (never reset: a slot is
  // written before it is read within a block).
  LZ4TT_HC_HT_BYTES = 4 << LZ4TT_HC_HASH_LOG,
  LZ4TT_HC_TEAM_BYTES = LZ4TT_HC_HT_BYTES + 2 * LZ4TT_MAX_DISTANCE,
};

struct Lz4ttHcMatch {
  int32_t start, ref, len;
};

LZ4TT_HD int32_t lz4tt_hc_end(const Lz4ttHcMatch& m) { return m.start + m.len; }

LZ4TT_HD void lz4tt_hc_fix(Lz4ttHcMatch& m, int32_t c) {
  m.start += c;
  m.ref += c;
  m.len -= c;
}

// One block's match finder: the tables and the next position to insert.
struct Lz4ttHc {
  const uint8_t* src;
  int32_t match_limit, max_attempts;
  int32_t* ht;
  uint16_t* chain;
  int32_t ntu;
};

LZ4TT_HD uint32_t lz4tt_hc_hash(uint32_t v) {
  return lz4tt_hash(v, LZ4TT_HC_HASH_LOG);
}

// Length of the common prefix of src[o1..] and src[o2..] with o2 + count
// < limit: the first 32 bytes a word at a time by every lane alike, then
// the team a byte a lane.
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_common(const Team& t, const uint8_t* src, int32_t o1,
                                 int32_t o2, int32_t limit) {
  int32_t c = lz4tt_common_words(src, o1, o2, limit, 0);
  if (c == LZ4TT_SHORT_MATCH)
    c += lz4tt_common_bytes(t, src, o1 + c, o2 + c, limit);
  return c;
}

// commonBytesBackward: the bytes equal before o1 and o2, going no lower
// than l1 and l2; 8 bytes by every lane alike, then the team.
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_back(const Team& t, const uint8_t* src, int32_t o1,
                               int32_t o2, int32_t l1, int32_t l2) {
  int32_t c = 0;
  for (; c < 8; c++)
    if (o1 - c <= l1 || o2 - c <= l2 || src[o1 - c - 1] != src[o2 - c - 1])
      return c;
  for (;;) {
    const int32_t j = c + t.lane();
    const bool stop =
        o1 - j <= l1 || o2 - j <= l2 || src[o1 - j - 1] != src[o2 - j - 1];
    const unsigned m = t.ballot(stop);
    if (m) return c + lz4tt_ffs(m) - 1;
    c += t.size();
  }
}

// _insert (jax_hc.py:41-59): the leader adds positions ntu..off-1.
template <class Team>
LZ4TT_HD void lz4tt_hc_insert(const Team& t, Lz4ttHc& z, int32_t off) {
  if (z.ntu >= off) return;
  t.sync();
  if (t.leader()) {
    for (int32_t p = z.ntu; p < off; p++) {
      const uint32_t h = lz4tt_hc_hash(lz4tt_read32(z.src, p));
      int32_t delta = p - z.ht[h];
      if (delta > LZ4TT_MAX_DISTANCE - 1) delta = LZ4TT_MAX_DISTANCE - 1;
      z.chain[p & LZ4TT_HC_MASK] = (uint16_t)delta;
      z.ht[h] = p;
    }
  }
  z.ntu = off;
  t.sync();
}

// insertAndFindBestMatch (jax_hc.py:66-152); a length of 0 is no match.
template <class Team>
LZ4TT_HD Lz4ttHcMatch lz4tt_hc_best(const Team& t, Lz4ttHc& z, int32_t off) {
  lz4tt_hc_insert(t, z, off);
  const uint8_t* src = z.src;
  const uint32_t cur = lz4tt_read32(src, off);
  int32_t ref = z.ht[lz4tt_hc_hash(cur)];
  Lz4ttHcMatch m = {off, 0, 0};
  int32_t rep_len = 0, rep_delta = 0;
  if (ref >= off - 4 && ref <= off && ref >= 0) {  // a repetition
    if (lz4tt_read32(src, ref) == cur) {
      rep_delta = off - ref;
      rep_len = m.len = LZ4TT_MIN_MATCH +
          lz4tt_hc_common(t, src, ref + LZ4TT_MIN_MATCH, off + LZ4TT_MIN_MATCH,
                          z.match_limit);
      m.ref = ref;
    }
    ref -= z.chain[ref & LZ4TT_HC_MASK];
  }
  const int32_t lo = off - LZ4TT_MAX_DISTANCE + 1 > 0 ? off - LZ4TT_MAX_DISTANCE + 1 : 0;
  for (int32_t i = 0; i < z.max_attempts; i++) {
    if (ref < lo || ref > off) break;
    const int32_t next = ref - z.chain[ref & LZ4TT_HC_MASK];
    if (lz4tt_read32(src, ref) == cur) {
      const int32_t len = LZ4TT_MIN_MATCH +
          lz4tt_hc_common(t, src, ref + LZ4TT_MIN_MATCH, off + LZ4TT_MIN_MATCH,
                          z.match_limit);
      if (len > m.len) {
        m.len = len;
        m.ref = ref;
      }
    }
    ref = next;
  }
  if (rep_len != 0) {
    // the repetition's chain propagation (jax_hc.py:120-150): every
    // position of the run gets the repetition's delta, the last rep_delta
    // positions are hashed too
    const int32_t end = off + rep_len - (LZ4TT_MIN_MATCH - 1);
    const uint16_t d16 = (uint16_t)rep_delta;
    t.sync();
    // slots repeat past 65,536 positions, with the same delta
    const int32_t first = end - off > LZ4TT_MAX_DISTANCE ? end - LZ4TT_MAX_DISTANCE : off;
    for (int32_t p = first + t.lane(); p < end; p += t.size())
      z.chain[p & LZ4TT_HC_MASK] = d16;
    if (t.leader()) {
      for (int32_t p = end - rep_delta > off ? end - rep_delta : off; p < end; p++)
        z.ht[lz4tt_hc_hash(lz4tt_read32(src, p))] = p;
    }
    z.ntu = end;
    t.sync();
  }
  return m;
}

// insertAndFindWiderMatch (jax_hc.py:155-200): true, and the match in *w,
// if one longer than min_len starts at or past start_limit.
template <class Team>
LZ4TT_HD bool lz4tt_hc_wider(const Team& t, Lz4ttHc& z, int32_t off,
                             int32_t start_limit, int32_t min_len,
                             Lz4ttHcMatch* w) {
  lz4tt_hc_insert(t, z, off);
  const uint8_t* src = z.src;
  const uint32_t cur = lz4tt_read32(src, off);
  int32_t ref = z.ht[lz4tt_hc_hash(cur)];
  const int32_t lo = off - LZ4TT_MAX_DISTANCE + 1 > 0 ? off - LZ4TT_MAX_DISTANCE + 1 : 0;
  Lz4ttHcMatch m = {0, 0, min_len};
  for (int32_t i = 0; i < z.max_attempts; i++) {
    if (ref < lo || ref > off) break;
    const int32_t next = ref - z.chain[ref & LZ4TT_HC_MASK];
    if (lz4tt_read32(src, ref) == cur) {
      const int32_t fwd = LZ4TT_MIN_MATCH +
          lz4tt_hc_common(t, src, ref + LZ4TT_MIN_MATCH, off + LZ4TT_MIN_MATCH,
                          z.match_limit);
      const int32_t bwd = lz4tt_hc_back(t, src, ref, off, 0, start_limit);
      if (fwd + bwd > m.len) {
        m.len = fwd + bwd;
        m.ref = ref - bwd;
        m.start = off - bwd;
      }
    }
    ref = next;
  }
  if (m.len <= min_len) return false;
  *w = m;
  return true;
}

// writeLen by the team: len / 255 bytes of 0xFF, then len % 255; returns
// the new d.
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_len(const Team& t, uint8_t* dst, int32_t d,
                              int64_t dst_width, int32_t len) {
  const int32_t k = len / 255;
  for (int32_t j = t.lane(); j < k; j += t.size())
    lz4tt_put(dst, (int64_t)d + j, dst_width, 0xFF);
  if (t.leader()) lz4tt_put(dst, (int64_t)d + k, dst_width, len - 255 * k);
  return d + k + 1;
}

// _encode_sequence (jax_hc.py:203-253): literals src[anchor, m.start) and
// the match; false where the reference finds dest too small.
template <class Team>
LZ4TT_HD bool lz4tt_hc_encode(const Team& t, const uint8_t* src, int32_t anchor,
                              const Lz4ttHcMatch& m, uint8_t* dst,
                              int32_t dest_cap, int64_t dst_width, int32_t& d) {
  const int32_t run = m.start - anchor;
  const int32_t token_off = d++;
  if ((int64_t)d + run + (2 + 1 + LZ4TT_LAST_LITERALS) + (run >> 8) > dest_cap)
    return false;
  uint32_t token;
  if (run >= LZ4TT_RUN_MASK) {
    token = LZ4TT_RUN_MASK << LZ4TT_ML_BITS;
    d = lz4tt_hc_len(t, dst, d, dst_width, run - LZ4TT_RUN_MASK);
  } else {
    token = (uint32_t)run << LZ4TT_ML_BITS;
  }
  lz4tt_copy(t, dst, d, dst_width, src, anchor, run);
  d += run;
  const int32_t dec = m.start - m.ref;
  if (t.leader()) {
    lz4tt_put(dst, d, dst_width, dec & 0xFF);
    lz4tt_put(dst, d + 1, dst_width, (dec >> 8) & 0xFF);
  }
  d += 2;
  const int32_t ml = m.len - LZ4TT_MIN_MATCH;
  if ((int64_t)d + (1 + LZ4TT_LAST_LITERALS) + (ml >> 8) > dest_cap) return false;
  if (ml >= LZ4TT_ML_MASK) {
    token |= LZ4TT_ML_MASK;
    d = lz4tt_hc_len(t, dst, d, dst_width, ml - LZ4TT_ML_MASK);
  } else {
    token |= (uint32_t)ml;
  }
  if (t.leader()) lz4tt_put(dst, token_off, dst_width, token);
  return true;
}

// The phases of compress_hc.template:43-157 (jax_hc.py:275-444), as the
// host HC writes them: main, then search2, then search3. Returns false
// where dest is too small; d is the output length so far.
template <class Team>
LZ4TT_HD bool lz4tt_hc_sequences(const Team& t, Lz4ttHc& z, int32_t src_len,
                                 uint8_t* dst, int32_t dest_cap,
                                 int64_t dst_width, int32_t& d,
                                 int32_t& anchor) {
  const uint8_t* src = z.src;
  const int32_t mf_limit = src_len - LZ4TT_MF_LIMIT;
  int32_t s = 1;
  Lz4ttHcMatch m0, m1, m2, m3;
  while (s < mf_limit) {
    m1 = lz4tt_hc_best(t, z, s);
    if (m1.len == 0) {
      s++;
      continue;
    }
    m0 = m1;  // the first candidate, restored if the search overshoots
    for (bool search2 = true; search2;) {  // search2
      if (lz4tt_hc_end(m1) >= mf_limit ||
          !lz4tt_hc_wider(t, z, lz4tt_hc_end(m1) - 2, m1.start + 1, m1.len,
                          &m2)) {
        if (!lz4tt_hc_encode(t, src, anchor, m1, dst, dest_cap, dst_width, d))
          return false;
        anchor = s = lz4tt_hc_end(m1);
        break;
      }
      if (m0.start < m1.start && m2.start < m1.start + m0.len) m1 = m0;
      if (m2.start - m1.start < 3) {  // the first match is too small
        m1 = m2;
        continue;
      }
      for (;;) {  // search3
        if (m2.start - m1.start < LZ4TT_HC_OPTIMAL_ML) {
          int32_t nl = m1.len < LZ4TT_HC_OPTIMAL_ML ? m1.len : LZ4TT_HC_OPTIMAL_ML;
          if (m1.start + nl > lz4tt_hc_end(m2) - LZ4TT_MIN_MATCH)
            nl = m2.start - m1.start + m2.len - LZ4TT_MIN_MATCH;
          const int32_t corr = nl - (m2.start - m1.start);
          if (corr > 0) lz4tt_hc_fix(m2, corr);
        }
        if (m2.start + m2.len >= mf_limit ||
            !lz4tt_hc_wider(t, z, lz4tt_hc_end(m2) - 3, m2.start, m2.len, &m3)) {
          // no better match: two sequences
          if (m2.start < lz4tt_hc_end(m1)) m1.len = m2.start - m1.start;
          if (!lz4tt_hc_encode(t, src, anchor, m1, dst, dest_cap, dst_width, d))
            return false;
          anchor = s = lz4tt_hc_end(m1);
          if (!lz4tt_hc_encode(t, src, anchor, m2, dst, dest_cap, dst_width, d))
            return false;
          anchor = s = lz4tt_hc_end(m2);
          search2 = false;
          break;
        }
        if (m3.start < lz4tt_hc_end(m1) + 3) {  // no room for match 2
          if (m3.start >= lz4tt_hc_end(m1)) {
            // seq1 now; seq2 dropped, seq3 becomes seq1
            if (m2.start < lz4tt_hc_end(m1)) {
              lz4tt_hc_fix(m2, lz4tt_hc_end(m1) - m2.start);
              if (m2.len < LZ4TT_MIN_MATCH) m2 = m3;
            }
            if (!lz4tt_hc_encode(t, src, anchor, m1, dst, dest_cap, dst_width, d))
              return false;
            anchor = s = lz4tt_hc_end(m1);
            m1 = m3;
            m0 = m2;
            break;  // to search2
          }
          m2 = m3;
          continue;
        }
        // three ascending matches: write at least the first
        if (m2.start < lz4tt_hc_end(m1)) {
          if (m2.start - m1.start < LZ4TT_ML_MASK) {
            if (m1.len > LZ4TT_HC_OPTIMAL_ML) m1.len = LZ4TT_HC_OPTIMAL_ML;
            if (lz4tt_hc_end(m1) > lz4tt_hc_end(m2) - LZ4TT_MIN_MATCH)
              m1.len = lz4tt_hc_end(m2) - m1.start - LZ4TT_MIN_MATCH;
            lz4tt_hc_fix(m2, lz4tt_hc_end(m1) - m2.start);
          } else {
            m1.len = m2.start - m1.start;
          }
        }
        if (!lz4tt_hc_encode(t, src, anchor, m1, dst, dest_cap, dst_width, d))
          return false;
        anchor = s = lz4tt_hc_end(m1);
        m1 = m2;
        m2 = m3;
      }
    }
  }
  return true;
}

// One block: src[0, src_len) compressed at max_attempts = 1 << (level - 1)
// into dst[0, dest_cap), no write at or past dst_width; the tables lie in
// the team's slice of scratch (LZ4TT_HC_TEAM_BYTES, 16-byte aligned).
// *out_len is the output length, 0 on an error row.
template <class Team>
LZ4TT_HD void lz4tt_hc_block(const Team& t, const uint8_t* src, int32_t src_len,
                             uint8_t* dst, int32_t dest_cap, int64_t dst_width,
                             int32_t max_attempts, uint8_t* scratch,
                             int32_t* out_len, int32_t* err) {
  t.sync();  // every lane is done with the last block's tables
  for (int32_t i = t.lane() * 16; i < LZ4TT_HC_HT_BYTES; i += 16 * t.size()) {
    const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
    lz4tt_store16w(scratch + i, ones);
  }
  t.sync();
  Lz4ttHc z = {src, src_len - LZ4TT_LAST_LITERALS, max_attempts,
               (int32_t*)scratch, (uint16_t*)(scratch + LZ4TT_HC_HT_BYTES), 0};
  int32_t d = 0, anchor = 0;
  *out_len = 0;
  *err = LZ4TT_ERR_DEST_TOO_SMALL;
  if (!lz4tt_hc_sequences(t, z, src_len, dst, dest_cap, dst_width, d, anchor))
    return;
  // the last literals (jax_hc.py:456-474)
  const int32_t run = src_len - anchor;
  if ((int64_t)d + run + 1 + (run + 255 - LZ4TT_RUN_MASK) / 255 > dest_cap) return;
  if (run >= LZ4TT_RUN_MASK) {
    if (t.leader()) lz4tt_put(dst, d, dst_width, LZ4TT_RUN_MASK << LZ4TT_ML_BITS);
    d = lz4tt_hc_len(t, dst, d + 1, dst_width, run - LZ4TT_RUN_MASK);
  } else {
    if (t.leader()) lz4tt_put(dst, d, dst_width, (uint32_t)run << LZ4TT_ML_BITS);
    d++;
  }
  lz4tt_copy(t, dst, d, dst_width, src, anchor, run);
  *out_len = d + run;
  *err = LZ4TT_OK;
}
