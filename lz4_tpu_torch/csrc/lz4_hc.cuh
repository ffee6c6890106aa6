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
// state, so control flow stays uniform. The lanes split the chain walk,
// the inserts and byte work (long compares, copies, the tables' resets).
//
// The chain walk, speculated and checked. A chain built by inserts alone
// is its hash bucket in position order, newest first. So at the start of
// a block of at most 64 KiB the team sorts the block's positions by hash
// (a radix sort, lz4tt_hc_index) into one 16-byte record each, a
// bucket's records contiguous: the position, its chain delta (a copy of
// its chain slot, written with it), and the words before, at and after
// it. rank[p] is p's record, and the head table holds the head's rank
// beside its position. A walk reads 32 candidates from a true one on as
// one coalesced load (the next 32 in flight), and lane k checks its link
// against the chain: c_k - chain[c_k] == c_(k+1), or both ends outside
// the window.
// The repetition path's propagation makes a chain leave its bucket's
// order where two phases of a run share a hash; one ballot finds the
// first link that fails, the candidates before it are the true chain,
// and the walk speculates afresh from the true next. The lanes test their
// candidates from the records' words (8 bytes forward, 4 back; the block
// past that up to 32 forward and 8 back); candidates equal past that are
// finished by the team one at a time, in chain order. The winner is the
// longest, the earliest on a tie, and replaces the match only if strictly
// longer, as in the serial loop. Below LZ4TT_HC_SPEC_ATTEMPTS attempts a
// search (where the serial walk measured faster on the card), and in
// blocks past 64 KiB, the walk stays serial.
//
// The inserts go a batch of 32 positions at a time: a position whose
// bucket has an earlier position in the batch links to the latest of
// them (match_any), any other reads the head table as it was before the
// batch, and the bucket's last position of the batch writes the head.
// That is the serial loop's result, whatever the repetition path wrote.
// The search's head comes out of its last batch.
//
// A row's team of warps (the wide kernel's CTA) runs the same
// body by its warp 0, the lead, as a warp team does; the other warps, its
// crew, sort the bucket index with it (lz4tt_hc_index_row) and wait at the
// row's barrier for the waves of a walk the lead asks for: a slice of 32
// candidates a warp, all in flight at once (lz4tt_hc_walk_lead,
// lz4tt_hc_crew). The lead asks for a walk while the row's walks run past
// a slice, and walks alone, as a warp team does, while they do not.
#pragma once

#include <type_traits>

#include "lz4_compress.cuh"  // lz4tt_put, lz4tt_copy, lz4tt_common_*

// Hooks of the host build: a link that failed and was followed into the
// window (the speculation's misses), a record's chain copy read against
// the chain slot it copies, and a wave a row's lead asks its crew for.
#ifndef LZ4TT_HC_FOLLOWED
#define LZ4TT_HC_FOLLOWED()
#endif
#ifndef LZ4TT_HC_ASKED
#define LZ4TT_HC_ASKED()
#endif
#ifndef LZ4TT_HC_CHECK_COPY
#define LZ4TT_HC_CHECK_COPY(copy, slot)
#endif

enum {
  LZ4TT_HC_HASH_LOG = 15,
  LZ4TT_HC_OPTIMAL_ML = 18,  // ML_MASK - 1 + MIN_MATCH
  LZ4TT_HC_MASK = LZ4TT_MAX_DISTANCE - 1,
  // One team's tables: the head table int32[1 << 15] (reset to -1 for
  // each block), the chain uint16[1 << 16] (never reset: a slot is
  // written before it is read within a block; these two hold the radix
  // sort's first pass before that), then the bucket index, rank
  // uint16[1 << 16] and the records, 16 bytes a position (written for
  // each block that speculates).
  LZ4TT_HC_HT_BYTES = 4 << LZ4TT_HC_HASH_LOG,
  LZ4TT_HC_U16_BYTES = 2 * LZ4TT_MAX_DISTANCE,
  LZ4TT_HC_TEAM_BYTES =
      LZ4TT_HC_HT_BYTES + 2 * LZ4TT_HC_U16_BYTES + 16 * LZ4TT_MAX_DISTANCE,
  // the fewest attempts a search (1 << (level - 1)) that speculate: level
  // 5, where the speculated walk first beats the serial one on the card
  LZ4TT_HC_SPEC_ATTEMPTS = 16,
  // the index's counters: of the hash's low 8 bits, then its high 7
  LZ4TT_HC_LO = 256,
  LZ4TT_HC_COUNTS = LZ4TT_HC_LO + (1 << (LZ4TT_HC_HASH_LOG - 8)),
  // the wide kernel's warps a CTA (lz4_hc.cu)
  LZ4TT_HC_ROW_WARPS = 4,
  // what the lead asks its crew for: the row's end, or a wave of the best
  // search's walk or of the wider search's
  LZ4TT_HC_ASK_END = 0,
  LZ4TT_HC_ASK_BEST = 1,
  LZ4TT_HC_ASK_WIDER = 2,
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

// A wave of a walk as the lead asks its crew for it: the kind, the search
// (cur at off, the window from lo, the backward length's limit), the
// wave's first record r, the attempts left and the match's length so far.
struct Lz4ttHcAsk {
  int32_t kind, off, lo, start_limit, r, left, mlen;
  uint32_t cur;
};

// One warp's account of its slice of a wave: its first lane whose link
// fails (kf, the warp's size for none; in: that candidate lies in the
// window), the true next there (at its last lane if none fails), and its
// best candidate: key (len << 8 | 255 - its place in the wave; 0 for none
// longer than the match so far), position and backward length.
struct Lz4ttHcWave {
  int32_t kf, in, next;
  uint32_t key;
  int32_t s, bwd;
};

// A row's team of warps (the wide kernel's CTA): its lane(), size(),
// leader() and sync() (a barrier of all its lanes, called from any place
// in the code) span all its warps; warp() is this lane's warp as a team of
// its own, warp_id() its index, warps() their number (at most 8), ask()
// and waves() the shared ask and accounts (a warp each), and lead() warp
// 0's team. The lead's team is a warp team that also derives from
// Lz4ttHcLead: row() is its row, and `hint` (mutable, false at first)
// whether its last walk ran past a slice.
struct Lz4ttHcLead {};

template <class Team>
constexpr bool lz4tt_hc_lead_v = std::is_base_of<Lz4ttHcLead, Team>::value;

// One block's match finder: the tables and the bucket index in the team's
// scratch, and the next position to insert.
struct Lz4ttHc {
  const uint8_t* src;
  uint8_t* tables;  // the team's scratch (one pointer: fewer registers)
  int32_t match_limit, max_attempts;
  bool spec;  // the walk speculates on the bucket index
  int32_t ntu;
  LZ4TT_HD int32_t* ht() const { return (int32_t*)tables; }
  LZ4TT_HD uint16_t* chain() const {
    return (uint16_t*)(tables + LZ4TT_HC_HT_BYTES);
  }
  LZ4TT_HD uint16_t* rank() const { return chain() + LZ4TT_MAX_DISTANCE; }
  LZ4TT_HD uint32_t* rec() const {  // 4 words a record
    return (uint32_t*)(rank() + LZ4TT_MAX_DISTANCE);
  }
};

// A record of the bucket index: the words at p - 4, p and p + 4 (bytes
// outside the block 0), p << 16 and p's chain delta.
struct Lz4ttHcRec {
  uint32_t back, word, ahead;
  int32_t pos, delta;
};

LZ4TT_HD uint32_t lz4tt_hc_hash(uint32_t v) {
  return lz4tt_hash(v, LZ4TT_HC_HASH_LOG);
}

// The word at i with the bytes outside [0, len) 0.
LZ4TT_HD uint32_t lz4tt_hc_word_in(const uint8_t* src, int32_t i, int32_t len) {
  if (i >= 0 && i + 4 <= len) return lz4tt_read32(src, i);
  uint32_t w = 0;
  for (int k = 0; k < 4; k++)
    if (i + k >= 0 && i + k < len) w |= (uint32_t)src[i + k] << (8 * k);
  return w;
}

// Four words of the team's scratch (16-byte aligned), which the kernel
// itself writes: not through the read-only cache.
LZ4TT_HD void lz4tt_hc_load4(const uint32_t* p, uint32_t a[4]) {
#ifdef __CUDA_ARCH__
  const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
  a[0] = v.x;
  a[1] = v.y;
  a[2] = v.z;
  a[3] = v.w;
#else
  memcpy(a, p, 16);
#endif
}

// Record i, or one at position -1 for i < 0.
LZ4TT_HD Lz4ttHcRec lz4tt_hc_rec(const Lz4ttHc& z, int32_t i) {
  if (i < 0) return {0u, 0u, 0u, -1, 0};
  uint32_t a[4];
  lz4tt_hc_load4(z.rec() + 4 * i, a);
  return {a[0], a[1], a[2], (int32_t)(a[3] >> 16), (int32_t)(a[3] & 0xFFFF)};
}

// Record i's position alone, or -1 for i < 0.
LZ4TT_HD int32_t lz4tt_hc_rec_pos(const Lz4ttHc& z, int32_t i) {
  if (i < 0) return -1;
#ifdef __CUDA_ARCH__
  return (int32_t)(__ldcg(z.rec() + 4 * i + 3) >> 16);
#else
  return (int32_t)(z.rec()[4 * i + 3] >> 16);
#endif
}

// The chain delta of p into its slot, and into its record's copy.
LZ4TT_HD void lz4tt_hc_link(const Lz4ttHc& z, int32_t p, int32_t rank,
                            uint16_t delta) {
  z.chain()[p & LZ4TT_HC_MASK] = delta;
  if (z.spec) ((uint16_t*)(z.rec() + 4 * rank + 3))[0] = delta;
}

// The head table's entry of position p, of rank rk where the walk
// speculates (both in one word: a walk from the head needs no rank load),
// and an entry's position (-1: none).
LZ4TT_HD int32_t lz4tt_hc_head(const Lz4ttHc& z, int32_t p, int32_t rk) {
  return z.spec ? (int32_t)((uint32_t)rk << 16 | (uint32_t)p) : p;
}

LZ4TT_HD int32_t lz4tt_hc_head_pos(const Lz4ttHc& z, int32_t e) {
  return z.spec && e != -1 ? e & 0xFFFF : e;
}

LZ4TT_HD void lz4tt_hc_count(uint32_t* p) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, 1u);
#else
  __atomic_fetch_add(p, 1u, __ATOMIC_RELAXED);
#endif
}

// The lanes whose `bits`-bit digit d equals this lane's, among those where
// valid holds: a ballot a bit.
template <class Team>
LZ4TT_HD unsigned lz4tt_hc_peers(const Team& t, bool valid, uint32_t d,
                                 int bits) {
  unsigned m = t.ballot(valid);
  for (int b = 0; b < bits; b++) {
    const unsigned x = t.ballot((d >> b) & 1u);
    m &= (d >> b) & 1u ? x : ~x;
  }
  return m;
}

// One step of a stable counting sort by a `bits`-bit digit d: this lane's
// slot among the team's items (valid), from the running bases cnt[d].
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_place(const Team& t, uint32_t* cnt, bool valid,
                                uint32_t d, int bits) {
  const int lane = t.lane();
  const unsigned peers = lz4tt_hc_peers(t, valid, d, bits);
  int32_t slot = 0;
  if (valid) slot = (int32_t)cnt[d] + lz4tt_popc(peers & ((1u << lane) - 1u));
  t.sync();  // every lane has read its base
  if (valid && (peers >> lane) == 1u) cnt[d] = slot + 1;
  t.sync();
  return slot;
}

// The exclusive scan of cnt[0, k) in place, k a multiple of the team's
// size: each lane a run.
template <class Team>
LZ4TT_HD void lz4tt_hc_scan(const Team& t, uint32_t* cnt, int32_t k) {
  const int32_t per = k / t.size(), at = t.lane() * per;
  uint32_t sum = 0;
  for (int32_t j = 0; j < per; j++) sum += cnt[at + j];
  uint32_t run = (uint32_t)lz4tt_team_scan(t, (int32_t)sum) - sum;
  for (int32_t j = 0; j < per; j++) {
    const uint32_t c = cnt[at + j];
    cnt[at + j] = run;
    run += c;
  }
}

// The bucket index of src[0, len) by the team, len <= 65536: the records
// of positions [0, len - 3) stably sorted by hash, rank[p] p's record. A
// radix sort of two stable counting passes, by the hash's low 8 bits
// into tmp (len words), then by its high 7 bits into the records; the
// counters (LZ4TT_HC_COUNTS words, shared memory on the card) take one
// histogram pass for both, and lanes of one digit are ranked by ballots.
// The records' chain copies are written by the inserts.
template <class Team>
LZ4TT_HD void lz4tt_hc_index_warp(const Team& t, const uint8_t* src,
                                  int32_t len, uint32_t* counts, uint32_t* tmp,
                                  uint16_t* rank, uint32_t* rec) {
  const int lane = t.lane(), size = t.size();
  const int32_t n = len - (LZ4TT_MIN_MATCH - 1);
  uint32_t* lo = counts;
  uint32_t* hi = counts + LZ4TT_HC_LO;
  for (int32_t i = lane; i < LZ4TT_HC_COUNTS; i += size) counts[i] = 0;
  t.sync();
  for (int32_t p = lane; p < n; p += size) {
    const uint32_t h = lz4tt_hc_hash(lz4tt_read32(src, p));
    lz4tt_hc_count(&lo[h % LZ4TT_HC_LO]);
    lz4tt_hc_count(&hi[h / LZ4TT_HC_LO]);
  }
  t.sync();
  lz4tt_hc_scan(t, lo, LZ4TT_HC_LO);
  lz4tt_hc_scan(t, hi, LZ4TT_HC_COUNTS - LZ4TT_HC_LO);
  t.sync();
  for (int32_t b = 0; b < n; b += size) {
    const int32_t p = b + lane;
    const uint32_t h = p < n ? lz4tt_hc_hash(lz4tt_read32(src, p)) : 0u;
    const int32_t slot = lz4tt_hc_place(t, lo, p < n, h % LZ4TT_HC_LO, 8);
    if (p < n) tmp[slot] = (h / LZ4TT_HC_LO) << 16 | (uint32_t)p;
  }
  t.sync();
  for (int32_t b = 0; b < n; b += size) {
    const int32_t i = b + lane;
    const uint32_t v = i < n ? tmp[i] : 0u;
    const int32_t p = (int32_t)(v & 0xFFFF);
    const int32_t slot = lz4tt_hc_place(t, hi, i < n, v >> 16,
                                        LZ4TT_HC_HASH_LOG - 8);
    if (i < n) {
      const uint32_t r[4] = {lz4tt_hc_word_in(src, p - 4, len),
                             lz4tt_read32(src, p),
                             lz4tt_hc_word_in(src, p + 4, len), (uint32_t)p << 16};
      lz4tt_store16w((uint8_t*)(rec + 4 * slot), r);
      rank[p] = (uint16_t)slot;
    }
  }
  t.sync();
}

// The exclusive scan in place of a row's counters cnt[warp][digits], in
// the order digit by digit and, within a digit, warp by warp: each lane a
// run of that order; part holds a word a warp.
template <class Row>
LZ4TT_HD void lz4tt_hc_row_scan(const Row& t, uint32_t* cnt, int32_t digits,
                                uint32_t* part) {
  const auto w = t.warp();
  const int nw = t.warps(), wi = t.warp_id();
  const int32_t per = digits * nw / t.size(), at = t.lane() * per;
  uint32_t sum = 0;
  for (int32_t j = at; j < at + per; j++) sum += cnt[j % nw * digits + j / nw];
  const uint32_t incl = (uint32_t)lz4tt_team_scan(w, (int32_t)sum);
  if (w.lane() + 1 == w.size()) part[wi] = incl;
  t.sync();
  uint32_t run = incl - sum;
  for (int v = 0; v < wi; v++) run += part[v];
  for (int32_t j = at; j < at + per; j++) {
    uint32_t& c = cnt[j % nw * digits + j / nw];
    const uint32_t k = c;
    c = run;
    run += k;
  }
  t.sync();
}

// The bucket index by a row's warps, lz4tt_hc_index_warp's result: each
// warp sorts a slice of the positions (whole steps of its size) with
// counters of its own, counts[warp][256] of the low digit, then
// counts[warp][128] of the high and a word a warp for the scans
// (LZ4TT_HC_COUNTS + 1 words a warp); the scans order each digit's slots
// warp by warp, so both passes stay stable. The high digit is counted on
// each warp's slice of the first pass's output.
template <class Row>
LZ4TT_HD void lz4tt_hc_index_row(const Row& t, const uint8_t* src,
                                 int32_t len, uint32_t* counts, uint32_t* tmp,
                                 uint16_t* rank, uint32_t* rec) {
  const auto w = t.warp();
  const int lane = w.lane(), size = w.size(), nw = t.warps(), wi = t.warp_id();
  const int32_t n = len - (LZ4TT_MIN_MATCH - 1);
  const int32_t n_hi = LZ4TT_HC_COUNTS - LZ4TT_HC_LO;
  uint32_t* lo = counts + wi * LZ4TT_HC_LO;
  uint32_t* hi = counts + nw * LZ4TT_HC_LO + wi * n_hi;
  uint32_t* part = counts + nw * LZ4TT_HC_COUNTS;
  const int32_t per = ((n + nw - 1) / nw + size - 1) / size * size;
  const int32_t a = wi * per < n ? wi * per : n;
  const int32_t e = a + per < n ? a + per : n;
  for (int32_t i = t.lane(); i < nw * LZ4TT_HC_COUNTS; i += t.size())
    counts[i] = 0;
  t.sync();
  for (int32_t p = a + lane; p < e; p += size)
    lz4tt_hc_count(&lo[lz4tt_hc_hash(lz4tt_read32(src, p)) % LZ4TT_HC_LO]);
  t.sync();
  lz4tt_hc_row_scan(t, counts, LZ4TT_HC_LO, part);
  for (int32_t b = a; b < e; b += size) {
    const int32_t p = b + lane;
    const uint32_t h = p < e ? lz4tt_hc_hash(lz4tt_read32(src, p)) : 0u;
    const int32_t slot = lz4tt_hc_place(w, lo, p < e, h % LZ4TT_HC_LO, 8);
    if (p < e) tmp[slot] = (h / LZ4TT_HC_LO) << 16 | (uint32_t)p;
  }
  t.sync();
  for (int32_t i = a + lane; i < e; i += size) lz4tt_hc_count(&hi[tmp[i] >> 16]);
  t.sync();
  lz4tt_hc_row_scan(t, counts + nw * LZ4TT_HC_LO, n_hi, part);
  for (int32_t b = a; b < e; b += size) {
    const int32_t i = b + lane;
    const uint32_t v = i < e ? tmp[i] : 0u;
    const int32_t p = (int32_t)(v & 0xFFFF);
    const int32_t slot = lz4tt_hc_place(w, hi, i < e, v >> 16,
                                        LZ4TT_HC_HASH_LOG - 8);
    if (i < e) {
      const uint32_t r[4] = {lz4tt_hc_word_in(src, p - 4, len),
                             lz4tt_read32(src, p),
                             lz4tt_hc_word_in(src, p + 4, len), (uint32_t)p << 16};
      lz4tt_store16w((uint8_t*)(rec + 4 * slot), r);
      rank[p] = (uint16_t)slot;
    }
  }
  t.sync();
}

// The bucket index of src[0, len) by the team; a lead's row has sorted it
// with all its warps before (lz4tt_hc_row_block).
template <class Team>
LZ4TT_HD void lz4tt_hc_index(const Team& t, const uint8_t* src, int32_t len,
                             uint32_t* counts, uint32_t* tmp, uint16_t* rank,
                             uint32_t* rec) {
  if constexpr (!lz4tt_hc_lead_v<Team>)
    lz4tt_hc_index_warp(t, src, len, counts, tmp, rank, rec);
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

// commonBytesBackward by one lane up to 8 bytes, from c bytes known
// equal: the bytes equal before o1 and o2, going no lower than l1 and l2.
LZ4TT_HD int32_t lz4tt_hc_back8(const uint8_t* src, int32_t o1, int32_t o2,
                                int32_t l1, int32_t l2, int32_t c) {
  for (; c < 8; c++)
    if (o1 - c <= l1 || o2 - c <= l2 || src[o1 - c - 1] != src[o2 - c - 1])
      break;
  return c;
}

// The same by the team from c bytes known equal on.
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_back_team(const Team& t, const uint8_t* src,
                                    int32_t o1, int32_t o2, int32_t l1,
                                    int32_t l2, int32_t c) {
  for (;;) {
    const int32_t j = c + t.lane();
    const bool stop =
        o1 - j <= l1 || o2 - j <= l2 || src[o1 - j - 1] != src[o2 - j - 1];
    const unsigned m = t.ballot(stop);
    if (m) return c + lz4tt_ffs(m) - 1;
    c += t.size();
  }
}

// commonBytesBackward: 8 bytes by every lane alike, then the team.
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_back(const Team& t, const uint8_t* src, int32_t o1,
                               int32_t o2, int32_t l1, int32_t l2) {
  const int32_t c = lz4tt_hc_back8(src, o1, o2, l1, l2, 0);
  return c < 8 ? c : lz4tt_hc_back_team(t, src, o1, o2, l1, l2, c);
}

// _insert (jax_hc.py:41-59): positions ntu..off-1, a lane a position;
// returns the head table's entry of hash hc after them (cur's bucket: no
// load of the head table after the inserts' stores).
template <class Team>
LZ4TT_HD int32_t lz4tt_hc_insert(const Team& t, Lz4ttHc& z, int32_t off,
                                 uint32_t hc) {
  if (z.ntu >= off) return z.ht()[hc];
  const int lane = t.lane(), size = t.size();
  int32_t head = -1;
  t.sync();
  for (int32_t b = z.ntu; b < off; b += size) {
    const int32_t p = b + lane;
    // one value for the idle lanes: match_any's time grows with the
    // distinct values
    const uint32_t h = p < off ? lz4tt_hc_hash(lz4tt_read32(z.src, p)) : ~0u;
    const int32_t rk = z.spec && p < off ? z.rank()[p] : 0;
    const int32_t before = z.ht()[hc];
    // a batch of one (most searches on incompressible data) needs no match
    const unsigned group = off - b > 1 ? t.match_any(h) : lane == 0 ? 1u : 0u;
    const unsigned below = group & ((1u << lane) - 1u);
    const int32_t prev =
        below ? b + lz4tt_fls(below) : p < off ? lz4tt_hc_head_pos(z, z.ht()[h]) : 0;
    t.sync();  // every lane has read the head table
    if (p < off) {
      int32_t delta = p - prev;
      if (delta > LZ4TT_MAX_DISTANCE - 1) delta = LZ4TT_MAX_DISTANCE - 1;
      lz4tt_hc_link(z, p, rk, (uint16_t)delta);
      if ((group >> lane) == 1u) z.ht()[h] = lz4tt_hc_head(z, p, rk);
    }
    if (b + size >= off) {  // the last batch: cur's bucket's newest
      const unsigned mine = t.ballot(h == hc);
      const int k = mine ? lz4tt_fls(mine) : 0;
      const int32_t rk_k = t.shfl(rk, k);
      head = mine ? lz4tt_hc_head(z, b + k, rk_k) : before;
    }
    t.sync();
  }
  z.ntu = off;
  return head;
}

// The speculated walk of the chain from its first candidate c, with the
// serial loop's result: at most max_attempts candidates, each in the
// window [lo, off], in chain order (rc: c's rank, or -1 if unknown);
// kWide: the wider search (a backward length too, no lower than
// start_limit). m is the match so far. Returns the true candidates walked.
template <bool kWide, class Team>
LZ4TT_HD int32_t lz4tt_hc_walk_warp(const Team& t, const Lz4ttHc& z, int32_t off,
                                 uint32_t cur, int32_t c, int32_t rc,
                                 int32_t lo, int32_t start_limit,
                                 Lz4ttHcMatch& m) {
  if (c < lo || c > off) return 0;
  const uint8_t* src = z.src;
  const int lane = t.lane(), size = t.size();
  // the words after and before cur; the records' words serve while the
  // first forward word lies below match_limit
  const bool ahead = off + 2 * LZ4TT_MIN_MATCH <= z.match_limit;
  const uint32_t cur_ahead = ahead ? lz4tt_read32(src, off + LZ4TT_MIN_MATCH) : 0u;
  const uint32_t cur_back = kWide ? lz4tt_hc_word_in(src, off - 4, off) : 0u;
  // the backward length stops at start_limit on cur's side
  const int32_t back_max = off - start_limit > 0 ? off - start_limit : 0;
  int32_t left = z.max_attempts;
  int32_t r = rc >= 0 ? rc : z.rank()[c];
  // lane k's candidate of this step (the k-th after the first true one)
  // and of the next step
  Lz4ttHcRec x = lz4tt_hc_rec(z, r - lane), x2 = lz4tt_hc_rec(z, r - size - lane);
  for (;;) {
    const int32_t s = x.pos;
    const bool in = s >= lo && s <= off;
    int32_t next = -1, fwd = 0, bwd = 0;
    bool more = false;
    if (in) {
      LZ4TT_HC_CHECK_COPY(x.delta, z.chain()[s & LZ4TT_HC_MASK]);
      next = s - x.delta;
      if (x.word == cur) {
        const uint32_t d = x.ahead ^ cur_ahead;
        fwd = LZ4TT_MIN_MATCH +
              (ahead && d ? (lz4tt_ffs(d) - 1) >> 3
                          : lz4tt_common_words(src, s + LZ4TT_MIN_MATCH,
                                               off + LZ4TT_MIN_MATCH,
                                               z.match_limit, ahead ? 4 : 0));
        more = fwd == LZ4TT_MIN_MATCH + LZ4TT_SHORT_MATCH;
        if (kWide) {
          const uint32_t e = x.back ^ cur_back;
          const int32_t most = s < back_max ? s : back_max;
          bwd = e ? (31 - lz4tt_fls(e)) >> 3 : 4;
          if (bwd > most) bwd = most;
          if (bwd == 4) bwd = lz4tt_hc_back8(src, s, off, 0, start_limit, 4);
          more = more || bwd == 8;
        }
      }
    }
    // lane k's link holds if its true next is lane k + 1's candidate (the
    // last lane's: the next slice's first), or both leave the window
    const int32_t after = t.shfl(s, lane + 1 < size ? lane + 1 : 0);
    const int32_t first2 = t.shfl(x2.pos, 0);
    const int32_t nx = lane + 1 < size ? after : first2;
    const bool holds = in && (next == nx || ((next < lo || next > off) &&
                                             (nx < lo || nx > off)));
    const unsigned fail = t.ballot(!holds), inside = t.ballot(in);
    const int kf = fail ? lz4tt_ffs(fail) - 1 : size;
    const bool kf_in = kf < size && ((inside >> kf) & 1u);
    // the true candidates: lanes [0, kf], less lane kf if it left the window
    int32_t p = kf == size ? size : kf + (kf_in ? 1 : 0);
    bool last = kf < size && !kf_in;
    if (p >= left) {
      p = left;
      last = true;
    }
    if (lane >= p) {
      fwd = bwd = 0;
      more = false;
    }
    // candidates equal past the lanes' bytes: the team, in chain order
    for (unsigned ms = t.ballot(more); ms; ms &= ms - 1) {
      const int k = lz4tt_ffs(ms) - 1;
      const int32_t sk = t.shfl(s, k);
      const int32_t fk = t.shfl(fwd, k), bk = t.shfl(bwd, k);
      int32_t f = 0, g = 0;
      if (fk == LZ4TT_MIN_MATCH + LZ4TT_SHORT_MATCH)
        f = lz4tt_common_bytes(t, src, sk + fk, off + fk, z.match_limit);
      if (kWide && bk == 8)
        g = lz4tt_hc_back_team(t, src, sk, off, 0, start_limit, 8) - 8;
      if (lane == k) {
        fwd += f;
        bwd += g;
      }
    }
    const int32_t len = fwd + bwd;
    const uint32_t key =
        len > m.len ? ((uint32_t)len << 5) | (uint32_t)(31 - lane) : 0u;
    const uint32_t best = t.reduce_max(key);
    if (best) {
      const int w = 31 - (int)(best & 31);
      const int32_t back = t.shfl(bwd, w);
      m.len = (int32_t)(best >> 5);
      m.ref = t.shfl(s, w) - back;
      m.start = off - back;
    }
    if (last) return z.max_attempts - left + p;
    left -= p;
    c = t.shfl(next, p - 1);  // the true next of the last true candidate
    if (c < lo || c > off) return z.max_attempts - left;
    if (kf == size) {  // every link held: c is the next slice's first
      r -= size;
      x = x2;
    } else {  // a link failed: speculate afresh from c
      if (t.leader()) LZ4TT_HC_FOLLOWED();
      r = z.rank()[c];
      x = lz4tt_hc_rec(z, r - lane);
    }
    x2 = lz4tt_hc_rec(z, r - size - lane);
  }
}

// One warp's slice k of a wave of the walk q asks for: lane j's candidate
// x is record q.r - 32k - j, the last lane's successor succ the position
// of record q.r - 32k - 32, the next slice's first. Each lane measures its
// candidate and checks its link as lz4tt_hc_walk_warp's lanes do; the
// slice is cut at its first failing link and at the attempts left, the
// candidates equal past the lanes' bytes finished by the warp in chain
// order, and the rest reduced to the slice's account (on every lane).
template <bool kWide, class Warp>
LZ4TT_HD Lz4ttHcWave lz4tt_hc_slice(const Warp& w, const Lz4ttHc& z,
                                    const Lz4ttHcAsk& q, int k,
                                    const Lz4ttHcRec& x, int32_t succ) {
  const uint8_t* src = z.src;
  const int lane = w.lane(), size = w.size();
  const int32_t off = q.off, lo = q.lo, start_limit = q.start_limit;
  const bool ahead = off + 2 * LZ4TT_MIN_MATCH <= z.match_limit;
  const uint32_t cur_ahead = ahead ? lz4tt_read32(src, off + LZ4TT_MIN_MATCH) : 0u;
  const uint32_t cur_back = kWide ? lz4tt_hc_word_in(src, off - 4, off) : 0u;
  const int32_t back_max = off - start_limit > 0 ? off - start_limit : 0;
  const int32_t s = x.pos;
  const bool in = s >= lo && s <= off;
  int32_t next = -1, fwd = 0, bwd = 0;
  bool more = false;
  if (in) {
    LZ4TT_HC_CHECK_COPY(x.delta, z.chain()[s & LZ4TT_HC_MASK]);
    next = s - x.delta;
    if (x.word == q.cur) {
      const uint32_t d = x.ahead ^ cur_ahead;
      fwd = LZ4TT_MIN_MATCH +
            (ahead && d ? (lz4tt_ffs(d) - 1) >> 3
                        : lz4tt_common_words(src, s + LZ4TT_MIN_MATCH,
                                             off + LZ4TT_MIN_MATCH,
                                             z.match_limit, ahead ? 4 : 0));
      more = fwd == LZ4TT_MIN_MATCH + LZ4TT_SHORT_MATCH;
      if (kWide) {
        const uint32_t e = x.back ^ cur_back;
        const int32_t most = s < back_max ? s : back_max;
        bwd = e ? (31 - lz4tt_fls(e)) >> 3 : 4;
        if (bwd > most) bwd = most;
        if (bwd == 4) bwd = lz4tt_hc_back8(src, s, off, 0, start_limit, 4);
        more = more || bwd == 8;
      }
    }
  }
  const int32_t after = w.shfl(s, lane + 1 < size ? lane + 1 : 0);
  const int32_t nx = lane + 1 < size ? after : succ;
  const bool holds = in && (next == nx || ((next < lo || next > off) &&
                                           (nx < lo || nx > off)));
  const unsigned fail = w.ballot(!holds), inside = w.ballot(in);
  const int kf = fail ? lz4tt_ffs(fail) - 1 : size;
  const bool kf_in = kf < size && ((inside >> kf) & 1u);
  int32_t p = kf == size ? size : kf + (kf_in ? 1 : 0);
  if (p > q.left - k * size) p = q.left - k * size;
  if (lane >= p) {
    fwd = bwd = 0;
    more = false;
  }
  for (unsigned ms = w.ballot(more); ms; ms &= ms - 1) {
    const int j = lz4tt_ffs(ms) - 1;
    const int32_t sj = w.shfl(s, j);
    const int32_t fj = w.shfl(fwd, j), bj = w.shfl(bwd, j);
    int32_t f = 0, g = 0;
    if (fj == LZ4TT_MIN_MATCH + LZ4TT_SHORT_MATCH)
      f = lz4tt_common_bytes(w, src, sj + fj, off + fj, z.match_limit);
    if (kWide && bj == 8)
      g = lz4tt_hc_back_team(w, src, sj, off, 0, start_limit, 8) - 8;
    if (lane == j) {
      fwd += f;
      bwd += g;
    }
  }
  const int32_t len = fwd + bwd;
  const uint32_t key =
      len > q.mlen ? ((uint32_t)len << 8) | (uint32_t)(255 - k * size - lane)
                   : 0u;
  const uint32_t best = w.reduce_max(key);
  const int wl = best ? 255 - (int)(best & 255) - k * size : 0;
  return {kf, kf_in, w.shfl(next, kf < size ? kf : size - 1), best,
          w.shfl(s, wl), w.shfl(bwd, wl)};
}

// The speculated walk by a row's lead and its crew, with
// lz4tt_hc_walk_warp's result: a wave is a slice of candidates a warp of
// the row, the crew's asked for at the row's barrier and their accounts
// read after the next. In chain order, the first failing link ends the
// wave's true candidates, the attempts left cut them, and the longest of
// them, the earliest on a tie, replaces the match if strictly longer; a
// failed link restarts the next wave from the true next. Returns the true
// candidates walked.
template <bool kWide, class Team>
LZ4TT_HD int32_t lz4tt_hc_walk_lead(const Team& t, const Lz4ttHc& z,
                                    int32_t off, uint32_t cur, int32_t c,
                                    int32_t rc, int32_t lo,
                                    int32_t start_limit, Lz4ttHcMatch& m) {
  if (c < lo || c > off) return 0;
  const auto& row = t.row();
  const int lane = t.lane(), size = t.size(), nw = row.warps();
  const int32_t wave = nw * size;
  Lz4ttHcAsk q = {kWide ? LZ4TT_HC_ASK_WIDER : LZ4TT_HC_ASK_BEST, off, lo,
                  start_limit, rc >= 0 ? rc : z.rank()[c], z.max_attempts,
                  m.len, cur};
  // no slice is loaded ahead for a next wave: most walks end in one
  Lz4ttHcRec x = lz4tt_hc_rec(z, q.r - lane);
  for (;;) {
    if (t.leader()) {
      *row.ask() = q;
      LZ4TT_HC_ASKED();
    }
    row.sync();  // the crew takes the wave
    const int32_t succ = lane + 1 == size ? lz4tt_hc_rec_pos(z, q.r - size) : 0;
    Lz4ttHcWave e = lz4tt_hc_slice<kWide>(t, z, q, 0, x, succ);
    row.sync();  // the crew's accounts are in
    uint32_t top = e.key;
    int32_t top_s = e.s, top_bwd = e.bwd;
    int v = 0;
    while (e.kf == size && v + 1 < nw) {
      e = row.waves()[++v];
      if (e.key > top) {
        top = e.key;
        top_s = e.s;
        top_bwd = e.bwd;
      }
    }
    const bool failed = e.kf < size;
    int32_t n_true = failed ? v * size + e.kf + e.in : wave;
    bool last = failed && !e.in;
    if (n_true >= q.left) {
      n_true = q.left;
      last = true;
    }
    if (top) {
      m.len = (int32_t)(top >> 8);
      m.ref = top_s - top_bwd;
      m.start = off - top_bwd;
    }
    if (last) return z.max_attempts - q.left + n_true;
    q.left -= n_true;
    q.mlen = m.len;
    c = e.next;  // the true next of the last true candidate
    if (c < lo || c > off) return z.max_attempts - q.left;
    if (!failed) {  // every link held: c is the next wave's first
      q.r -= wave;
    } else {  // a link failed: speculate afresh from c
      if (t.leader()) LZ4TT_HC_FOLLOWED();
      q.r = z.rank()[c];
    }
    x = lz4tt_hc_rec(z, q.r - lane);
  }
}

// The crew of a row's lead (its warps but 0), on one block: at each wave
// the lead asks for, this warp's slice and its account; until the lead
// ends the row.
template <class Row>
LZ4TT_HD void lz4tt_hc_crew(const Row& row, const Lz4ttHc& z) {
  const auto w = row.warp();
  const int k = row.warp_id(), lane = w.lane(), size = w.size();
  for (;;) {
    row.sync();  // the lead's ask is in
    const Lz4ttHcAsk q = *row.ask();
    if (q.kind == LZ4TT_HC_ASK_END) return;
    const int32_t at = q.r - k * size;
    const Lz4ttHcRec x = lz4tt_hc_rec(z, at - lane);
    const int32_t succ = lane + 1 == size ? lz4tt_hc_rec_pos(z, at - size) : 0;
    const Lz4ttHcWave a = q.kind == LZ4TT_HC_ASK_WIDER
                              ? lz4tt_hc_slice<true>(w, z, q, k, x, succ)
                              : lz4tt_hc_slice<false>(w, z, q, k, x, succ);
    if (lane == 0) row.waves()[k] = a;
    row.sync();  // this warp's account is in
  }
}

// The speculated walk of the chain. A lead walks with its crew when its
// last walk went past a slice (the row's walks run long), else as a warp
// does: a short walk waits on no barrier.
template <bool kWide, class Team>
LZ4TT_HD void lz4tt_hc_walk(const Team& t, const Lz4ttHc& z, int32_t off,
                            uint32_t cur, int32_t c, int32_t rc, int32_t lo,
                            int32_t start_limit, Lz4ttHcMatch& m) {
  if constexpr (lz4tt_hc_lead_v<Team>) {
    t.hint = (t.hint && t.row().warps() > 1
                  ? lz4tt_hc_walk_lead<kWide>(t, z, off, cur, c, rc, lo,
                                              start_limit, m)
                  : lz4tt_hc_walk_warp<kWide>(t, z, off, cur, c, rc, lo,
                                              start_limit, m)) > t.size();
  } else {
    lz4tt_hc_walk_warp<kWide>(t, z, off, cur, c, rc, lo, start_limit, m);
  }
}

// A lead's head-table line of the position 32 ahead, prefetched into L2
// by its lane 0 at each best search: a row of few matches (incompressible
// data) searches at every position, each search first waiting on that line.
template <class Team>
LZ4TT_HD void lz4tt_hc_head_ahead(const Team& t, const Lz4ttHc& z,
                                  int32_t off) {
#ifdef __CUDA_ARCH__
  if (t.leader() && off + 32 + 4 <= z.match_limit)
    asm volatile("prefetch.global.L2 [%0];" ::"l"(
        z.ht() + lz4tt_hc_hash(lz4tt_read32(z.src, off + 32))));
#endif
}

// insertAndFindBestMatch (jax_hc.py:66-152); a length of 0 is no match.
template <class Team>
LZ4TT_HD Lz4ttHcMatch lz4tt_hc_best(const Team& t, Lz4ttHc& z, int32_t off) {
  const uint8_t* src = z.src;
  const uint32_t cur = lz4tt_read32(src, off);
  if constexpr (lz4tt_hc_lead_v<Team>) lz4tt_hc_head_ahead(t, z, off);
  const int32_t head = lz4tt_hc_insert(t, z, off, lz4tt_hc_hash(cur));
  int32_t ref = lz4tt_hc_head_pos(z, head);
  int32_t rref = z.spec && head != -1 ? (int32_t)((uint32_t)head >> 16) : -1;
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
    ref -= z.chain()[ref & LZ4TT_HC_MASK];
    rref = -1;
  }
  const int32_t lo = off - LZ4TT_MAX_DISTANCE + 1 > 0 ? off - LZ4TT_MAX_DISTANCE + 1 : 0;
  if (z.spec) {
    lz4tt_hc_walk<false>(t, z, off, cur, ref, rref, lo, 0, m);
  } else {
    for (int32_t i = 0; i < z.max_attempts; i++) {
      if (ref < lo || ref > off) break;
      const int32_t next = ref - z.chain()[ref & LZ4TT_HC_MASK];
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
      lz4tt_hc_link(z, p, z.spec ? z.rank()[p] : 0, d16);
    if (t.leader()) {
      for (int32_t p = end - rep_delta > off ? end - rep_delta : off; p < end; p++)
        z.ht()[lz4tt_hc_hash(lz4tt_read32(src, p))] =
            lz4tt_hc_head(z, p, z.spec ? z.rank()[p] : 0);
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
  const uint8_t* src = z.src;
  const uint32_t cur = lz4tt_read32(src, off);
  const int32_t head = lz4tt_hc_insert(t, z, off, lz4tt_hc_hash(cur));
  int32_t ref = lz4tt_hc_head_pos(z, head);
  const int32_t lo = off - LZ4TT_MAX_DISTANCE + 1 > 0 ? off - LZ4TT_MAX_DISTANCE + 1 : 0;
  Lz4ttHcMatch m = {0, 0, min_len};
  if (z.spec) {
    lz4tt_hc_walk<true>(t, z, off, cur, ref,
                        z.spec && head != -1 ? (int32_t)((uint32_t)head >> 16) : -1,
                        lo, start_limit, m);
  } else {
    for (int32_t i = 0; i < z.max_attempts; i++) {
      if (ref < lo || ref > off) break;
      const int32_t next = ref - z.chain()[ref & LZ4TT_HC_MASK];
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

// Whether the walks at max_attempts speculate (in the blocks that can).
LZ4TT_HD bool lz4tt_hc_speculates(int32_t max_attempts) {
  return max_attempts >= LZ4TT_HC_SPEC_ATTEMPTS;
}

// One block: src[0, src_len) compressed at max_attempts = 1 << (level - 1)
// into dst[0, dest_cap), no write at or past dst_width; the tables lie in
// the team's slice of scratch (LZ4TT_HC_TEAM_BYTES, 16-byte aligned), the
// index's counters in counts (LZ4TT_HC_COUNTS words; LZ4TT_HC_COUNTS + 1 a
// warp of the row for a lead's team). *out_len is the
// output length, 0 on an error row. kSpec: the body of the levels that
// speculate (lz4tt_hc_speculates); without it, none of the index's code
// is compiled in (the card runs the two as two kernels, each with
// registers of its own).
template <bool kSpec, class Team>
LZ4TT_HD void lz4tt_hc_block_as(const Team& t, const uint8_t* src,
                                int32_t src_len, uint8_t* dst, int32_t dest_cap,
                                int64_t dst_width, int32_t max_attempts,
                                uint8_t* scratch, uint32_t* counts,
                                int32_t* out_len, int32_t* err) {
  // a block with a search (src_len > MIN_LENGTH) whose positions fit the
  // index's uint16
  const bool spec = kSpec && src_len > LZ4TT_MIN_LENGTH &&
                    src_len <= LZ4TT_MAX_DISTANCE;
  Lz4ttHc z = {src, scratch, src_len - LZ4TT_LAST_LITERALS, max_attempts, spec,
               0};
  t.sync();  // every lane is done with the last block's tables
  if (spec)
    lz4tt_hc_index(t, src, src_len, counts, (uint32_t*)scratch,
                   z.rank(), z.rec());
  for (int32_t i = t.lane() * 16; i < LZ4TT_HC_HT_BYTES; i += 16 * t.size()) {
    const uint32_t ones[4] = {~0u, ~0u, ~0u, ~0u};
    lz4tt_store16w(scratch + i, ones);
  }
  t.sync();
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

template <class Team>
LZ4TT_HD void lz4tt_hc_block(const Team& t, const uint8_t* src, int32_t src_len,
                             uint8_t* dst, int32_t dest_cap, int64_t dst_width,
                             int32_t max_attempts, uint8_t* scratch,
                             uint32_t* counts, int32_t* out_len, int32_t* err) {
  if (lz4tt_hc_speculates(max_attempts))
    lz4tt_hc_block_as<true>(t, src, src_len, dst, dest_cap, dst_width,
                            max_attempts, scratch, counts, out_len, err);
  else
    lz4tt_hc_block_as<false>(t, src, src_len, dst, dest_cap, dst_width,
                             max_attempts, scratch, counts, out_len, err);
}

// One block by a row's team (the wide kernel's CTA), at a level that
// speculates, with lz4tt_hc_block's result: all its warps sort the index;
// then its lead runs the block's body as a warp team does and ends the
// row, and the crew takes the waves the lead asks for until then.
template <class Row>
LZ4TT_HD void lz4tt_hc_row_block(const Row& row, const uint8_t* src,
                                 int32_t src_len, uint8_t* dst,
                                 int32_t dest_cap, int64_t dst_width,
                                 int32_t max_attempts, uint8_t* scratch,
                                 uint32_t* counts, int32_t* out_len,
                                 int32_t* err) {
  const bool spec = src_len > LZ4TT_MIN_LENGTH && src_len <= LZ4TT_MAX_DISTANCE;
  const Lz4ttHc z = {src, scratch, src_len - LZ4TT_LAST_LITERALS, max_attempts,
                     spec, 0};
  if (spec) {
    uint32_t* tmp = (uint32_t*)scratch;
    lz4tt_hc_index_row(row, src, src_len, counts, tmp, z.rank(), z.rec());
  }
  if (row.warp_id() == 0) {
    const auto lead = row.lead();
    lz4tt_hc_block_as<true>(lead, src, src_len, dst, dest_cap, dst_width,
                            max_attempts, scratch, counts, out_len, err);
    if (lead.leader()) row.ask()->kind = LZ4TT_HC_ASK_END;
    row.sync();
    return;
  }
  lz4tt_hc_crew(row, z);
}

