// LZ4 fast-scan compression of one block by one team (see lz4tt_common.cuh).
//
// The algorithm is the reference's (compress.template:16-261, as in
// lz4_tpu/core/lz4_block_ref.py and lz4_tpu/kernels/jax_codec.py), so the
// output is byte-identical to every tier of the framework: skip
// acceleration, backward catch-up, emission order and bound checks.
// The variant is chosen per block from its own length: below
// LZ4_64K_LIMIT a 13-bit table and no window check, from it on a 12-bit
// table and the MAX_DISTANCE window. Bound checks report DEST_TOO_SMALL
// where the reference raises (jax_codec.py:425,459,541); all writes stay
// below dst_width whatever dest_cap allows.
//
// The scan is serial, so the leader lane runs it alone (lz4tt_scan) and
// the team waits. The leader hands the team two jobs only: a literal run
// of more than LZ4TT_SHORT bytes to copy, and a match that is still equal
// after LZ4TT_SHORT_MATCH bytes to extend. Everything else (probes, table,
// tokens, short runs, match compares a word at a time) is the leader's.
// Between jobs the leader's state lives in Lz4ttScan, so the scan resumes
// where it handed over.
//
// With a dictionary (lz4tt_compress_dict_block), the scan is the native
// compress_ext (lz4_tpu/native/src/tpulz4.cpp:416-542, behind
// native_instances.compress_block_with_dict), byte for byte: the
// dictionary's last <= 65,536 bytes are the window before the block, the
// 12-bit table holds int32 offsets from the window's start and is seeded
// over the dictionary at stride 3 (the last position of a bucket wins),
// the scan starts at the block's first byte, a match must lie 1 to 65,535
// bytes back and may run back into the dictionary, and the bound checks
// reserve the length-extension bytes exactly. The scan reads the block and
// the dictionary where they lie (Lz4ttDictRow); nothing is copied. The
// seeded table comes from the team's own seed or, where every row shares
// one dictionary, from one seed for the whole launch (lz4_compress.cu).
#pragma once

#include "lz4tt_common.cuh"

// The hash table of one block, whichever variant: 1 << 13 uint16_t entries
// below LZ4_64K_LIMIT (every position there is at most 65,534), 1 << 12
// int32_t entries from it on.
enum { LZ4TT_TABLE_BYTES = 1 << 14 };
// The longest literal run the leader copies itself, and the match length
// it compares word by word before it asks the team.
enum { LZ4TT_SHORT = 16, LZ4TT_SHORT_MATCH = 32 };

enum { LZ4TT_JOB_DONE = 0, LZ4TT_JOB_COPY = 1, LZ4TT_JOB_EXTEND = 2 };
// The most dictionary bytes the window holds (64 KiB).
enum { LZ4TT_DICT_MAX = 65536 };

// The bytes a scan reads, by position in the block: the block itself.
struct Lz4ttRow {
  static constexpr bool kDict = false;
  const uint8_t* src;
  LZ4TT_HD int32_t base() const { return 0; }
  LZ4TT_HD uint32_t byte(int32_t p) const { return src[p]; }
  LZ4TT_HD uint32_t read32(int32_t p) const { return lz4tt_read32(src, p); }
};

// The block after a dictionary's tail: position p < 0 is dict_end[p], for
// p >= -dict_len; table entries are offsets from the window's start. Each
// byte's pointer is a select, not a branch, so that a word's four loads
// issue together, as Lz4ttRow's do.
struct Lz4ttDictRow {
  static constexpr bool kDict = true;
  const uint8_t* src;
  const uint8_t* dict_end;
  int32_t dict_len;
  LZ4TT_HD int32_t base() const { return dict_len; }
  LZ4TT_HD uint32_t byte(int32_t p) const { return (p < 0 ? dict_end : src)[p]; }
  LZ4TT_HD uint32_t read32(int32_t p) const {
    return byte(p) | (byte(p + 1) << 8) | (byte(p + 2) << 16) | (byte(p + 3) << 24);
  }
};

// The bytes a length of len takes past its token's nibble (mask 15): the
// native compressor's exact reserve, len_ext_bytes (tpulz4.cpp:186).
LZ4TT_HD int32_t lz4tt_len_ext_bytes(int32_t len) {
  return len >= 15 ? (len - 15) / 255 + 1 : 0;
}

LZ4TT_HD uint32_t lz4tt_hash(uint32_t v, int hash_log) {
  return (v * 2654435761u) >> (32 - hash_log);
}

LZ4TT_HD void lz4tt_put(uint8_t* dst, int64_t pos, int64_t dst_width,
                        uint32_t v) {
  if (pos < dst_width) dst[pos] = (uint8_t)v;
}

// writeLen (LZ4SafeUtils.java:152-158); returns the new d
LZ4TT_HD int32_t lz4tt_write_len(uint8_t* dst, int32_t d, int64_t dst_width,
                                 int32_t len) {
  while (len >= 0xFF) {
    lz4tt_put(dst, d++, dst_width, 0xFF);
    len -= 0xFF;
  }
  lz4tt_put(dst, d++, dst_width, (uint32_t)len);
  return d;
}

// dst[d, d + n) = src[s, s + n) by the team, cut at dst_width; eight
// loads a lane before their stores, so a long run waits for memory once
// per eight steps
template <class Team>
LZ4TT_HD void lz4tt_copy(const Team& t, uint8_t* dst, int64_t d,
                         int64_t dst_width, const uint8_t* src, int64_t s,
                         int64_t n) {
  if (d + n > dst_width) n = dst_width - d;
  for (int64_t j0 = t.lane(); j0 < n; j0 += 8 * t.size()) {
    uint8_t v[8];
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int64_t j = j0 + k * t.size();
      v[k] = j < n ? src[s + j] : 0;
    }
#pragma unroll
    for (int k = 0; k < 8; k++) {
      const int64_t j = j0 + k * t.size();
      if (j < n) dst[d + j] = v[k];
    }
  }
}

// The same for 0 <= n <= LZ4TT_SHORT by one lane: all loads, then the
// stores.
LZ4TT_HD void lz4tt_copy_short(uint8_t* dst, int32_t d, int64_t dst_width,
                               const uint8_t* src, int32_t s, int32_t n) {
  if (n == 0) return;
  uint32_t a[4];
  lz4tt_load_upto16(src, s, n, a);
#pragma unroll
  for (int j = 0; j < LZ4TT_SHORT; j++) {
    if (j >= n) break;
    lz4tt_put(dst, d + j, dst_width, lz4tt_byte16(a, j));
  }
}

// Length of the common prefix of src[o1..] and src[o2..], o1 < o2, with
// o2 + count < limit: each lane compares one byte per step and the ballot
// finds the first mismatch.
template <class Team, class W>
LZ4TT_HD int32_t lz4tt_common_bytes(const Team& t, const W& w, int32_t o1,
                                    int32_t o2, int32_t limit) {
  int32_t count = 0;
  for (;;) {
    const int32_t j = count + t.lane();
    const bool stop = o2 + j >= limit || w.byte(o1 + j) != w.byte(o2 + j);
    const unsigned m = t.ballot(stop);
    if (m) return count + lz4tt_ffs(m) - 1;
    count += t.size();
  }
}

// The same on a plain row (K6's matches).
template <class Team>
LZ4TT_HD int32_t lz4tt_common_bytes(const Team& t, const uint8_t* src,
                                    int32_t o1, int32_t o2, int32_t limit) {
  return lz4tt_common_bytes(t, Lz4ttRow{src}, o1, o2, limit);
}

// The same by one lane, a word at a time from count c (the first c bytes
// known equal), counted up to LZ4TT_SHORT_MATCH: a result of
// LZ4TT_SHORT_MATCH means the first that many bytes are equal and the rest
// is still to count (the team's lz4tt_common_bytes goes on from there).
template <class W>
LZ4TT_HD int32_t lz4tt_common_words(const W& w, int32_t o1, int32_t o2,
                                    int32_t limit, int32_t c) {
  while (c < LZ4TT_SHORT_MATCH) {
    if (o2 + c + 4 > limit) {
      while (o2 + c < limit && w.byte(o1 + c) == w.byte(o2 + c)) c++;
      return c;
    }
    const uint32_t x = w.read32(o1 + c) ^ w.read32(o2 + c);
    if (x) return c + ((lz4tt_ffs(x) - 1) >> 3);
    c += 4;
  }
  return c;
}

// The same on a plain row (K6's matches).
LZ4TT_HD int32_t lz4tt_common_words(const uint8_t* src, int32_t o1,
                                    int32_t o2, int32_t limit, int32_t c) {
  return lz4tt_common_words(Lz4ttRow{src}, o1, o2, limit, c);
}

template <class W>
LZ4TT_HD int32_t lz4tt_common_bytes_backward(const W& w, int32_t o1,
                                             int32_t o2, int32_t l1,
                                             int32_t l2) {
  int32_t count = 0;
  while (o1 - count > l1 && o2 - count > l2 &&
         w.byte(o1 - count - 1) == w.byte(o2 - count - 1))
    count++;
  return count;
}

// table[h] = pos, returning the old entry
template <bool kSmall>
LZ4TT_HD int32_t lz4tt_table_swap(void* table, uint32_t h, int32_t pos) {
  if (kSmall) {
    uint16_t* t16 = (uint16_t*)table;
    const int32_t old = t16[h];
    t16[h] = (uint16_t)pos;
    return old;
  }
  int32_t* t32 = (int32_t*)table;
  const int32_t old = t32[h];
  t32[h] = pos;
  return old;
}

// Whether the old table entry ref of the word cur at s is a match
// (inside the window in the 12-bit variant; with a dictionary also not at
// distance 0). The word at ref is read
// whatever the window test says (every table entry lies in the row or its
// window), so that its load issues with the others of the step.
template <bool kSmall, class W>
LZ4TT_HD bool lz4tt_match_ok(const W& w, int32_t s, int32_t ref,
                             uint32_t cur) {
  const bool same = w.read32(ref) == cur;
  return (kSmall || (s - ref < LZ4TT_MAX_DISTANCE && (!W::kDict || s != ref))) &&
         same;
}

enum {
  LZ4TT_SCAN_FIND,     // probe forward from s with skip acceleration
  LZ4TT_SCAN_OFFSET,   // a match at (s, ref): its offset and length
  LZ4TT_SCAN_MATCHED,  // its length ml known: token, next match or FIND
  LZ4TT_SCAN_LAST,     // the last literals
  LZ4TT_SCAN_END,
};

// The leader's scan state between jobs.
struct Lz4ttScan {
  int32_t mode, s, ref, anchor, d, token, token_off, ml, e;
};

// Run the scan from z until the team must help (a COPY or EXTEND job) or
// the block ends (DONE: a = the compressed length, b = the error code).
// ext is the team's count of the last EXTEND job.
template <bool kSmall, class W>
LZ4TT_HD Lz4ttJob lz4tt_scan(Lz4ttScan& z, int32_t ext, const W& w,
                             int32_t src_len, uint8_t* dst, int32_t dest_cap,
                             int64_t dst_width, void* table) {
  const int hash_log = kSmall ? LZ4TT_HASH_LOG_64K : LZ4TT_HASH_LOG;
  const int32_t src_limit = src_len - LZ4TT_LAST_LITERALS;
  const int32_t mflimit = src_len - LZ4TT_MF_LIMIT;
  if (z.mode == LZ4TT_SCAN_MATCHED) z.ml += ext;  // back from EXTEND
  // the four bytes after the match's first four at s and at ref, read with
  // the probe that found it (pre) so that its length needs no new load
  bool pre = false;
  uint32_t pre_s = 0, pre_ref = 0;
  for (;;) {
    switch (z.mode) {
      case LZ4TT_SCAN_FIND: {
        int32_t fwd = z.s, step = 1, nb = 1 << LZ4TT_SKIP_STRENGTH;
        int32_t s = 0, ref = 0;
        bool found = false;
        // each probe's word read while the probe before it takes its
        // table entry
        uint32_t next = fwd <= mflimit ? w.read32(fwd) : 0u;
        for (;;) {
          s = fwd;
          const uint32_t cur = next;
          fwd += step;
          step = nb >> LZ4TT_SKIP_STRENGTH;
          nb++;
          if (fwd > mflimit) break;
          next = w.read32(fwd);
          ref = lz4tt_table_swap<kSmall>(table, lz4tt_hash(cur, hash_log),
                                         s + w.base()) - w.base();
          if (lz4tt_match_ok<kSmall>(w, s, ref, cur)) {
            found = true;
            break;
          }
        }
        if (!found) {
          z.mode = LZ4TT_SCAN_LAST;
          break;
        }
        const int32_t excess =
            lz4tt_common_bytes_backward(w, ref, s, -w.base(), z.anchor);
        z.s = s - excess;
        z.ref = ref - excess;
        const int32_t run_len = z.s - z.anchor;
        z.token_off = z.d;
        z.d++;
        const int32_t run_ext =
            W::kDict ? lz4tt_len_ext_bytes(run_len) : run_len >> 8;
        if ((int64_t)z.d + run_len + (2 + 1 + LZ4TT_LAST_LITERALS) + run_ext >
            dest_cap) {
          z.e = LZ4TT_ERR_DEST_TOO_SMALL;
          z.mode = LZ4TT_SCAN_END;
          break;
        }
        if (run_len >= LZ4TT_RUN_MASK) {
          z.token = LZ4TT_RUN_MASK << LZ4TT_ML_BITS;
          z.d = lz4tt_write_len(dst, z.d, dst_width, run_len - LZ4TT_RUN_MASK);
        } else {
          z.token = run_len << LZ4TT_ML_BITS;
        }
        const int32_t d0 = z.d;
        z.d += run_len;
        z.mode = LZ4TT_SCAN_OFFSET;
        if (run_len > LZ4TT_SHORT) return {LZ4TT_JOB_COPY, 0, d0, z.anchor, run_len};
        lz4tt_copy_short(dst, d0, dst_width, w.src, z.anchor, run_len);
        [[fallthrough]];
      }
      case LZ4TT_SCAN_OFFSET:
      case LZ4TT_SCAN_MATCHED:
        // A run of matches with no literals between them stays in this
        // loop: offset, length, token, then the probe for the next match.
        for (;;) {
          if (z.mode == LZ4TT_SCAN_OFFSET) {
            const int32_t back = z.s - z.ref;
            lz4tt_put(dst, z.d, dst_width, back & 0xFF);
            lz4tt_put(dst, z.d + 1, dst_width, (back >> 8) & 0xFF);
            z.d += 2;
            z.s += LZ4TT_MIN_MATCH;
            z.ref += LZ4TT_MIN_MATCH;
            const uint32_t x = pre_s ^ pre_ref;
            if (pre && x != 0 && z.s + 4 <= src_limit)
              z.ml = (lz4tt_ffs(x) - 1) >> 3;
            else
              z.ml = lz4tt_common_words(w, z.ref, z.s, src_limit, 0);
            pre = false;
            z.mode = LZ4TT_SCAN_MATCHED;
            if (z.ml == LZ4TT_SHORT_MATCH)
              return {LZ4TT_JOB_EXTEND, 0, z.ref + LZ4TT_SHORT_MATCH,
                      z.s + LZ4TT_SHORT_MATCH, src_limit};
          }
          const int32_t ml = z.ml;
          const int32_t ml_ext = W::kDict ? lz4tt_len_ext_bytes(ml) : ml >> 8;
          if ((int64_t)z.d + (1 + LZ4TT_LAST_LITERALS) + ml_ext > dest_cap) {
            z.e = LZ4TT_ERR_DEST_TOO_SMALL;
            z.mode = LZ4TT_SCAN_END;
            break;
          }
          z.s += ml;
          if (ml >= LZ4TT_ML_MASK) {
            z.token |= LZ4TT_ML_MASK;
            z.d = lz4tt_write_len(dst, z.d, dst_width, ml - LZ4TT_ML_MASK);
          } else {
            z.token |= ml;
          }
          lz4tt_put(dst, z.token_off, dst_width, z.token);
          if (z.s > mflimit) {
            z.anchor = z.s;
            z.mode = LZ4TT_SCAN_LAST;
            break;
          }
          const uint32_t prev = w.read32(z.s - 2);
          const uint32_t cur = w.read32(z.s);
          pre_s = w.read32(z.s + 4);
          lz4tt_table_swap<kSmall>(table, lz4tt_hash(prev, hash_log),
                                   z.s - 2 + w.base());
          z.ref = lz4tt_table_swap<kSmall>(table, lz4tt_hash(cur, hash_log),
                                           z.s + w.base()) - w.base();
          pre_ref = w.read32(z.ref + 4);
          if (!lz4tt_match_ok<kSmall>(w, z.s, z.ref, cur)) {
            z.anchor = z.s;
            z.s++;
            z.mode = LZ4TT_SCAN_FIND;
            break;
          }
          pre = true;
          z.token_off = z.d;
          z.d++;
          z.token = 0;
          z.mode = LZ4TT_SCAN_OFFSET;
        }
        break;
      case LZ4TT_SCAN_LAST: {
        const int32_t run_len = src_len - z.anchor;
        z.mode = LZ4TT_SCAN_END;
        if ((int64_t)z.d + run_len + 1 + (run_len + 255 - LZ4TT_RUN_MASK) / 255 >
            dest_cap) {
          z.e = LZ4TT_ERR_DEST_TOO_SMALL;
          break;
        }
        if (run_len >= LZ4TT_RUN_MASK) {
          lz4tt_put(dst, z.d, dst_width, LZ4TT_RUN_MASK << LZ4TT_ML_BITS);
          z.d = lz4tt_write_len(dst, z.d + 1, dst_width, run_len - LZ4TT_RUN_MASK);
        } else {
          lz4tt_put(dst, z.d, dst_width, (uint32_t)run_len << LZ4TT_ML_BITS);
          z.d++;
        }
        const int32_t d0 = z.d;
        z.d += run_len;
        if (run_len > LZ4TT_SHORT) return {LZ4TT_JOB_COPY, 0, d0, z.anchor, run_len};
        lz4tt_copy_short(dst, d0, dst_width, w.src, z.anchor, run_len);
        break;
      }
      default:
        return {LZ4TT_JOB_DONE, 0, z.d, z.e, 0};
    }
  }
}

// The scan of one block by the team; the reference's first probe is at
// position 1, the dictionary compressor's at 0.
template <bool kSmall, class Team, class W>
LZ4TT_HD void lz4tt_compress_variant(const Team& t, const W& w,
                                     int32_t src_len, uint8_t* dst,
                                     int32_t dest_cap, int64_t dst_width,
                                     void* table, int32_t* out_len,
                                     int32_t* err) {
  Lz4ttScan z = {src_len >= LZ4TT_MIN_LENGTH ? LZ4TT_SCAN_FIND : LZ4TT_SCAN_LAST,
                 W::kDict ? 0 : 1, 0, 0, 0, 0, 0, 0, LZ4TT_OK};
  int32_t ext = 0;
  for (;;) {
    Lz4ttJob j = {};
    if (t.leader()) j = lz4tt_scan<kSmall>(z, ext, w, src_len, dst, dest_cap,
                                           dst_width, table);
    j = lz4tt_bcast_job(t, j);
    if (j.kind == LZ4TT_JOB_DONE) {
      *out_len = j.a;
      *err = j.b;
      return;
    }
    if (j.kind == LZ4TT_JOB_COPY)
      lz4tt_copy(t, dst, j.a, dst_width, w.src, j.b, j.c);
    else
      ext = lz4tt_common_bytes(t, w, j.a, j.b, j.c);
  }
}

// table: LZ4TT_TABLE_BYTES, 16-byte aligned, owned by this team.
template <class Team>
LZ4TT_HD void lz4tt_compress_block(const Team& t, const uint8_t* src,
                                   int32_t src_len, uint8_t* dst,
                                   int32_t dest_cap, int64_t dst_width,
                                   void* table, int32_t* out_len,
                                   int32_t* err) {
  uint32_t* words = (uint32_t*)table;
  for (int i = t.lane(); i < LZ4TT_TABLE_BYTES / 4; i += t.size()) words[i] = 0;
  t.sync();
  const Lz4ttRow w = {src};
  if (src_len < LZ4TT_64K_LIMIT)
    lz4tt_compress_variant<true>(t, w, src_len, dst, dest_cap, dst_width,
                                 table, out_len, err);
  else
    lz4tt_compress_variant<false>(t, w, src_len, dst, dest_cap, dst_width,
                                  table, out_len, err);
}

// table[h] = max(table[h], v), shared by the team's lanes.
LZ4TT_HD void lz4tt_table_max(int32_t* table, uint32_t h, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicMax(table + h, v);
#else
  int32_t old = __atomic_load_n(table + h, __ATOMIC_RELAXED);
  while (old < v && !__atomic_compare_exchange_n(table + h, &old, v, true,
                                                 __ATOMIC_RELAXED,
                                                 __ATOMIC_RELAXED)) {
  }
#endif
}

// The 12-bit table of int32 entries seeded over the dict_len bytes that
// end at dict_end, by the team: position p (every third, while p + 4 <=
// dict_len) goes to its bucket, and the largest p of a bucket stays, as
// the native loop's last write does.
template <class Team>
LZ4TT_HD void lz4tt_dict_seed(const Team& t, const uint8_t* dict_end,
                              int32_t dict_len, int32_t* t32) {
  for (int i = t.lane(); i < (1 << LZ4TT_HASH_LOG); i += t.size()) t32[i] = 0;
  t.sync();
  const uint8_t* wbase = dict_end - dict_len;
  for (int32_t p = 3 * t.lane(); p + 4 <= dict_len; p += 3 * t.size())
    lz4tt_table_max(t32, lz4tt_hash(lz4tt_read32(wbase, p), LZ4TT_HASH_LOG), p);
  t.sync();
}

// One block compressed against the dict_len <= LZ4TT_DICT_MAX bytes that
// end at dict_end: the native compress_ext; dict_len 0 is the plain fast
// compress (tpulz4_compress_fast_ext's fall-through), lz4tt_compress_block.
// The team seeds the table (lz4tt_dict_seed) unless `seeded`: the table
// already holds that seed.
template <class Team>
LZ4TT_HD void lz4tt_compress_dict_block(const Team& t, const uint8_t* src,
                                        int32_t src_len,
                                        const uint8_t* dict_end,
                                        int32_t dict_len, uint8_t* dst,
                                        int32_t dest_cap, int64_t dst_width,
                                        void* table, int32_t* out_len,
                                        int32_t* err, bool seeded = false) {
  if (dict_len == 0) {
    lz4tt_compress_block(t, src, src_len, dst, dest_cap, dst_width, table,
                         out_len, err);
    return;
  }
  if (!seeded) lz4tt_dict_seed(t, dict_end, dict_len, (int32_t*)table);
  const Lz4ttDictRow w = {src, dict_end, dict_len};
  lz4tt_compress_variant<false>(t, w, src_len, dst, dest_cap, dst_width,
                                table, out_len, err);
}
