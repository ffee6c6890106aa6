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
template <class Team>
LZ4TT_HD int32_t lz4tt_common_bytes(const Team& t, const uint8_t* src,
                                    int32_t o1, int32_t o2, int32_t limit) {
  int32_t count = 0;
  for (;;) {
    const int32_t j = count + t.lane();
    const bool stop = o2 + j >= limit || src[o1 + j] != src[o2 + j];
    const unsigned m = t.ballot(stop);
    if (m) return count + lz4tt_ffs(m) - 1;
    count += t.size();
  }
}

// The same by one lane, a word at a time from count c (the first c bytes
// known equal), counted up to LZ4TT_SHORT_MATCH: a result of
// LZ4TT_SHORT_MATCH means the first that many bytes are equal and the rest
// is still to count (the team's lz4tt_common_bytes goes on from there).
LZ4TT_HD int32_t lz4tt_common_words(const uint8_t* src, int32_t o1,
                                    int32_t o2, int32_t limit, int32_t c) {
  while (c < LZ4TT_SHORT_MATCH) {
    if (o2 + c + 4 > limit) {
      while (o2 + c < limit && src[o1 + c] == src[o2 + c]) c++;
      return c;
    }
    const uint32_t x = lz4tt_read32(src, o1 + c) ^ lz4tt_read32(src, o2 + c);
    if (x) return c + ((lz4tt_ffs(x) - 1) >> 3);
    c += 4;
  }
  return c;
}

LZ4TT_HD int32_t lz4tt_common_bytes_backward(const uint8_t* src, int32_t o1,
                                             int32_t o2, int32_t l1,
                                             int32_t l2) {
  int32_t count = 0;
  while (o1 - count > l1 && o2 - count > l2 &&
         src[o1 - count - 1] == src[o2 - count - 1])
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

// Hash src[s, s + 4), put s in the table, and test the old entry as a match
// (inside the window in the 12-bit variant); ref is the old entry.
template <bool kSmall>
LZ4TT_HD bool lz4tt_probe(const uint8_t* src, void* table, int32_t s,
                          int32_t& ref) {
  const uint32_t cur = lz4tt_read32(src, s);
  ref = lz4tt_table_swap<kSmall>(table, lz4tt_hash(cur, kSmall ? 13 : 12), s);
  return (kSmall || s - ref < LZ4TT_MAX_DISTANCE) &&
         lz4tt_read32(src, ref) == cur;
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
template <bool kSmall>
LZ4TT_HD Lz4ttJob lz4tt_scan(Lz4ttScan& z, int32_t ext, const uint8_t* src,
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
        for (;;) {
          s = fwd;
          fwd += step;
          step = nb >> LZ4TT_SKIP_STRENGTH;
          nb++;
          if (fwd > mflimit) break;
          if (lz4tt_probe<kSmall>(src, table, s, ref)) {
            found = true;
            break;
          }
        }
        if (!found) {
          z.mode = LZ4TT_SCAN_LAST;
          break;
        }
        const int32_t excess = lz4tt_common_bytes_backward(src, ref, s, 0, z.anchor);
        z.s = s - excess;
        z.ref = ref - excess;
        const int32_t run_len = z.s - z.anchor;
        z.token_off = z.d;
        z.d++;
        if ((int64_t)z.d + run_len + (2 + 1 + LZ4TT_LAST_LITERALS) + (run_len >> 8) >
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
        lz4tt_copy_short(dst, d0, dst_width, src, z.anchor, run_len);
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
              z.ml = lz4tt_common_words(src, z.ref, z.s, src_limit, 0);
            pre = false;
            z.mode = LZ4TT_SCAN_MATCHED;
            if (z.ml == LZ4TT_SHORT_MATCH)
              return {LZ4TT_JOB_EXTEND, 0, z.ref + LZ4TT_SHORT_MATCH,
                      z.s + LZ4TT_SHORT_MATCH, src_limit};
          }
          const int32_t ml = z.ml;
          if ((int64_t)z.d + (1 + LZ4TT_LAST_LITERALS) + (ml >> 8) > dest_cap) {
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
          const uint32_t prev = lz4tt_read32(src, z.s - 2);
          const uint32_t cur = lz4tt_read32(src, z.s);
          pre_s = lz4tt_read32(src, z.s + 4);
          lz4tt_table_swap<kSmall>(table, lz4tt_hash(prev, hash_log), z.s - 2);
          z.ref = lz4tt_table_swap<kSmall>(table, lz4tt_hash(cur, hash_log), z.s);
          pre_ref = lz4tt_read32(src, z.ref + 4);
          if (!((kSmall || z.s - z.ref < LZ4TT_MAX_DISTANCE) &&
                lz4tt_read32(src, z.ref) == cur)) {
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
        lz4tt_copy_short(dst, d0, dst_width, src, z.anchor, run_len);
        break;
      }
      default:
        return {LZ4TT_JOB_DONE, 0, z.d, z.e, 0};
    }
  }
}

template <bool kSmall, class Team>
LZ4TT_HD void lz4tt_compress_variant(const Team& t, const uint8_t* src,
                                     int32_t src_len, uint8_t* dst,
                                     int32_t dest_cap, int64_t dst_width,
                                     void* table, int32_t* out_len,
                                     int32_t* err) {
  Lz4ttScan z = {src_len >= LZ4TT_MIN_LENGTH ? LZ4TT_SCAN_FIND : LZ4TT_SCAN_LAST,
                 1, 0, 0, 0, 0, 0, 0, LZ4TT_OK};
  int32_t ext = 0;
  for (;;) {
    Lz4ttJob j = {};
    if (t.leader()) j = lz4tt_scan<kSmall>(z, ext, src, src_len, dst, dest_cap,
                                           dst_width, table);
    j = lz4tt_bcast_job(t, j);
    if (j.kind == LZ4TT_JOB_DONE) {
      *out_len = j.a;
      *err = j.b;
      return;
    }
    if (j.kind == LZ4TT_JOB_COPY)
      lz4tt_copy(t, dst, j.a, dst_width, src, j.b, j.c);
    else
      ext = lz4tt_common_bytes(t, src, j.a, j.b, j.c);
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
  if (src_len < LZ4TT_64K_LIMIT)
    lz4tt_compress_variant<true>(t, src, src_len, dst, dest_cap, dst_width,
                                 table, out_len, err);
  else
    lz4tt_compress_variant<false>(t, src, src_len, dst, dest_cap, dst_width,
                                  table, out_len, err);
}
