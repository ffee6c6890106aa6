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
#pragma once

#include "lz4tt_common.cuh"

LZ4TT_HD uint32_t lz4tt_hash(uint32_t v, int hash_log) {
  return (v * 2654435761u) >> (32 - hash_log);
}

// leader-only single-byte store
template <class Team>
LZ4TT_HD void lz4tt_put(const Team& t, uint8_t* dst, int64_t pos,
                        int64_t dst_width, uint32_t v) {
  if (t.leader() && pos < dst_width) dst[pos] = (uint8_t)v;
}

// writeLen (LZ4SafeUtils.java:152-158); returns the new d
template <class Team>
LZ4TT_HD int32_t lz4tt_write_len(const Team& t, uint8_t* dst, int32_t d,
                                 int64_t dst_width, int32_t len) {
  while (len >= 0xFF) {
    lz4tt_put(t, dst, d++, dst_width, 0xFF);
    len -= 0xFF;
  }
  lz4tt_put(t, dst, d++, dst_width, (uint32_t)len);
  return d;
}

template <class Team>
LZ4TT_HD void lz4tt_copy(const Team& t, uint8_t* dst, int64_t d,
                         int64_t dst_width, const uint8_t* src, int64_t s,
                         int64_t n) {
  if (d + n > dst_width) n = dst_width - d;
  for (int64_t j = t.lane(); j < n; j += t.size()) dst[d + j] = src[s + j];
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

LZ4TT_HD int32_t lz4tt_common_bytes_backward(const uint8_t* src, int32_t o1,
                                             int32_t o2, int32_t l1,
                                             int32_t l2) {
  int32_t count = 0;
  while (o1 - count > l1 && o2 - count > l2 &&
         src[o1 - count - 1] == src[o2 - count - 1])
    count++;
  return count;
}

// table[h] = val, returning the old entry on every lane
template <class Team>
LZ4TT_HD int32_t lz4tt_table_swap(const Team& t, int32_t* table, uint32_t h,
                                  int32_t val) {
  int32_t old = 0;
  if (t.leader()) {
    old = table[h];
    table[h] = val;
  }
  return t.bcast(old);
}

// table: 1 << LZ4TT_HASH_LOG_64K entries, owned by this team.
template <class Team>
LZ4TT_HD void lz4tt_compress_block(const Team& t, const uint8_t* src,
                                   int32_t src_len, uint8_t* dst,
                                   int32_t dest_cap, int64_t dst_width,
                                   int32_t* table, int32_t* out_len,
                                   int32_t* err) {
  const bool small = src_len < LZ4TT_64K_LIMIT;
  const int hash_log = small ? LZ4TT_HASH_LOG_64K : LZ4TT_HASH_LOG;
  const int32_t src_end = src_len;
  const int32_t src_limit = src_end - LZ4TT_LAST_LITERALS;
  const int32_t mflimit = src_end - LZ4TT_MF_LIMIT;
  int32_t anchor = 0;
  int32_t d = 0;
  int32_t e = LZ4TT_OK;

  if (src_len >= LZ4TT_MIN_LENGTH) {
    for (int32_t i = t.lane(); i < (1 << hash_log); i += t.size()) table[i] = 0;
    t.sync();
    int32_t s = 1;
    for (;;) {
      // find a match, with skip acceleration
      int32_t fwd = s;
      int32_t step = 1;
      int32_t nb = 1 << LZ4TT_SKIP_STRENGTH;
      int32_t ref = 0;
      bool found = false;
      for (;;) {
        s = fwd;
        fwd += step;
        step = nb >> LZ4TT_SKIP_STRENGTH;
        nb++;
        if (fwd > mflimit) break;
        const uint32_t cur = lz4tt_read32(src, s);
        ref = lz4tt_table_swap(t, table, lz4tt_hash(cur, hash_log), s);
        if ((small || s - ref < LZ4TT_MAX_DISTANCE) && lz4tt_read32(src, ref) == cur) {
          found = true;
          break;
        }
      }
      if (!found) break;

      const int32_t excess = lz4tt_common_bytes_backward(src, ref, s, 0, anchor);
      s -= excess;
      ref -= excess;

      const int32_t run_len = s - anchor;
      int32_t token_off = d;
      d++;
      if ((int64_t)d + run_len + (2 + 1 + LZ4TT_LAST_LITERALS) + (run_len >> 8) > dest_cap) {
        e = LZ4TT_ERR_DEST_TOO_SMALL;
        break;
      }
      uint32_t token;
      if (run_len >= LZ4TT_RUN_MASK) {
        token = LZ4TT_RUN_MASK << LZ4TT_ML_BITS;
        d = lz4tt_write_len(t, dst, d, dst_width, run_len - LZ4TT_RUN_MASK);
      } else {
        token = (uint32_t)run_len << LZ4TT_ML_BITS;
      }
      lz4tt_copy(t, dst, d, dst_width, src, anchor, run_len);
      d += run_len;

      bool last = false;
      for (;;) {
        const int32_t back = s - ref;
        lz4tt_put(t, dst, d, dst_width, back & 0xFF);
        lz4tt_put(t, dst, d + 1, dst_width, (back >> 8) & 0xFF);
        d += 2;
        s += LZ4TT_MIN_MATCH;
        ref += LZ4TT_MIN_MATCH;
        const int32_t match_len = lz4tt_common_bytes(t, src, ref, s, src_limit);
        if ((int64_t)d + (1 + LZ4TT_LAST_LITERALS) + (match_len >> 8) > dest_cap) {
          e = LZ4TT_ERR_DEST_TOO_SMALL;
          break;
        }
        s += match_len;
        if (match_len >= LZ4TT_ML_MASK) {
          token |= LZ4TT_ML_MASK;
          d = lz4tt_write_len(t, dst, d, dst_width, match_len - LZ4TT_ML_MASK);
        } else {
          token |= (uint32_t)match_len;
        }
        lz4tt_put(t, dst, token_off, dst_width, token);

        if (s > mflimit) {
          last = true;
          break;
        }
        const uint32_t prev = lz4tt_read32(src, s - 2);
        lz4tt_table_swap(t, table, lz4tt_hash(prev, hash_log), s - 2);
        const uint32_t cur = lz4tt_read32(src, s);
        ref = lz4tt_table_swap(t, table, lz4tt_hash(cur, hash_log), s);
        if (!((small || s - ref < LZ4TT_MAX_DISTANCE) && lz4tt_read32(src, ref) == cur)) break;
        token_off = d;
        d++;
        token = 0;
      }
      if (e != LZ4TT_OK) break;
      anchor = s;
      if (last) break;
      s++;
    }
  }

  if (e == LZ4TT_OK) {
    const int32_t run_len = src_end - anchor;
    if ((int64_t)d + run_len + 1 + (run_len + 255 - LZ4TT_RUN_MASK) / 255 > dest_cap) {
      e = LZ4TT_ERR_DEST_TOO_SMALL;
    } else {
      if (run_len >= LZ4TT_RUN_MASK) {
        lz4tt_put(t, dst, d, dst_width, LZ4TT_RUN_MASK << LZ4TT_ML_BITS);
        d = lz4tt_write_len(t, dst, d + 1, dst_width, run_len - LZ4TT_RUN_MASK);
      } else {
        lz4tt_put(t, dst, d, dst_width, (uint32_t)run_len << LZ4TT_ML_BITS);
        d++;
      }
      lz4tt_copy(t, dst, d, dst_width, src, anchor, run_len);
      d += run_len;
    }
  }
  *out_len = d;
  *err = e;
}
