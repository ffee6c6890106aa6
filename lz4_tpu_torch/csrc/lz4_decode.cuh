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
// Reads stay below src_end (and at comp[0]); writes stay below dest_cap,
// whatever the input.
#pragma once

#include "lz4tt_common.cuh"

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

template <bool kFast, class Team>
LZ4TT_HD void lz4tt_decode_block(const Team& t, const uint8_t* comp,
                                 int32_t src_end, uint8_t* out,
                                 int32_t dest_cap, int32_t* out_len,
                                 int32_t* src_read, int32_t* err) {
  if (dest_cap == 0) {
    *out_len = 0;
    *src_read = 1;
    if (kFast)
      *err = comp[0] == 0 ? LZ4TT_OK : LZ4TT_ERR_MALFORMED;
    else
      *err = src_end == 1 && comp[0] == 0 ? LZ4TT_OK : LZ4TT_ERR_DEST_TOO_SMALL;
    return;
  }
  int32_t s = 0;
  int32_t d = 0;
  int32_t e = LZ4TT_OK;
  for (;;) {
    if (s >= src_end) {
      e = LZ4TT_ERR_MALFORMED;
      break;
    }
    const uint32_t token = comp[s];
    s++;
    int64_t lit_len = token >> LZ4TT_ML_BITS;
    if (lit_len == LZ4TT_RUN_MASK) lit_len = lz4tt_read_len_ext(comp, s, src_end, lit_len);
    const int64_t lit_end = (int64_t)d + lit_len;
    const int64_t lit_src_end = (int64_t)s + lit_len;
    if (kFast) {
      if (lit_src_end > src_end) {
        e = LZ4TT_ERR_MALFORMED;
        break;
      }
      if (lit_end > (int64_t)dest_cap - LZ4TT_COPY_LENGTH) {
        if (lit_end != dest_cap) {
          e = LZ4TT_ERR_MALFORMED;
        } else {
          for (int64_t j = t.lane(); j < lit_len; j += t.size()) out[d + j] = comp[s + j];
          s = (int32_t)lit_src_end;
          d = (int32_t)lit_end;
        }
        break;
      }
    } else if (lit_end > (int64_t)dest_cap - LZ4TT_COPY_LENGTH ||
               lit_src_end > (int64_t)src_end - LZ4TT_COPY_LENGTH) {
      if (lit_end > dest_cap) {
        e = LZ4TT_ERR_DEST_TOO_SMALL;
      } else if (lit_src_end != src_end) {
        e = LZ4TT_ERR_MALFORMED;
      } else {
        for (int64_t j = t.lane(); j < lit_len; j += t.size()) out[d + j] = comp[s + j];
        s = (int32_t)lit_src_end;
        d = (int32_t)lit_end;
      }
      break;
    }
    // here s + lit_len <= src_end (safe: <= src_end - 8) and
    // lit_end <= dest_cap - 8
    for (int64_t j = t.lane(); j < lit_len; j += t.size()) out[d + j] = comp[s + j];
    s += (int32_t)lit_len;
    d = (int32_t)lit_end;

    if (s + 2 > src_end) {
      e = LZ4TT_ERR_MALFORMED;
      break;
    }
    const int32_t dist = (int32_t)comp[s] | ((int32_t)comp[s + 1] << 8);
    s += 2;
    int64_t m_len = token & LZ4TT_ML_MASK;
    if (m_len == LZ4TT_ML_MASK) m_len = lz4tt_read_len_ext(comp, s, src_end, m_len);
    m_len += LZ4TT_MIN_MATCH;
    if (d - dist < 0 || (int64_t)d + m_len > dest_cap) {
      e = LZ4TT_ERR_MALFORMED;
      break;
    }
    // the match may read bytes other lanes wrote since the last sync; each
    // match syncs before it reads, so none is needed after it
    t.sync();
    if (dist == 0) {
      for (int64_t j = t.lane(); j < m_len; j += t.size()) out[d + j] = 0;
    } else {
      // byte j of an overlapping copy repeats byte (j mod dist) of the
      // period just before d, so every lane reads only bytes below d
      const uint8_t* period = out + (d - dist);
      int32_t r = t.lane() % dist;
      const int32_t step = t.size() % dist;
      for (int64_t j = t.lane(); j < m_len; j += t.size()) {
        out[d + j] = period[r];
        r += step;
        if (r >= dist) r -= dist;
      }
    }
    d += (int32_t)m_len;
  }
  *out_len = d;
  *src_read = s;
  *err = e;
}
