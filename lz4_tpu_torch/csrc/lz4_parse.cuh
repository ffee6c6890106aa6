// The LZ4 sequence parser of one block: the token walk of
// lz4_tpu/native/src/tpulz4.cpp::tpulz4_parse_sequences (:1683-1763), which
// emits one record per sequence with absolute offsets and copies nothing:
//
//   lit_out[k], lit_src[k], lit_len[k]: out[lit_out, +lit_len) =
//                                        comp[lit_src, +lit_len)
//   m_out[k], m_dist[k], m_len[k]:      out[m_out, +m_len) = the match of
//                                        distance m_dist
//
// Its rules, which are not K1's:
//   - a length extension reaching 0x7E000000 is malformed;
//   - a literal run past the end of the block is malformed; literals that
//     end exactly at the end close the block (a literals-only sequence);
//   - a match offset cut off, or reaching before the output start
//     (d - dist < 0), is malformed;
//   - a null offset gives a zero-length match (m_dist 0, m_len 0) that
//     still advances the output cursor: its bytes stay as they are;
//   - there is no last-literals rule and no output bound: the caller
//     compares out_total with its output size.
// Returns the number of sequences, or LZ4TT_PARSE_MALFORMED, or
// LZ4TT_PARSE_TOO_MANY when a block needs more than max_seq of them (the
// codes of tpulz4.cpp:99-100). *n_written is the entries written either
// way; *out_total is set on success only.
//
// Reads stay below src_len and writes below max_seq entries, whatever the
// input. The walk is serial; one thread runs it.
#pragma once

#include "lz4tt_common.cuh"

enum { LZ4TT_PARSE_MALFORMED = -2, LZ4TT_PARSE_TOO_MANY = -3 };

#define LZ4TT_LEN_CAP 0x7E000000

// 0xFF-run length extension with the parser's cap; false when malformed.
LZ4TT_HD bool lz4tt_parse_len_ext(const uint8_t* src, int32_t& s,
                                  int32_t src_end, int32_t& len) {
  int32_t b = 0xFF;
  while (s < src_end) {
    b = src[s++];
    if (b != 0xFF) break;
    len += 0xFF;
    if (len >= LZ4TT_LEN_CAP) return false;
  }
  len += b;
  return true;
}

// The six tables of one block: row pointers into int32[N, max_seq] arrays.
struct Lz4ttSeqRow {
  int32_t* lit_out;
  int32_t* lit_src;
  int32_t* lit_len;
  int32_t* m_out;
  int32_t* m_dist;
  int32_t* m_len;
};

LZ4TT_HD int32_t lz4tt_parse_block(const uint8_t* src, int32_t src_len,
                                   int32_t max_seq, const Lz4ttSeqRow& row,
                                   int32_t* n_written, int32_t* out_total) {
  int32_t s = 0, d = 0, n = 0, code = 0;
  for (;;) {
    if (s >= src_len) {
      code = LZ4TT_PARSE_MALFORMED;
      break;
    }
    if (n >= max_seq) {
      code = LZ4TT_PARSE_TOO_MANY;
      break;
    }
    const int32_t token = src[s++];
    int32_t lit_len = token >> LZ4TT_ML_BITS;
    if (lit_len == LZ4TT_RUN_MASK && !lz4tt_parse_len_ext(src, s, src_len, lit_len)) {
      code = LZ4TT_PARSE_MALFORMED;
      break;
    }
    if ((int64_t)s + lit_len > src_len) {
      code = LZ4TT_PARSE_MALFORMED;
      break;
    }
    row.lit_out[n] = d;
    row.lit_src[n] = s;
    row.lit_len[n] = lit_len;
    s += lit_len;
    d += lit_len;

    if (s == src_len) {  // the final literals-only sequence
      row.m_out[n] = d;
      row.m_dist[n] = 0;
      row.m_len[n] = 0;
      n++;
      break;
    }
    if (s + 2 > src_len) {
      code = LZ4TT_PARSE_MALFORMED;
      break;
    }
    const int32_t dist = src[s] | (src[s + 1] << 8);
    s += 2;
    if (d - dist < 0) {
      code = LZ4TT_PARSE_MALFORMED;
      break;
    }
    int32_t m_len = token & LZ4TT_ML_MASK;
    if (m_len == LZ4TT_ML_MASK && !lz4tt_parse_len_ext(src, s, src_len, m_len)) {
      code = LZ4TT_PARSE_MALFORMED;
      break;
    }
    m_len += LZ4TT_MIN_MATCH;
    row.m_out[n] = d;
    row.m_dist[n] = dist;
    row.m_len[n] = dist == 0 ? 0 : m_len;  // a null offset copies nothing
    d += m_len;
    n++;
  }
  *n_written = n;
  if (code == 0) *out_total = d;
  return code == 0 ? n : code;
}
