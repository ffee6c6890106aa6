// Segment decode of one block from its sequence tables (lz4_parse.cuh), in
// phases that a team runs (see lz4tt_common.cuh): what
// lz4_tpu/kernels/segment_decode.py::_segment_kernel (:96-153) computes.
// Bytes [0, out_max) of the output row are
//   - literal runs copied from the compressed block,
//   - matches, with overlap, in sequence order,
//   - zeros wherever no sequence writes (null-match holes and the tail).
//
// The JAX kernel trusts its tables (segment_decode.py:21-25). These phases
// do not: lz4tt_segment_ok holds every sequence to its row, and a block
// with one sequence that fails is MALFORMED and copies nothing, so no read
// leaves [0, comp_len) and no write leaves [0, out_max), whatever the
// tables hold.
//
// Order: zero the row; check every sequence; copy every literal run, in
// any order and in parallel (their destinations are absolute and, in
// tables from the parser, disjoint); then the matches in sequence order,
// each after the bytes it reads are written.
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

// Sequence k stays inside its block: its literals inside the compressed
// block and the output row, its match inside the output row and reading
// only bytes before it (distance >= 1). Empty runs are not checked.
LZ4TT_HD bool lz4tt_segment_ok(const Lz4ttSeqTables& s, int32_t k,
                               int32_t comp_len, int32_t out_max) {
  const int64_t ll = s.lit_len[k];
  if (ll != 0) {
    const int64_t src = s.lit_src[k], dst = s.lit_out[k];
    if (ll < 0 || src < 0 || dst < 0 || src + ll > comp_len || dst + ll > out_max)
      return false;
  }
  const int64_t ml = s.m_len[k];
  if (ml != 0) {
    const int64_t dst = s.m_out[k], dist = s.m_dist[k];
    if (ml < 0 || dist < 1 || dst - dist < 0 || dst + ml > out_max) return false;
  }
  return true;
}

template <class Team>
LZ4TT_HD void lz4tt_segment_zero(const Team& t, uint8_t* out, int32_t out_max) {
  for (int32_t j = t.lane(); j < out_max; j += t.size()) out[j] = 0;
}

// The literal run of sequence k (checked by lz4tt_segment_ok).
template <class Team>
LZ4TT_HD void lz4tt_segment_literal(const Team& t, const uint8_t* comp,
                                    uint8_t* out, const Lz4ttSeqTables& s,
                                    int32_t k) {
  const int32_t ll = s.lit_len[k];
  const uint8_t* src = comp + s.lit_src[k];
  uint8_t* dst = out + s.lit_out[k];
  for (int32_t j = t.lane(); j < ll; j += t.size()) dst[j] = src[j];
}

// The matches of sequences [0, n_seq), in order (all checked), by one team:
// K1's overlap copy, which syncs the team before each match reads.
template <class Team>
LZ4TT_HD void lz4tt_segment_matches(const Team& t, uint8_t* out,
                                    const Lz4ttSeqTables& s, int32_t n_seq) {
  for (int32_t k = 0; k < n_seq; k++) {
    const int32_t ml = s.m_len[k];
    if (ml > 0) lz4tt_copy_match(t, out, s.m_out[k], s.m_dist[k], ml);
  }
}
