// The frame body of one block by one team (see lz4tt_common.cuh): what
// lz4_tpu/dist/sharded.py::_frame_body_packed (:271-306) computes for it.
// A block of len > 0 bytes is written at its offset in the body as
//   - a 4-byte little-endian size word: comp_len, or len with
//     LZ4TT_INCOMPRESSIBLE set when compressing did not make it smaller
//     (comp_len >= len; LZ4FrameOutputStream.java:215-222);
//   - then its payload: the compressed row's comp_len bytes, or under the
//     same rule the raw row's len bytes.
// A block of len <= 0 writes nothing.
//
// Body offsets are arbitrary bytes, so the payload's destination and its
// source row are misaligned differently. The team writes single bytes up
// to the first 16-byte aligned destination address, then 16-byte stores,
// each built from the aligned source words that hold its bytes with
// funnel shifts (lz4tt_load_upto16), then the tail. Reads stay in the
// payload's bytes, writes in the block's span of the body.
#pragma once

#include "lz4tt_common.cuh"

#define LZ4TT_INCOMPRESSIBLE 0x80000000u

// Source chunks of 16 bytes a lane loads before it stores any of them.
#define LZ4TT_PACK_UNROLL 4

// dst[0, n) = src[0, n) by the team.
template <class Team>
LZ4TT_HD void lz4tt_team_copy(const Team& t, uint8_t* dst, const uint8_t* src,
                              int32_t n) {
  if (n <= 0) return;
  int32_t head = (int32_t)((16 - ((uintptr_t)dst & 15)) & 15);
  if (head > n) head = n;
  const int32_t a1 = head + ((n - head) & ~15);
  const int32_t step = 16 * t.size();
  for (int32_t j = t.lane(); j < head; j += t.size()) dst[j] = src[j];
  int32_t c = head + 16 * t.lane();
  for (; c + (LZ4TT_PACK_UNROLL - 1) * step < a1; c += LZ4TT_PACK_UNROLL * step) {
    uint32_t a[LZ4TT_PACK_UNROLL][4];
#pragma unroll
    for (int u = 0; u < LZ4TT_PACK_UNROLL; u++)
      lz4tt_load_upto16(src, c + u * step, 16, a[u]);
#pragma unroll
    for (int u = 0; u < LZ4TT_PACK_UNROLL; u++) lz4tt_store16w(dst + c + u * step, a[u]);
  }
  for (; c < a1; c += step) {
    uint32_t a[4];
    lz4tt_load_upto16(src, c, 16, a);
    lz4tt_store16w(dst + c, a);
  }
  for (int32_t j = a1 + t.lane(); j < n; j += t.size()) dst[j] = src[j];
}

// A block's header and payload at dst, its offset in the body: Header
// writes its kHeader bytes (Header::write(team, dst, stored_raw, len,
// comp_len)), the team copies the payload behind them. The frame's header
// is its size word (Lz4ttFrameWord); the LZ4Block stream's is 21 bytes
// (block_stream.cuh).
template <class Team, class Header>
LZ4TT_HD void lz4tt_pack_payload(const Team& t, const Header& h,
                                 const uint8_t* raw, int32_t len,
                                 const uint8_t* comp, int32_t comp_len,
                                 uint8_t* dst) {
  if (len <= 0) return;
  const bool use_raw = comp_len >= len;
  h.write(t, dst, use_raw, len, comp_len);
  lz4tt_team_copy(t, dst + Header::kHeader, use_raw ? raw : comp,
                  use_raw ? len : comp_len);
}

// The frame's 4-byte size word.
struct Lz4ttFrameWord {
  enum { kHeader = 4 };
  template <class Team>
  LZ4TT_HD void write(const Team& t, uint8_t* dst, bool use_raw, int32_t len,
                      int32_t comp_len) const {
    const uint32_t word =
        use_raw ? ((uint32_t)len | LZ4TT_INCOMPRESSIBLE) : (uint32_t)comp_len;
    for (int j = t.lane(); j < 4; j += t.size()) dst[j] = (uint8_t)(word >> (8 * j));
  }
};

// Block b's size word and payload at dst, its offset in the body.
template <class Team>
LZ4TT_HD void lz4tt_pack_block(const Team& t, const uint8_t* raw, int32_t len,
                               const uint8_t* comp, int32_t comp_len,
                               uint8_t* dst) {
  lz4tt_pack_payload(t, Lz4ttFrameWord(), raw, len, comp, comp_len, dst);
}
