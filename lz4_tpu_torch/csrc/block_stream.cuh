// The LZ4Block stream of lz4-java's LZ4BlockOutputStream and
// LZ4BlockInputStream (lz4_tpu_torch/formats/block_stream.py), for the
// kernels that write and walk it on the card (frame_pack.cu,
// block_stream.cu):
//
//   stream = block* end_block
//   block  = magic("LZ4Block") token(1) compressed_len(4 LE)
//            original_len(4 LE) check(4 LE) payload
//   token  = method | level, method 0x10 raw or 0x20 LZ4,
//            level = ceil(log2(block_size)) - 10
//   end    = token(RAW | level), zero lengths and check
//
// The writer's header (Lz4ttBlockHeader) is the pack body's header
// (frame_pack.cuh): a block that compressing does not make smaller is
// stored raw. Its check is XXH32 of the raw block with the stream's seed,
// which K3 computes, through the 28-bit Checksum adapter
// (StreamingXXHash32.java:101-107).
//
// The reader's rules (lz4tt_lz4block_parse, as _parse_header): the magic,
// the method, the original length within the level's block size, both
// lengths zero or neither, a raw block's lengths equal, the compressed
// length within the bound of the level's block size (before anything of
// the payload is read), and a zero check on an empty block.
//
// The walk (lz4tt_lz4block_walk, the reference semantics of
// block_stream_index) lists the records a reader meets from a position:
// each header in turn, an empty block ending the walk when stop is set;
// the first fault is the last record, with its code: CORRUPTED for a
// header that breaks a rule, PREMATURE ("Stream ended prematurely") for a
// header or payload cut off by the end, or, with stop set, no end block.
// A record's row of the index holds its header's position, compressed and
// original lengths, method, check and code (all zero but the position and
// code on a fault).
#pragma once

#include "frame_pack.cuh"

enum {
  LZ4TT_LZ4BLOCK_HEADER = 21,
  LZ4TT_LZ4BLOCK_RAW = 0x10,
  LZ4TT_LZ4BLOCK_LZ4 = 0x20,
  LZ4TT_LZ4BLOCK_LEVEL_BASE = 10,
};

// A record's code (kernels/block_stream.py): NONE past the last record;
// MALFORMED and TOO_LARGE come from the decode (the payload is not LZ4 of
// its original length; a block longer than the decode's rows).
enum {
  LZ4TT_LZ4BLOCK_NONE = -1,
  LZ4TT_LZ4BLOCK_OK = 0,
  LZ4TT_LZ4BLOCK_MALFORMED = 1,
  LZ4TT_LZ4BLOCK_TOO_LARGE = 2,
  LZ4TT_LZ4BLOCK_CORRUPTED = 3,
  LZ4TT_LZ4BLOCK_PREMATURE = 4,
};

// The index's fields: rows of a table int32[LZ4TT_LZ4BLOCK_FIELDS, n].
enum {
  LZ4TT_LZ4BLOCK_AT = 0,
  LZ4TT_LZ4BLOCK_CLEN = 1,
  LZ4TT_LZ4BLOCK_OLEN = 2,
  LZ4TT_LZ4BLOCK_METHOD = 3,
  LZ4TT_LZ4BLOCK_CHECK = 4,
  LZ4TT_LZ4BLOCK_CODE = 5,
  LZ4TT_LZ4BLOCK_FIELDS = 6,
};

// "LZ4Block" as a little-endian word; none of its bytes is 0.
#define LZ4TT_LZ4BLOCK_MAGIC 0x6B636F6C42345A4CULL
#define LZ4TT_LZ4BLOCK_CHECK_MASK 0x0FFFFFFFu

// Byte j (0..20) of a header.
LZ4TT_HD uint8_t lz4tt_lz4block_header_byte(int j, uint32_t token,
                                            uint32_t comp_len,
                                            uint32_t orig_len,
                                            uint32_t check) {
  if (j < 8) return (uint8_t)(LZ4TT_LZ4BLOCK_MAGIC >> (8 * j));
  if (j == 8) return (uint8_t)token;
  const uint32_t w = j < 13 ? comp_len : j < 17 ? orig_len : check;
  return (uint8_t)(w >> (8 * ((j - 9) & 3)));
}

// The writer's header of a block at level, its check the raw block's
// XXH32 (masked here).
struct Lz4ttBlockHeader {
  enum { kHeader = LZ4TT_LZ4BLOCK_HEADER };
  int32_t level;
  uint32_t check;
  template <class Team>
  LZ4TT_HD void write(const Team& t, uint8_t* dst, bool use_raw, int32_t len,
                      int32_t comp_len) const {
    const uint32_t token =
        (use_raw ? LZ4TT_LZ4BLOCK_RAW : LZ4TT_LZ4BLOCK_LZ4) | (uint32_t)level;
    const uint32_t cl = (uint32_t)(use_raw ? len : comp_len);
    const uint32_t ck = check & LZ4TT_LZ4BLOCK_CHECK_MASK;
    for (int j = t.lane(); j < kHeader; j += t.size())
      dst[j] = lz4tt_lz4block_header_byte(j, token, cl, (uint32_t)len, ck);
  }
};

// The end block at dst.
template <class Team>
LZ4TT_HD void lz4tt_lz4block_end(const Team& t, int32_t level, uint8_t* dst) {
  const uint32_t token = LZ4TT_LZ4BLOCK_RAW | (uint32_t)level;
  for (int j = t.lane(); j < LZ4TT_LZ4BLOCK_HEADER; j += t.size())
    dst[j] = lz4tt_lz4block_header_byte(j, token, 0, 0, 0);
}

struct Lz4ttBlockRecord {
  int32_t comp_len, orig_len, method, check, code;
};

// The header at s[p, p + 21) of a stream of len bytes, read with the
// reader's rules: PREMATURE where fewer than 21 bytes are left, CORRUPTED
// where a rule is broken (fields 0), else OK with its fields.
LZ4TT_HD Lz4ttBlockRecord lz4tt_lz4block_parse(const uint8_t* s, int64_t p,
                                               int64_t len) {
  Lz4ttBlockRecord r = {0, 0, 0, 0, LZ4TT_LZ4BLOCK_PREMATURE};
  if (p + LZ4TT_LZ4BLOCK_HEADER > len) return r;
  r.code = LZ4TT_LZ4BLOCK_CORRUPTED;
  uint64_t magic = 0;
  for (int k = 0; k < 8; k++) magic |= (uint64_t)s[p + k] << (8 * k);
  if (magic != LZ4TT_LZ4BLOCK_MAGIC) return r;
  const uint32_t token = s[p + 8];
  const uint32_t cl = lz4tt_read32(s, p + 9);
  const uint32_t ol = lz4tt_read32(s, p + 13);
  const uint32_t ck = lz4tt_read32(s, p + 17);
  const uint32_t method = token & 0xF0;
  const uint32_t size = 1u << (LZ4TT_LZ4BLOCK_LEVEL_BASE + (token & 0x0F));
  if (method != LZ4TT_LZ4BLOCK_RAW && method != LZ4TT_LZ4BLOCK_LZ4) return r;
  if (ol > size || (ol == 0) != (cl == 0) ||
      (method == LZ4TT_LZ4BLOCK_RAW && ol != cl))
    return r;
  // max_compressed_length(size)
  if (cl > size + size / 255 + 16) return r;
  if (ol == 0 && ck != 0) return r;
  r = {(int32_t)cl, (int32_t)ol, (int32_t)method, (int32_t)ck,
       LZ4TT_LZ4BLOCK_OK};
  return r;
}

// Row k of the index (a table of fields with stride fs).
LZ4TT_HD void lz4tt_lz4block_put(int32_t* table, int64_t fs, int32_t k,
                                 int64_t at, const Lz4ttBlockRecord& r) {
  table[LZ4TT_LZ4BLOCK_AT * fs + k] = (int32_t)at;
  table[LZ4TT_LZ4BLOCK_CLEN * fs + k] = r.comp_len;
  table[LZ4TT_LZ4BLOCK_OLEN * fs + k] = r.orig_len;
  table[LZ4TT_LZ4BLOCK_METHOD * fs + k] = r.method;
  table[LZ4TT_LZ4BLOCK_CHECK * fs + k] = r.check;
  table[LZ4TT_LZ4BLOCK_CODE * fs + k] = r.code;
}

// Whether the decode decodes record k as LZ4: a sound record of bytes
// whose payload is compressed.
LZ4TT_HD bool lz4tt_lz4block_decodes(const int32_t* table, int64_t fs,
                                     int32_t k) {
  return table[LZ4TT_LZ4BLOCK_CODE * fs + k] == LZ4TT_LZ4BLOCK_OK &&
         table[LZ4TT_LZ4BLOCK_METHOD * fs + k] == LZ4TT_LZ4BLOCK_LZ4 &&
         table[LZ4TT_LZ4BLOCK_OLEN * fs + k] > 0;
}

// The reader's walk of s[0, len) from the header at pos, one header after
// the other, writing records k, k + 1, ... while fewer than max_blocks;
// returns the records written in all, and in *end the position after the
// last (a fault's own position). With stop, an empty block ends the walk
// and the stream's end before one is PREMATURE; without, empty blocks are
// records of no bytes and the end of the stream ends the walk.
LZ4TT_HD int32_t lz4tt_lz4block_walk(const uint8_t* s, int64_t len,
                                     int64_t pos, int stop, int32_t k,
                                     int32_t max_blocks, int32_t* table,
                                     int64_t fs, int64_t* end) {
  *end = pos;
  while (k < max_blocks) {
    if (pos == len && !stop) break;
    Lz4ttBlockRecord r = lz4tt_lz4block_parse(s, pos, len);
    if (r.code == LZ4TT_LZ4BLOCK_OK && r.orig_len > 0 &&
        pos + LZ4TT_LZ4BLOCK_HEADER + r.comp_len > len)
      r = {0, 0, 0, 0, LZ4TT_LZ4BLOCK_PREMATURE};
    lz4tt_lz4block_put(table, fs, k++, pos, r);
    if (r.code != LZ4TT_LZ4BLOCK_OK) break;
    pos += LZ4TT_LZ4BLOCK_HEADER + r.comp_len;
    *end = pos;
    if (r.orig_len == 0 && stop) break;
  }
  return k;
}

// Bit r (0 <= r < 16) set where the magic starts at byte r of the 24
// little-endian bytes w[0..5].
LZ4TT_HD uint32_t lz4tt_lz4block_hits(const uint32_t w[6]) {
  uint32_t ls = 0;  // the bytes 'L' among the first 16
#pragma unroll
  for (int k = 0; k < 4; k++) {
#ifdef __CUDA_ARCH__
    const uint32_t e = __vcmpeq4(w[k], 0x4C4C4C4Cu);
    ls |= ((e & 1u) | ((e >> 7) & 2u) | ((e >> 14) & 4u) | ((e >> 21) & 8u))
          << (4 * k);
#else
    for (int i = 0; i < 4; i++)
      if (((w[k] >> (8 * i)) & 0xFF) == 0x4C) ls |= 1u << (4 * k + i);
#endif
  }
  uint32_t hits = 0;
  while (ls) {
    const int r = lz4tt_ffs(ls) - 1;
    ls &= ls - 1;
    const int k = r >> 2, sh = 8 * (r & 3);
    const uint32_t lo = lz4tt_funnel_r(w[k], w[k + 1], sh);
    const uint32_t hi = lz4tt_funnel_r(w[k + 1], w[k + 2], sh);
    if (lo == (uint32_t)LZ4TT_LZ4BLOCK_MAGIC &&
        hi == (uint32_t)(LZ4TT_LZ4BLOCK_MAGIC >> 32))
      hits |= 1u << r;
  }
  return hits;
}
