// K2: batched LZ4 fast-scan block compression on Hopper (sm_90a).
//
// Replaces lz4_tpu/kernels/lz4_pallas.py::compress_fast_pallas (pallas_call
// at lz4_pallas.py:676; body _compress_kernel :398-619), which kept the hash
// table in VMEM as (rows, 128) and compared 128-byte windows. Unlike it,
// the table variant is chosen per block from the block's own length
// (jax_codec.py:579-588 and the reference), not from the row capacity.
//
// Bound on the card: bytes (each input byte read once, each output byte
// written once, over 3.35 TB/s of HBM). In practice the scan is serial per
// block: skip acceleration makes each probe depend on the last, and each
// sequence on the table entry the one before it wrote. On the main path's
// alphabet-4 blocks (about 15,100 sequences of 4.3 bytes) it is one lane's
// chain of about a hundred dependent instructions a sequence (byte loads,
// hash, table, compare, bookkeeping), so what bounds the kernel is that
// chain's latency times the blocks that do not fit on the card at once:
// 2048 such blocks over 13 x 132 slots run in two rounds.
//
// Design: one CTA of one warp per block, with the block's 16 KiB hash table
// in dynamic shared memory (uint16_t entries below LZ4_64K_LIMIT, int32_t
// from it on), which lets 13 CTAs share an SM where the former 32 KiB
// table let 6; the carve-out asks for the most shared memory. Lane 0 runs
// the scan alone and the other lanes wait at one shuffle, joining only for
// literal runs above 16 bytes and matches that run past 32 bytes; a match
// is extended 4 bytes a step by XOR and __ffs, and a run of matches with
// no literals between them stays in one loop. Measured on the card
// (PERF.md): staging the row in shared memory (80 KiB a CTA, 2 CTAs an SM)
// was 3x slower, and words joined by a funnel shift were 2 % slower than
// four byte loads through L1.
//
// lz4tt_compress_dict is the same kernel with a dictionary a row, the
// device counterpart of the native tpulz4_compress_fast_ext
// (lz4_tpu/native/src/tpulz4.cpp:416-542, compress_ext), which the JAX
// package runs on the host for dictionary frames: row b's dictionary is
// the dict_lens[b] <= 65,536 bytes that end at dict + b * dict_stride. A
// stride of 0 gives every row one dictionary, stored once; a linked
// frame's blocks pass the content before each block. Its design (the
// second): where every row has the same dictionary (stride 0, one
// length), one seed kernel (a CTA of 1,024 threads, atomicMax in shared
// memory) seeds the 12-bit table once for the launch, and each CTA brings
// those 16 KiB into its shared memory with one bulk asynchronous copy
// (cp.async.bulk, an mbarrier) in place of zeroing and seeding it itself
// (its first design, still taken by rows with dictionaries of their
// own). Then the leader scans as K2 does. What cost the first design half
// of its speed (design_variants --dict-split): a read of a dictionary
// position branched on it and the word at a table entry was read only
// after the window test, so that a step's loads waited for each other;
// both are selects now, and FIND reads each probe's word while the probe
// before it takes its table entry (in K2's scan too). The 12-bit table
// that compress_ext fixes costs the rest against K2's 13-bit one.
#include "lz4_compress.cuh"

#include <cuda_runtime.h>

#include "lz4tt_device.cuh"
#include "lz4tt_xxh_ring.cuh"

namespace {

__global__ void __launch_bounds__(32)
    compress_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
                    const int32_t* __restrict__ src_lens, uint8_t* __restrict__ dst,
                    int64_t dst_stride, int32_t dest_cap,
                    int32_t* __restrict__ out_lens, int32_t* __restrict__ err) {
  extern __shared__ uint4 table[];
  const int64_t b = blockIdx.x;
  WarpTeam t;
  int32_t len = 0;
  int32_t e = 0;
  lz4tt_compress_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,
                       dest_cap, dst_stride, table, &len, &e);
  if (t.leader()) {
    out_lens[b] = len;
    err[b] = e;
  }
}

// The seeded table (int32[1 << LZ4TT_HASH_LOG]) of the dict_len bytes that
// end at dict_end, for every CTA of a launch.
struct SeedTeam {
  __device__ int lane() const { return threadIdx.x; }
  __device__ int size() const { return blockDim.x; }
  __device__ void sync() const { __syncthreads(); }
};

__global__ void __launch_bounds__(1024)
    seed_kernel(const uint8_t* dict_end, int32_t dict_len, int32_t* seed) {
  __shared__ int32_t t32[1 << LZ4TT_HASH_LOG];
  lz4tt_dict_seed(SeedTeam(), dict_end, dict_len, t32);
  for (int i = threadIdx.x; i < (1 << LZ4TT_HASH_LOG); i += blockDim.x)
    seed[i] = t32[i];
}

// seed: null, or the seeded table of every row's dictionary (seed_kernel),
// copied into the CTA's table by one bulk copy.
__global__ void __launch_bounds__(32)
    compress_dict_kernel(const uint8_t* __restrict__ src, int64_t src_stride,
                         const int32_t* __restrict__ src_lens,
                         const uint8_t* dict, int64_t dict_stride,
                         const int32_t* __restrict__ dict_lens,
                         uint8_t* __restrict__ dst, int64_t dst_stride,
                         int32_t dest_cap, int32_t* __restrict__ out_lens,
                         int32_t* __restrict__ err,
                         const int32_t* __restrict__ seed) {
  extern __shared__ uint4 table[];
  __shared__ uint64_t bar;
  const int64_t b = blockIdx.x;
  WarpTeam t;
  const int32_t dl = dict_lens[b];
  const bool seeded = seed != nullptr && dl > 0;
  if (seeded) {
    if (t.leader()) {
      lz4tt_mbar_init(&bar, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      lz4tt_mbar_expect(&bar, LZ4TT_TABLE_BYTES);
      lz4tt_bulk_copy(table, seed, LZ4TT_TABLE_BYTES, &bar);
    }
    __syncwarp();
    lz4tt_mbar_wait(&bar, 0);
  }
  int32_t len = 0;
  int32_t e = 0;
  lz4tt_compress_dict_block(t, src + b * src_stride, src_lens[b],
                            dict + b * dict_stride, dl, dst + b * dst_stride,
                            dest_cap, dst_stride, table, &len, &e, seeded);
  if (t.leader()) {
    out_lens[b] = len;
    err[b] = e;
  }
}

cudaError_t prepare() {
  int dev;
  return lz4tt_once_a_device([](int) {
    cudaError_t e = cudaFuncSetAttribute(
        compress_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        cudaSharedmemCarveoutMaxShared);
    if (e) return e;
    return cudaFuncSetAttribute(compress_dict_kernel,
                                cudaFuncAttributePreferredSharedMemoryCarveout,
                                cudaSharedmemCarveoutMaxShared);
  }, &dev);
}

}  // namespace

// src: uint8[n, src_stride], src_lens: int32[n] within [0, src_stride];
// dst: uint8[n, dst_stride] with dst_stride >= dest_cap. Returns
// cudaGetLastError() after the launch.
extern "C" int lz4tt_compress_fast(const void* src, long long src_stride,
                                   const void* src_lens, void* dst,
                                   long long dst_stride, int dest_cap,
                                   void* out_lens, void* err, int n,
                                   void* stream) {
  if (const cudaError_t e = prepare()) return (int)e;
  if (n > 0) {
    compress_kernel<<<n, 32, LZ4TT_TABLE_BYTES, (cudaStream_t)stream>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)src_lens, (uint8_t*)dst,
        dst_stride, dest_cap, (int32_t*)out_lens, (int32_t*)err);
  }
  return (int)cudaGetLastError();
}

// The fast scan with a dictionary a row: row b's dictionary is the
// dict_lens[b] <= 65,536 bytes that end at dict + b * dict_stride (they may
// lie just before the row). seed_len >= 0 (dict_stride 0, every
// dict_lens[b] either seed_len or 0): the table is seeded once into seed
// (int32[1 << 12], 16-byte aligned) for every CTA; -1: each CTA seeds its
// own. Returns the first error of its launches.
extern "C" int lz4tt_compress_dict(const void* src, long long src_stride,
                                   const void* src_lens, const void* dict,
                                   long long dict_stride, const void* dict_lens,
                                   void* dst, long long dst_stride,
                                   int dest_cap, void* out_lens, void* err,
                                   int n, void* seed, int seed_len,
                                   void* stream) {
  if (const cudaError_t e = prepare()) return (int)e;
  if (seed_len > LZ4TT_DICT_MAX || (seed_len >= 0 && (dict_stride != 0 ||
                                                      seed == nullptr)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (n > 0) {
    if (seed_len > 0) {
      seed_kernel<<<1, 1024, 0, s>>>((const uint8_t*)dict, seed_len,
                                     (int32_t*)seed);
      if (const cudaError_t e = cudaGetLastError()) return (int)e;
    }
    compress_dict_kernel<<<n, 32, LZ4TT_TABLE_BYTES, s>>>(
        (const uint8_t*)src, src_stride, (const int32_t*)src_lens,
        (const uint8_t*)dict, dict_stride, (const int32_t*)dict_lens,
        (uint8_t*)dst, dst_stride, dest_cap, (int32_t*)out_lens, (int32_t*)err,
        seed_len > 0 ? (const int32_t*)seed : nullptr);
  }
  return (int)cudaGetLastError();
}

// Resident CTAs per SM and threads per CTA of the kernel as launched.
extern "C" int lz4tt_compress_occupancy(int* ctas_per_sm, int* threads) {
  *threads = 32;
  if (const cudaError_t e = prepare()) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas_per_sm, compress_kernel, 32, LZ4TT_TABLE_BYTES);
}
