"""Time design variants of block compress (K2) and block decode (K1)
against the shipped kernels, on the card.

Each variant is the shipped ``csrc`` with a few text replacements: the
design options ``PERF.md`` reports as tried and lost. Every variant is
built with ``nvcc`` (in parallel, into ``build/lz4_tpu_torch/variants/``)
and timed with CUDA events on the main path's rows (``make_blocks(4096,
65536, 1234)``, and its K2 output for K1): all rows, then the a4 and the
text rows apart. Each variant's output is held against the shipped
kernel's. Run from the root of a checkout, on a machine with a card::

    python -m lz4_tpu_torch.design_variants
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys

import torch

from .core.constants import max_compressed_length
from .dist import sharded
from .kernels import build, codec

SEED, N_BLOCKS, BLOCK_LEN, REPS = 1234, 4096, 1 << 16, 5

_STAGED = """  uint4* row = table + LZ4TT_TABLE_BYTES / 16;
  const uint4* g = (const uint4*)(src + b * src_stride);
  for (int i = t.lane(); i < (src_lens[b] + 15) / 16; i += 32) row[i] = g[i];
  __syncwarp();
  lz4tt_compress_block(t, (const uint8_t*)row, src_lens[b], dst + b * dst_stride,"""
_WORDS = """#include "lz4tt_common.cuh"

LZ4TT_HD uint32_t lz4tt_load32u(const uint8_t* p, int64_t i) {
  const uintptr_t addr = (uintptr_t)(p + i);
  const uint8_t* w = (const uint8_t*)(addr & ~(uintptr_t)3);
  const int mis = (int)(addr & 3);
  return lz4tt_funnel_r(lz4tt_ld32(w), mis ? lz4tt_ld32(w + 4) : 0u, 8 * mis);
}
"""
_RING = "  LZ4TT_RING = 4096,"
_NEAR = "enum { LZ4TT_RING_FLUSH = 2048, LZ4TT_RING_NEAR = 3072 };"

# name -> (source, [(file, old, new)]): every occurrence of old is replaced
VARIANTS = {
    "K2": ("lz4_compress", []),
    "K2, row staged in shared memory (2 CTAs an SM)": ("lz4_compress", [
        ("lz4_compress.cu", """  lz4tt_compress_block(t, src + b * src_stride, src_lens[b], dst + b * dst_stride,""",
         _STAGED),
        ("lz4_compress.cu", "cudaSharedmemCarveoutMaxShared);",
         "cudaSharedmemCarveoutMaxShared) ? cudaErrorUnknown : "
         "cudaFuncSetAttribute(compress_kernel, "
         "cudaFuncAttributeMaxDynamicSharedMemorySize, "
         "LZ4TT_TABLE_BYTES + 65552);"),
        ("lz4_compress.cu", "compress_kernel<<<n, 32, LZ4TT_TABLE_BYTES,",
         "compress_kernel<<<n, 32, LZ4TT_TABLE_BYTES + 65552,")]),
    "K2, default carve-out": ("lz4_compress", [
        ("lz4_compress.cu", "cudaSharedmemCarveoutMaxShared",
         "cudaSharedmemCarveoutDefault")]),
    "K2, the match's first word read after the probe": ("lz4_compress", [
        ("lz4_compress.cuh", "if (pre && x != 0 && z.s + 4 <= src_limit)",
         "if (false && x != 0 && z.s + 4 <= src_limit)")]),
    "K2, aligned words and funnel shifts for reads": ("lz4_compress", [
        ("lz4_compress.cuh", '#include "lz4tt_common.cuh"\n', _WORDS),
        ("lz4_compress.cuh", "lz4tt_read32(", "lz4tt_load32u(")]),
    "K1": ("lz4_decode", []),
    "K1, no four-token run": ("lz4_decode", [
        ("lz4_decode.cuh", "      while (n <= LZ4TT_BATCH - 4 &&",
         "      while (false && n <= LZ4TT_BATCH - 4 &&")]),
    "K1, lane copies of at most 16 bytes": ("lz4_decode", [
        ("lz4_decode.cuh", "  LZ4TT_LANE_COPY = 64,", "  LZ4TT_LANE_COPY = 16,")]),
    "K1, 2 KiB ring": ("lz4_decode", [
        ("lz4_decode.cuh", _RING, "  LZ4TT_RING = 2048,"),
        ("lz4_decode.cuh", _NEAR,
         "enum { LZ4TT_RING_FLUSH = 768, LZ4TT_RING_NEAR = 1408 };")]),
    "K1, 8 KiB ring": ("lz4_decode", [
        ("lz4_decode.cuh", _RING, "  LZ4TT_RING = 8192,"),
        ("lz4_decode.cuh", _NEAR,
         "enum { LZ4TT_RING_FLUSH = 4096, LZ4TT_RING_NEAR = 6144 };")]),
}

_ARGS = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
         ctypes.c_int, ctypes.c_void_p]


def build_variants() -> dict:
    """name -> (source, .so path, nvcc's register lines); all at once."""
    root = build.build_dir().parent / "variants"
    procs = []
    for i, (name, (source, edits)) in enumerate(VARIANTS.items()):
        d = root / str(i)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(build.CSRC, d)
        for fname, old, new in edits:
            text = (d / fname).read_text()
            if old not in text:
                raise ValueError(f"{name}: {old!r} is not in {fname}")
            (d / fname).write_text(text.replace(old, new))
        so = d / f"lib{source}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(d), "-o", str(so),
               str(d / f"{source}.cu")]
        procs.append((name, source, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    out = {}
    for name, source, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise build.KernelBuildError(f"{name}:\n{log}")
        out[name] = (source, so, [ln.split(":", 1)[1].strip()
                                  for ln in log.splitlines() if "Used" in ln])
    return out


def _time(call) -> float:
    call()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        call()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def main() -> int:
    if not torch.cuda.is_available():
        print("design_variants: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    libs = build_variants()
    src, lens = sharded.upload_blocks(
        sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED), dev)
    cap = max_compressed_length(BLOCK_LEN)
    comp, clens, _ = codec.compress_fast_batch(src, lens, cap)
    kinds = torch.from_numpy(sharded.block_kinds(N_BLOCKS, SEED)).to(dev)
    rows = {"all": torch.arange(N_BLOCKS, device=dev),
            "a4": torch.nonzero(kinds == 0).flatten(),
            "text": torch.nonzero(kinds == 1).flatten()}
    stream = torch.cuda.current_stream().cuda_stream
    result = {}
    for rnd in range(2):            # two rounds, every variant in each
        for name, (source, so, regs) in libs.items():
            compress = source == "lz4_compress"
            fn = getattr(ctypes.CDLL(str(so)), "lz4tt_compress_fast" if compress
                         else "lz4tt_decompress_safe")
            fn.argtypes, fn.restype = _ARGS, ctypes.c_int
            for set_name, idx in rows.items():
                a, la = ((src, lens) if compress else (comp, clens))
                a, la = a[idx].contiguous(), la[idx].contiguous()
                n = a.shape[0]
                width = comp.shape[1] if compress else src.shape[1]
                out = torch.zeros((n, width), dtype=torch.uint8, device=dev)
                ol = torch.empty((n,), dtype=torch.int32, device=dev)
                err = torch.empty_like(ol)

                def call():
                    rc = fn(a.data_ptr(), a.stride(0), la.data_ptr(),
                            out.data_ptr(), out.stride(0),
                            cap if compress else BLOCK_LEN, ol.data_ptr(),
                            err.data_ptr(), n, stream)
                    if rc:
                        raise RuntimeError(f"{name}: CUDA error {rc}")

                call()
                torch.cuda.synchronize()
                want = (comp[idx], clens[idx]) if compress else \
                    (src[idx], lens[idx])
                w = cap if compress else BLOCK_LEN
                if bool(err.any()) or not torch.equal(ol, want[1]) or \
                        not torch.equal(out[:, :w], want[0][:, :w]):
                    raise SystemExit(f"design_variants: {name} differs from "
                                     f"the shipped kernel on {set_name} rows")
                ms = _time(call)
                result.setdefault(name, {"registers": regs}).setdefault(
                    set_name, []).append(ms)
                print(f"round {rnd}: {name}, {set_name} rows: {ms:.3f} ms",
                      flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
