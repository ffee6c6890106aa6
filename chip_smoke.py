#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lz4_tpu_torch``) on one GPU and hold each of
its kernels against its plain version.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. the card's name and power limit, torch and CUDA versions;
2. build of every kernel from ``lz4_tpu_torch/csrc`` (set-up, timed);
3. each kernel against its plain version on edge-case batches: block sizes
   around the format's limits, data kinds from zeros to incompressible, a
   tight ``dest_cap``, fuzz batches of malformed blocks with a guard region
   behind each output row (the safe and the fast decode), ragged hash
   lengths with two XXH32 and three XXH64 seeds, and n = 1 against the host
   hashes;
4. the main path: ``roundtrip_step`` on 4096 blocks of 64 KiB (256 MiB),
   3 iterations with launch counts reset just before and read just after,
   every block OK, the packed frame body equal to the one assembled on the
   host; then K1, K2 and K3 against their plain versions at those shapes,
   with the kernel's time (CUDA events), the plain version's time and the
   bound (bytes the function must move over 3.35 TB/s);
5. the ``cuda`` tier at the same width, through ``Lz4Factory`` and
   ``XXHashFactory``: the factories are built (their self-tests run on the
   card), then ``compress_batch``, ``decompress_batch``, the fast
   decompressor and both ``hash_batch`` calls on the main path's 256 MiB,
   with launch counts reset just before and read just after; then K4 and
   the fast decode against their plain versions at those shapes, timed;
6. the stream path: first the parser, K5 and the streaming updates
   against their plain versions on edge cases (edge sizes, periods 1-15,
   a null-offset block, fuzz, corrupted tables, a block that decodes past
   its size, random update splits and one 64 MiB update); then the parser
   and K5 on the main path's K2 output (4096 x 64 KiB), timed, with the
   plain versions on a subset of rows; then, with launch counts reset just
   before and read just after, the main path's 256 MiB through
   ``compress_stream(engine="cuda")`` (equal to ``compress_frame_packed``'s
   frame), ``decompress_stream`` with the ``segment`` and the ``cuda``
   engines, and ``python -m lz4_tpu_torch``'s ``xxh32`` and ``xxh64`` in
   this process; last, the command line in subprocesses: a 64 MiB file
   compressed with ``--engine cuda`` and restored with ``--engine segment``,
   and the hashes of a 4 MiB file against the host hashes;
7. ``compress_frame_packed`` on about 64 MiB, verified by decoding its
   blocks through the decode kernel and re-hashing on the host;
8. the launch counts, the per-kernel JSON line and the final JSON line.
"""

from __future__ import annotations

import contextlib
import io
import json
import pathlib
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from lz4_tpu_torch import Lz4Factory, XXHashFactory, testing
from lz4_tpu_torch.__main__ import main as cli_main
from lz4_tpu_torch.core import xxhash_ref
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.core.errors import Lz4Error
from lz4_tpu_torch.dist import sharded
from lz4_tpu_torch.entry import entry, example_blocks
from lz4_tpu_torch.formats.frame import (
    INCOMPRESSIBLE_MASK, frame_header, xxh32_bytes)
from lz4_tpu_torch.kernels import (
    build, codec, layout, segment_decode, sequences, xxhash, xxhash_stream)
from lz4_tpu_torch.streams import compress_stream, decompress_stream

SEED = 1234
N_BLOCKS = 4096
BLOCK_LEN = 1 << 16
ITERS = 3
TIMED_REPS = 5
PLAIN_ROWS = 1024                   # rows the plain K1, K2, fast decode run on
PLAIN_SEG_ROWS = 64                 # rows the plain parser and K5 run on
STREAM_BATCH = 256                  # compress_stream's default batch_blocks
CLI_BYTES = 64 << 20
HASH_FILE_BYTES = 4 << 20
BIG_UPDATE = 64 << 20
REPO = pathlib.Path(__file__).resolve().parent
FRAME_BYTES = (64 << 20) - 777      # a short last block
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
EDGE_SIZES = (0, 5, 12, 13, 1000, 65536, 70000)
GUARD = 64
GUARD_BYTE = 0xA5

KERNELS = {  # Kernel.name -> (source, TPU kernel it replaces)
    "lz4_compress": ("lz4_tpu_torch/csrc/lz4_compress.cu",
                     "lz4_tpu/kernels/lz4_pallas.py:676"),
    "lz4_decode": ("lz4_tpu_torch/csrc/lz4_decode.cu",
                   "lz4_tpu/kernels/lz4_pallas.py:309"),
    "xxh32": ("lz4_tpu_torch/csrc/xxh32.cu",
              "lz4_tpu/kernels/xxhash_pallas.py:156"),
    "xxh64": ("lz4_tpu_torch/csrc/xxh64.cu",
              "lz4_tpu/kernels/xxhash64_pallas.py:222"),
    # K1's second entry point: the fast contract of the pure-JAX
    # jax_codec.decompress_fast_batch, which has no Pallas kernel of its own
    "lz4_decode_fast": ("lz4_tpu_torch/csrc/lz4_decode.cu",
                        "lz4_tpu/kernels/lz4_pallas.py:309"),
    "segment_decode": ("lz4_tpu_torch/csrc/segment_decode.cu",
                       "lz4_tpu/kernels/segment_decode.py:215"),
    # not TPU kernels: the native parser the JAX package runs before K5,
    # and the pure-JAX streaming hash updates
    "lz4_parse": ("lz4_tpu_torch/csrc/lz4_parse.cu",
                  "lz4_tpu/native/src/tpulz4.cpp:1683"),
    "xxh32_stream": ("lz4_tpu_torch/csrc/xxh32.cu",
                     "lz4_tpu/kernels/xxhash_stream.py:109"),
    "xxh64_stream": ("lz4_tpu_torch/csrc/xxh64.cu",
                     "lz4_tpu/kernels/xxhash_stream.py:136"),
}
MAIN_PATH = ("lz4_compress", "lz4_decode", "xxh32")   # roundtrip_step
TIER_PATH = MAIN_PATH + ("xxh64", "lz4_decode_fast")
STREAM_PATH = ("lz4_compress", "lz4_decode", "lz4_parse", "segment_decode",
               "xxh32_stream", "xxh64_stream")
XXH64_SEEDS = (0, (1 << 64) - 1, 0xCAFEBABE12345678)


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# comparisons
# ---------------------------------------------------------------------------

def _row_diff(a: torch.Tensor, b: torch.Tensor, lens: torch.Tensor,
              rows: torch.Tensor, width: int) -> int:
    """Largest |a - b| over bytes [0, lens[i]) of the selected rows."""
    worst = 0
    if width == 0:
        return worst
    idx = torch.nonzero(rows).flatten()
    col = torch.arange(width, device=a.device)
    for c in range(0, idx.numel(), 256):
        r = idx[c:c + 256]
        mask = col < lens[r].unsqueeze(1)
        d = (a[r, :width].to(torch.int16) - b[r, :width].to(torch.int16)).abs()
        worst = max(worst, int((d * mask).max()) if r.numel() else 0)
    return worst


def compare_codec(what: str, kern, plain, width: int,
                  all_lens: bool = True) -> int:
    """Hold a kernel's ``(data, lens, err)`` against the plain version's:
    error codes on every row, lengths (on every row unless ``all_lens`` is
    off) and bytes ``[0, len)`` on OK rows. Returns the largest difference."""
    kd, kl, ke = kern
    pd, pl, pe = (t.to(kd.device) for t in plain)
    if not torch.equal(ke, pe):
        bad = torch.nonzero(ke != pe).flatten()[:8].tolist()
        fail(f"{what}: error codes differ at rows {bad}: "
             f"kernel {ke[bad].tolist()} plain {pe[bad].tolist()}")
    ok = ke == 0
    lens_rows = torch.ones_like(ok) if all_lens else ok
    if not torch.equal(kl[lens_rows], pl[lens_rows]):
        bad = torch.nonzero(lens_rows & (kl != pl)).flatten()[:8].tolist()
        fail(f"{what}: lengths differ at rows {bad}: "
             f"kernel {kl[bad].tolist()} plain {pl[bad].tolist()}")
    worst = _row_diff(kd, pd, kl, ok, width)
    if worst:
        fail(f"{what}: bytes differ on OK rows (max abs diff {worst})")
    return worst


def compare_compress(what, src, lens, dest_cap) -> int:
    kern = codec.compress_fast_batch(src, lens, dest_cap)
    plain = codec.compress_fast_plain(src, lens, dest_cap)
    sync()
    return compare_codec(what, kern, plain, dest_cap)


def compare_decode(what, comp, comp_lens, out_max, guard: bool = False) -> int:
    """Decode kernel vs plain. With ``guard``, both decode into buffers of
    ``out_max + GUARD`` bytes a row filled with ``GUARD_BYTE``, and the
    bytes from ``out_max`` on must come back unchanged."""
    bufs = [None, None]
    if guard:
        bufs = [torch.full((comp.shape[0], out_max + GUARD), GUARD_BYTE,
                           dtype=torch.uint8, device=comp.device)
                for _ in range(2)]
    kern = codec.decompress_safe_batch(comp, comp_lens, out_max, out=bufs[0])
    plain = codec.decompress_safe_plain(comp, comp_lens, out_max, out=bufs[1])
    sync()
    if guard:
        for name, buf in (("kernel", bufs[0]), ("plain", bufs[1])):
            if not bool((buf[:, out_max:] == GUARD_BYTE).all()):
                fail(f"{what}: {name} wrote past out_max={out_max}")
    return compare_codec(what, kern, plain, out_max, all_lens=False)


def compare_xxh32(what, data, lens, seed) -> int:
    kern = xxhash.xxh32_batch(data, lens, seed)
    plain = xxhash.xxh32_plain(data, lens, seed)
    sync()
    if not torch.equal(kern, plain):
        bad = torch.nonzero(kern != plain).flatten()[:8].tolist()
        fail(f"{what}: hashes differ at rows {bad}")
    return 0


def compare_xxh64(what, data, lens, seed) -> int:
    kern = xxhash.xxh64_batch(data, lens, seed)
    plain = xxhash.xxh64_plain(data, lens, seed)
    sync()
    if not torch.equal(kern, plain):
        bad = torch.nonzero(kern != plain).flatten()[:8].tolist()
        fail(f"{what}: hashes differ at rows {bad}")
    return 0


def compare_decode_fast(what, comp, avail, dest_len, rows=None) -> int:
    """Fast decode kernel vs plain, both into buffers of ``dest_len +
    GUARD`` bytes a row filled with ``GUARD_BYTE``: error codes on every
    row, bytes read and the ``dest_len`` bytes on OK rows, and the guard
    unchanged. ``rows`` (a slice) limits the plain version to some rows."""
    rows = rows or slice(None)
    bufs = [torch.full((comp.shape[0], dest_len + GUARD), GUARD_BYTE,
                       dtype=torch.uint8, device=comp.device)
            for _ in range(2)]
    kern = codec.decompress_fast_batch(comp, avail, dest_len, out=bufs[0])
    plain = codec.decompress_fast_plain(comp[rows], avail[rows], dest_len,
                                        out=bufs[1][rows])
    sync()
    for name, buf in (("kernel", bufs[0]), ("plain", bufs[1][rows])):
        if not bool((buf[:, dest_len:] == GUARD_BYTE).all()):
            fail(f"{what}: {name} wrote past dest_len={dest_len}")
    kern = (bufs[0][rows], kern[1][rows], kern[2][rows])
    full = torch.full_like(kern[1], dest_len)
    compare_codec(what, (kern[0], full, kern[2]), (plain[0], full, plain[2]),
                  dest_len)
    ok = kern[2] == 0
    if not torch.equal(kern[1][ok], plain[1].to(ok.device)[ok]):
        fail(f"{what}: bytes read differ on OK rows")
    return 0


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    return card


def phase_build() -> None:
    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {len(libs)} kernels in {time.perf_counter() - t0:.2f} s "
        f"({build.build_dir()})")
    for name in sorted(libs):
        report = (build.build_dir() / f"{name}.log").read_text()
        for line in report.splitlines():
            if "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")


def phase_edge_cases(dev) -> None:
    rng = np.random.default_rng(SEED)
    blocks = testing.mixed_blocks(rng, EDGE_SIZES)
    src, lens = layout.to_device_layout(blocks, device=dev)
    cap = max_compressed_length(max(EDGE_SIZES))
    compare_compress("K2 edge sizes", src, lens, cap)
    comp, comp_lens, err = codec.compress_fast_batch(src, lens, cap)
    if bool(err.any()):
        fail("K2 edge sizes: a block failed to compress")
    tight = codec.compress_fast_batch(src, lens, 600)[2]
    if not bool((tight == codec.ERR_DEST_TOO_SMALL).any()):
        fail("K2 tight dest_cap: no ERR_DEST_TOO_SMALL")
    compare_compress("K2 tight dest_cap", src, lens, 600)
    log(f"K2 == plain on {len(blocks)} edge blocks, and with dest_cap=600 "
        f"({int((tight != 0).sum())} ERR_DEST_TOO_SMALL)")

    compare_decode("K1 on K2 output", comp, comp_lens, max(EDGE_SIZES),
                   guard=True)
    out, out_lens, derr = codec.decompress_safe_batch(comp, comp_lens,
                                                      max(EDGE_SIZES))
    if layout.from_device_layout(out, out_lens) != blocks or bool(derr.any()):
        fail("K1 did not restore the edge blocks")
    fuzz = testing.fuzz_blocks(rng, layout.from_device_layout(comp, comp_lens),
                               512)
    fsrc, flens = layout.to_device_layout(fuzz, device=dev)
    codes = {}
    for out_max in (0, 1, 64, 1000, 70000):
        compare_decode(f"K1 fuzz out_max={out_max}", fsrc, flens, out_max,
                       guard=True)
        e = codec.decompress_safe_batch(fsrc, flens, out_max)[2]
        codes[out_max] = torch.bincount(e.long(), minlength=3).tolist()
    log(f"K1 == plain on K2 output and {len(fuzz)} fuzzed blocks; "
        f"guard intact; OK/MALFORMED/DEST_TOO_SMALL by out_max: {codes}")

    # the fast contract: exact blocks, the same with trailing bytes (more
    # available than the block needs), and fuzz
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    trailing = [c + rng.integers(0, 256, 9, dtype=np.uint8).tobytes()
                for c in comp_blocks]
    fast = comp_blocks + trailing + fuzz
    fsrc, favail = layout.to_device_layout(fast, device=dev)
    codes = {}
    for dest_len in (0, 1, 64, 1000, 65536, 70000):
        compare_decode_fast(f"K1 fast dest_len={dest_len}", fsrc, favail,
                            dest_len)
        _, read, e = codec.decompress_fast_batch(fsrc, favail, dest_len)
        exact = [i for i, b in enumerate(blocks) if len(b) == dest_len]
        exact += [i + len(blocks) for i in exact]
        if exact and (bool(e[exact].any()) or read[exact].tolist()
                      != [len(comp_blocks[i % len(blocks)]) for i in exact]):
            fail(f"K1 fast dest_len={dest_len}: an exact block failed or "
                 f"read other than its compressed length")
        codes[dest_len] = torch.bincount(e.long(), minlength=3).tolist()[:2]
    log(f"K1 fast == plain on K2 output, the same with 9 trailing bytes and "
        f"{len(fuzz)} fuzzed blocks; exact blocks OK with bytes read equal "
        f"to their compressed length; guard intact; OK/MALFORMED by "
        f"dest_len: {codes}")

    hash_lens = list(range(101)) + [1000, 65536]
    hsrc, hl = layout.to_device_layout(
        [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in hash_lens],
        device=dev)
    for seed in (0, 0xFFFFFFFF):
        compare_xxh32(f"K3 seed={seed:#x}", hsrc, hl, seed)
    one = rng.integers(0, 256, 4099, dtype=np.uint8).tobytes()
    osrc, ol = layout.to_device_layout([one], device=dev)
    compare_xxh32("K3 n=1", osrc, ol, 0)
    if int(xxhash.xxh32_batch(osrc, ol, 0)[0]) != xxh32_bytes(one):
        fail("K3 n=1 differs from the host hash")
    log(f"K3 == plain on lengths 0..100, 1000, 65536 (seeds 0, 0xFFFFFFFF) "
        f"and n=1")

    for seed in XXH64_SEEDS:
        compare_xxh64(f"K4 seed={seed:#x}", hsrc, hl, seed)
        compare_xxh64(f"K4 n=1 seed={seed:#x}", osrc, ol, seed)
        got = xxhash_ref.as_u64(int(xxhash.xxh64_batch(osrc, ol, seed)[0]))
        if got != xxhash_ref.xxh64(one, 0, len(one), seed):
            fail(f"K4 n=1 seed={seed:#x} differs from the host hash")
    log("K4 == plain on lengths 0..100, 1000, 65536 and n=1 (seeds 0, "
        "2^64-1, 0xCAFEBABE12345678); n=1 == the host hash")

    fn, args = entry(device=dev)
    out, out_lens, err = fn(*args)
    if bool(err.any()) or layout.from_device_layout(out, out_lens) != \
            example_blocks():
        fail("entry(): decode did not restore the example blocks")
    log("entry(): decode OK")


def _host_body(data: np.ndarray, comp: np.ndarray,
               comp_lens: list[int]) -> bytes:
    parts = []
    for i, cl in enumerate(comp_lens):
        raw = data[i].tobytes()
        if cl >= len(raw):
            parts += [struct.pack("<I", len(raw) | INCOMPRESSIBLE_MASK), raw]
        else:
            parts += [struct.pack("<I", cl), comp[i, :cl].tobytes()]
    return b"".join(parts)


def _time_kernel(fn) -> float:
    """Milliseconds per call of ``fn`` on the card (CUDA events)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TIMED_REPS):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / TIMED_REPS


def _time_plain(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_row(name: str, launches: dict, max_err: int, ms: float,
               plain_ms: float, nbytes: int, in_bytes: int,
               plain_rows: int | None = None) -> dict:
    """One entry of the ``kernels`` JSON line; the bound is ``nbytes`` (each
    input read once, each output written once) over the HBM rate.
    ``plain_rows`` is the rows the plain version was timed on (all of
    them unless given)."""
    plain_rows = plain_rows or N_BLOCKS
    src_file, replaces = KERNELS[name]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"{name}: {ms:.3f} ms on the card ({in_bytes / ms / 1e6:.2f} GB/s "
        f"of input), plain {plain_ms:.1f} ms on {plain_rows} of {N_BLOCKS} "
        f"rows, bound {bound_ms:.4f} ms, max abs err {max_err}, "
        f"{launches[name]} launches")
    return {"name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "plain_rows": plain_rows, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def phase_main_path(dev):
    """The main path; returns its kernel rows and what the tier phase
    compares with: the blocks and their K2 output."""
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    gib = N_BLOCKS * BLOCK_LEN / 2 ** 30
    st = None
    for i in range(ITERS):
        del st                          # one step's tensors live at a time
        t0 = time.perf_counter()
        st = sharded.roundtrip_step(N_BLOCKS, BLOCK_LEN, SEED, dev)
        sync()
        wall = (time.perf_counter() - t0) * 1e3
        n_ok = int(st.ok.sum())
        if n_ok != N_BLOCKS:
            fail(f"main path step {i}: {N_BLOCKS - n_ok} blocks not OK")
        rates = ", ".join(f"{k} {v:.3f} ms ({gib * 2 ** 30 / v / 1e6:.2f} GB/s)"
                          for k, v in st.phase_ms.items())
        log(f"step {i}: {N_BLOCKS} x {BLOCK_LEN} B OK, compressed "
            f"{st.compressed_total} B "
            f"({st.compressed_total / (gib * 2 ** 30):.4f}), body "
            f"{st.body_total} B; {rates}; step wall {wall:.1f} ms "
            f"(data made on the host included)")
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"main path launches: {launches}")
    log(f"peak device memory in the main path: {peak / 2 ** 30:.3f} GiB")
    for k in MAIN_PATH:
        if launches.get(k, 0) < 1:
            fail(f"kernel {k} was not launched on the main path")

    data = sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED)
    src, lens = sharded.upload_blocks(data, dev)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sharded.frame_body_packed(src, lens, st.comp, st.comp_lens)
    log(f"frame_body_packed temporaries: "
        f"{(torch.cuda.max_memory_allocated() - base) / 2 ** 30:.3f} GiB "
        f"(the body included)")
    comp_lens = st.comp_lens.cpu().tolist()
    offsets = np.cumsum([0] + comp_lens[:-1])
    if st.offsets.cpu().numpy().tolist() != offsets.tolist():
        fail("pack offsets are not the exclusive scan of compressed lengths")
    body = st.body[:st.body_total].cpu().numpy().tobytes()
    if body != _host_body(data, st.comp.cpu().numpy(), comp_lens):
        fail("packed frame body differs from the host-assembled body")
    log("offsets and packed body equal the host's")

    cap = max_compressed_length(BLOCK_LEN)
    n = N_BLOCKS
    in_bytes = int(lens.sum())
    comp_bytes = int(st.comp_lens.sum())
    rows = []

    # K2: input bytes + compressed bytes + lengths in, lengths and codes
    # out; the plain version on every (N / PLAIN_ROWS)-th row
    sub = slice(None, None, n // PLAIN_ROWS)
    kern = codec.compress_fast_batch(src, lens, cap)
    ssub, lsub = src[sub].contiguous(), lens[sub].contiguous()
    plain, plain_ms = _time_plain(
        lambda: codec.compress_fast_plain(ssub, lsub, cap))
    err = compare_codec("K2 main path", tuple(t[sub] for t in kern), plain,
                        cap)
    if not (torch.equal(kern[1], st.comp_lens) and bool((kern[2] == 0).all())):
        fail("K2 main path: lengths or codes differ from the step's")
    ms = _time_kernel(lambda: codec.compress_fast_batch(src, lens, cap))
    rows.append(kernel_row("lz4_compress", launches, err, ms, plain_ms,
                           in_bytes + comp_bytes + 12 * n, in_bytes,
                           plain_rows=ssub.shape[0]))
    del kern, plain, ssub

    # K1: compressed bytes + decoded bytes + lengths in, lengths, codes out
    comp, clens = st.comp, st.comp_lens
    kern = codec.decompress_safe_batch(comp, clens, BLOCK_LEN)
    csub, clsub = comp[sub].contiguous(), clens[sub].contiguous()
    plain, plain_ms = _time_plain(
        lambda: codec.decompress_safe_plain(csub, clsub, BLOCK_LEN))
    err = compare_codec("K1 main path", tuple(t[sub] for t in kern), plain,
                        BLOCK_LEN, all_lens=False)
    if not torch.equal(kern[0][:, :BLOCK_LEN], src[:, :BLOCK_LEN]):
        fail("K1 main path: decoded blocks differ from the input")
    ms = _time_kernel(lambda: codec.decompress_safe_batch(comp, clens,
                                                          BLOCK_LEN))
    rows.append(kernel_row("lz4_decode", launches, err, ms, plain_ms,
                           comp_bytes + in_bytes + 12 * n, in_bytes,
                           plain_rows=csub.shape[0]))
    del kern, plain, csub

    # K3: input bytes + lengths in, hashes out
    kern = xxhash.xxh32_batch(src, lens, 0)
    plain, plain_ms = _time_plain(lambda: xxhash.xxh32_plain(src, lens, 0))
    if not torch.equal(kern, plain) or not torch.equal(kern, st.hashes):
        fail("K3 main path: hashes differ from the plain version")
    ms = _time_kernel(lambda: xxhash.xxh32_batch(src, lens, 0))
    rows.append(kernel_row("xxh32", launches, 0, ms, plain_ms,
                           in_bytes + 8 * n, in_bytes))
    return rows, {"data": data, "comp": st.comp, "comp_lens": st.comp_lens}


def phase_tier(dev, main) -> list[dict]:
    """The ``cuda`` tier at the main path's width, through the factories a
    user calls; returns the K4 and fast-decode rows."""
    data = main["data"]
    n = data.shape[0]
    blocks = [r.tobytes() for r in data]
    lens_np = np.full((n,), BLOCK_LEN, np.int32)
    seed64 = XXH64_SEEDS[2]
    wall = {}

    def timed(what, fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall[what] = round((time.perf_counter() - t0) * 1e3, 1)
        return out

    build.reset_launch_counts()
    lz4 = timed("Lz4Factory.cuda_instance", Lz4Factory.cuda_instance)
    xxh = timed("XXHashFactory.cuda_instance", XXHashFactory.cuda_instance)
    comp = timed("compress_batch",
                 lambda: lz4.fast_compressor().compress_batch(blocks))
    restored = timed("decompress_batch",
                     lambda: lz4.safe_decompressor().decompress_batch(
                         comp, BLOCK_LEN))
    fast_out, src_read = timed(
        "fast decompress_batch",
        lambda: lz4.fast_decompressor().decompress_batch(comp, BLOCK_LEN))
    h32 = timed("hash32 hash_batch",
                lambda: xxh.hash32().hash_batch(data, lens_np, SEED))
    hi, lo = timed("hash64 hash_batch",
                   lambda: xxh.hash64().hash_batch(data, lens_np, seed64))
    # the host roles, on small inputs: HC and the streaming hashes
    hc = timed("high_compressor(9) on 4 KiB",
               lambda: lz4.high_compressor(9).compress_batch(
                   [blocks[0][:4096]]))
    stream = timed("streaming XXH64 of one block in 1000-byte updates",
                   lambda: _stream64(xxh, blocks[0], seed64))
    launches = build.launch_counts()
    log(f"tier launches: {launches}")
    log(f"tier host wall, ms (layout copies and transfers included): {wall}")
    log(f"tier roles on the card: fast_compressor (K2), safe_decompressor "
        f"(K1), fast_decompressor (K1 fast), hash32 (K3), hash64 (K4), the "
        f"streaming hashes (the stream entry points of K3 and K4); on the "
        f"host: high_compressor (core/lz4_hc_ref.py)")
    for k in TIER_PATH:
        if launches.get(k, 0) < 1:
            fail(f"kernel {k} was not launched on the tier path")

    if comp != layout.from_device_layout(main["comp"], main["comp_lens"]):
        fail("tier compress_batch differs from the main path's K2 output")
    if restored != blocks:
        fail("tier decompress_batch did not restore every block")
    if fast_out != blocks or src_read != [len(c) for c in comp]:
        fail("tier fast decompressor: blocks or bytes read differ")
    hash0 = (int(hi[0]) << 32) | int(lo[0])
    if stream != hash0:
        fail("streaming XXH64 differs from hash64().hash_batch")
    if lz4.safe_decompressor().decompress_alloc(
            hc[0], 0, len(hc[0]), 4096) != blocks[0][:4096]:
        fail("HC output does not decode")
    log(f"tier: {n} x {BLOCK_LEN} B compressed byte-identical to the main "
        f"path, every block restored by the safe and the fast decompressor, "
        f"bytes read equal to the compressed lengths; HC and streaming "
        f"XXH64 agree")

    src, lens = sharded.upload_blocks(data, dev)
    in_bytes = int(lens.sum())
    rows = []

    # K4: input bytes + lengths in, hashes out
    kern = xxhash.xxh64_batch(src, lens, seed64)
    plain, plain_ms = _time_plain(
        lambda: xxhash.xxh64_plain(src, lens, seed64))
    if not torch.equal(kern, plain):
        fail("K4 main path: hashes differ from the plain version")
    phi, plo = xxhash.split_u64(plain)
    if not (torch.equal(phi, hi) and torch.equal(plo, lo)):
        fail("tier hash64().hash_batch differs from the plain version")
    if not torch.equal(h32, xxhash.xxh32_plain(src, lens, SEED)):
        fail("tier hash32().hash_batch differs from the plain version")
    ms = _time_kernel(lambda: xxhash.xxh64_batch(src, lens, seed64))
    rows.append(kernel_row("xxh64", launches, 0, ms, plain_ms,
                           in_bytes + 12 * n, in_bytes))
    del kern, plain

    # fast decode: compressed bytes + decoded bytes + lengths in, bytes read
    # and codes out; the plain version on every (N / PLAIN_ROWS)-th row
    comp_t, clens = main["comp"], main["comp_lens"]
    comp_bytes = int(clens.sum())
    kern = codec.decompress_fast_batch(comp_t, clens, BLOCK_LEN)
    sub = slice(None, None, n // PLAIN_ROWS)
    csub, lsub = comp_t[sub].contiguous(), clens[sub].contiguous()
    plain, plain_ms = _time_plain(
        lambda: codec.decompress_fast_plain(csub, lsub, BLOCK_LEN))
    full = torch.full_like(lsub, BLOCK_LEN)
    err = compare_codec("K1 fast main path",
                        (kern[0][sub], full, kern[2][sub]),
                        (plain[0], full, plain[2]), BLOCK_LEN)
    if not torch.equal(kern[1][sub], plain[1].to(dev)):
        fail("K1 fast main path: bytes read differ from the plain version")
    if bool(kern[2].any()) or not torch.equal(kern[1], clens) or \
            not torch.equal(kern[0][:, :BLOCK_LEN], src[:, :BLOCK_LEN]):
        fail("K1 fast main path: a block failed, read other than its "
             "compressed length or decoded to other bytes")
    ms = _time_kernel(lambda: codec.decompress_fast_batch(comp_t, clens,
                                                          BLOCK_LEN))
    rows.append(kernel_row("lz4_decode_fast", launches, err, ms, plain_ms,
                           comp_bytes + in_bytes + 12 * n, in_bytes,
                           plain_rows=csub.shape[0]))
    return rows


def _stream64(xxh, block: bytes, seed: int) -> int:
    s = xxh.new_streaming_hash64(seed)
    for off in range(0, len(block), 1000):
        s.update(block, off, min(1000, len(block) - off))
    return xxhash_ref.as_u64(s.get_value())

# ---------------------------------------------------------------------------
# the stream path: parser, K5, streaming updates, pipeline, command line
# ---------------------------------------------------------------------------

def compare_parse(what, comp, comp_lens, max_seq=None, rows=slice(None)):
    """Parse kernel vs plain (the plain version on ``rows``): tables, codes
    and totals equal. Returns the kernel's output and the plain version's
    milliseconds."""
    kern = sequences.parse_sequences(comp, comp_lens, max_seq)
    csub, lsub = comp[rows].contiguous(), comp_lens[rows].contiguous()
    plain, plain_ms = _time_plain(
        lambda: sequences.parse_plain(csub, lsub, kern[0].shape[2]))
    for name, k, p in zip(("tables", "n_seq", "out_total"),
                          (kern[0][:, rows], kern[1][rows], kern[2][rows]),
                          plain):
        if not torch.equal(k, p.to(k.device)):
            fail(f"{what}: parse {name} differ from the plain version")
    return kern, plain_ms


def compare_segments(what, comp, comp_lens, n_seq, tables, out_max,
                     rows=slice(None)):
    """K5 vs plain (the plain version on ``rows``), both into buffers of
    ``out_max + GUARD`` bytes a row filled with ``GUARD_BYTE``: codes equal,
    every byte below ``out_max`` equal (error rows are zeros), the guard
    unchanged. Returns the kernel's (buffer, err) and the plain version's
    milliseconds."""
    n = comp.shape[0]
    buf = torch.full((n, out_max + GUARD), GUARD_BYTE, dtype=torch.uint8,
                     device=comp.device)
    pbuf = buf[rows].clone()
    _, err = segment_decode.decompress_segments(comp, comp_lens, n_seq, tables,
                                                out_max, out=buf)
    args = (comp[rows].contiguous(), comp_lens[rows].contiguous(),
            n_seq[rows].contiguous(), tables[:, rows].contiguous())
    (_, perr), plain_ms = _time_plain(
        lambda: segment_decode.decompress_segments_plain(*args, out_max,
                                                         out=pbuf))
    if not torch.equal(err[rows], perr.to(err.device)):
        bad = torch.nonzero(err[rows] != perr).flatten()[:8].tolist()
        fail(f"{what}: K5 codes differ from the plain version at rows {bad}")
    if not torch.equal(buf[rows], pbuf):
        fail(f"{what}: K5 bytes differ from the plain version")
    if not bool((buf[:, out_max:] == GUARD_BYTE).all()):
        fail(f"{what}: K5 wrote past out_max={out_max}")
    return (buf, err), plain_ms


def _stream_splits(rng, data: bytes) -> list[bytes]:
    cuts, pos = [], 0
    while pos < len(data):
        n = int(rng.choice([int(rng.integers(0, 41)), 1000, 65536]))
        cuts.append(data[pos:pos + n])
        pos += n
    return cuts


def _one_shot(data: bytes, bits: int, seed: int, dev) -> int:
    """K3/K4 with n = 1 over ``data``, unsigned."""
    flat = torch.zeros((1, layout.row_stride(len(data))), dtype=torch.uint8,
                       device=dev)
    flat[0, :len(data)] = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    n1 = torch.tensor([len(data)], dtype=torch.int32, device=dev)
    if bits == 32:
        return int(xxhash.xxh32_batch(flat, n1, seed)[0])
    return xxhash_ref.as_u64(int(xxhash.xxh64_batch(flat, n1, seed)[0]))


def _stream_edge_cases(dev, rng) -> None:
    """The streaming updates against their plain versions and the host
    hash on random update splits, and on one 64 MiB update."""
    data = rng.integers(0, 256, 1 << 20, dtype=np.uint8).tobytes()
    big = rng.integers(0, 256, BIG_UPDATE, dtype=np.uint8).tobytes()
    cases = [(32, xxhash_stream.StreamState32, s) for s in (0, 0xFFFFFFFF)]
    cases += [(64, xxhash_stream.StreamState64, s) for s in XXH64_SEEDS]
    ref = {32: xxhash_ref.xxh32, 64: xxhash_ref.xxh64}
    for i, (bits, cls, seed) in enumerate(cases):
        kern, plain = cls(seed, dev), cls(seed, "cpu")
        for cut in _stream_splits(rng, data):
            kern.update(cut)
            plain.update(cut)
            if kern.lanes.cpu().tolist() != plain.lanes.tolist():
                fail(f"XXH{bits} stream seed={seed:#x}: lanes differ from "
                     f"the plain version")
        if kern.digest() != plain.digest() or \
                kern.digest() != ref[bits](data, 0, len(data), seed):
            fail(f"XXH{bits} stream seed={seed:#x}: digest differs")
        kern, plain = cls(seed, dev), cls(seed, "cpu")
        kern.update(big)
        if i in (0, 2):         # the plain and host 64 MiB once per width
            plain.update(big)
            if kern.lanes.cpu().tolist() != plain.lanes.tolist() or \
                    kern.digest() != ref[bits](big, 0, len(big), seed):
                fail(f"XXH{bits} stream seed={seed:#x}: 64 MiB lanes or "
                     f"digest differ from the plain version or host hash")
        if kern.digest() != _one_shot(big, bits, seed, dev):
            fail(f"XXH{bits} stream seed={seed:#x}: 64 MiB digest differs "
                 f"from the one-shot kernel")
    log("stream updates == plain on random splits (lengths 0..40, 1000, "
        "65536) of 1 MiB, XXH32 seeds 0, 0xFFFFFFFF and XXH64 seeds 0, "
        "2^64-1, 0xCAFEBABE12345678, digests == host hash; one 64 MiB "
        "update == plain and host hash (first seed of each width) and == "
        "the one-shot kernel (every seed)")


def _segment_edge_cases(dev, rng) -> None:
    blocks = testing.mixed_blocks(rng, EDGE_SIZES)
    for size in (1024, 65536):
        blocks += [(rng.integers(0, 256, p, dtype=np.uint8).tobytes()
                    * (size // p + 1))[:size] for p in range(1, 16)]
    src, lens = layout.to_device_layout(blocks, device=dev)
    comp, comp_lens, err = codec.compress_fast_batch(
        src, lens, max_compressed_length(max(EDGE_SIZES)))
    if bool(err.any()):
        fail("stream edge cases: a block failed to compress")
    comp_blocks = layout.from_device_layout(comp, comp_lens)
    out_max = max(EDGE_SIZES)

    c, cl = layout.to_device_layout(comp_blocks + testing.boundary_blocks(),
                                    device=dev)
    (tables, n_seq, total), _ = compare_parse("parse edge blocks", c, cl)
    if n_seq[-2:].tolist() != [-2, -2] or bool((n_seq[:-2] < 0).any()):
        fail("parse edge blocks: a valid block was refused, or a boundary "
             "block accepted")
    (buf, err), _ = compare_segments("K5 edge blocks", c, cl, n_seq, tables,
                                     out_max)
    got = layout.from_device_layout(buf, total)
    if err[:-2].any() or got[:len(blocks)] != blocks or \
            got[len(blocks):-2] != [b"*" + bytes(4) + b"*" * 8, b"AAAAABBBBB"]:
        fail("K5 did not restore the edge blocks, the null-offset hole and "
             "the match reaching the output start")

    fuzz = testing.fuzz_blocks(rng, comp_blocks, 512)
    f, fl = layout.to_device_layout(fuzz, device=dev)
    (tables, n_seq, _), _ = compare_parse("parse fuzz", f, fl)
    narrow = compare_parse("parse fuzz, 40 sequences", f, fl, 40)[0][1]
    (_, ferr), _ = compare_segments("K5 fuzz", f, fl, n_seq, tables, out_max)
    codes = torch.bincount(n_seq.clamp(min=-3).long() + 3).tolist()[:2]
    log(f"parse == plain on {len(blocks)} edge blocks (periods 1-15 at 1 KiB "
        f"and 64 KiB included), 4 boundary blocks and {len(fuzz)} fuzzed "
        f"blocks (-3/-2 codes: {codes}, with 40 sequences: "
        f"{int((narrow == -3).sum())} x -3); K5 == plain on them, guard "
        f"intact, {int(ferr.sum())} fuzzed rows MALFORMED")

    bad = tables.clone()
    rows = torch.nonzero(n_seq > 1).flatten()[:16]
    bad[1, rows, 0] = f.shape[1]               # literals past the block
    (_, berr), _ = compare_segments("K5 corrupted tables", f, fl, n_seq, bad,
                                    out_max)
    if not bool((berr[rows] == codec.ERR_MALFORMED).all()):
        fail("K5 corrupted tables: a corrupted row was not MALFORMED")
    long_block = Lz4Factory.cuda_instance(dev).fast_compressor() \
        .compress_batch([bytes(range(16)) * 250])
    try:
        segment_decode.decompress_blocks(long_block, 64, dev)
    except Lz4Error:
        pass
    else:
        fail("decompress_blocks returned a block that decodes past out_len")
    log(f"K5 on {rows.numel()} corrupted table rows: MALFORMED in both, "
        f"guard intact; a block decoding past out_len raises")


def _stream_rows(dev, main, launches) -> list[dict]:
    """The parser and K5 on the main path's K2 output, and the streaming
    updates on one batch of it; timed, with their bounds. ``launches`` are
    the stream path's counts."""
    comp, clens = main["comp"], main["comp_lens"]
    n = comp.shape[0]
    comp_bytes = int(clens.sum())
    src, lens = sharded.upload_blocks(main["data"], dev)
    in_bytes = int(lens.sum())
    sub = slice(None, None, n // PLAIN_SEG_ROWS)
    rows = []

    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tables, n_seq, total = sequences.parse_sequences(comp, clens)
    out, err = segment_decode.decompress_segments(comp, clens, n_seq, tables,
                                                  BLOCK_LEN)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    k1 = codec.decompress_safe_batch(comp, clens, BLOCK_LEN)[0]
    if bool((n_seq < 0).any()) or not bool((total == BLOCK_LEN).all()) or \
            bool(err.any()) or \
            not torch.equal(out[:, :BLOCK_LEN], src[:, :BLOCK_LEN]) or \
            not torch.equal(out[:, :BLOCK_LEN], k1[:, :BLOCK_LEN]):
        fail("parse + K5 main path: a block was refused or differs from the "
             "input or from K1's output")
    del out, k1
    seqs = int(n_seq.sum())
    lit_bytes = int(tables[2].sum(dtype=torch.int64))
    s = tables.shape[2]
    log(f"parse + K5 on {n} x {BLOCK_LEN} B: {seqs} sequences "
        f"({seqs / n:.1f} a block), {lit_bytes} literal bytes, tables "
        f"{6 * 4 * n * s / 2 ** 30:.3f} GiB (S = {s}); every block equals "
        f"the input and K1's output; peak device memory of parse + K5 "
        f"{peak / 2 ** 30:.3f} GiB above the {base / 2 ** 30:.3f} GiB held")

    _, plain_ms = compare_parse("parse main path", comp, clens, rows=sub)
    ms = _time_kernel(lambda: sequences.parse_sequences(comp, clens))
    # compressed bytes + lengths in; tables, counts and totals out
    rows.append(kernel_row("lz4_parse", launches, 0, ms, plain_ms,
                           comp_bytes + 4 * n + 24 * n * s + 8 * n, in_bytes,
                           plain_rows=PLAIN_SEG_ROWS))
    _, plain_ms = compare_segments("K5 main path", comp, clens, n_seq, tables,
                                   BLOCK_LEN, rows=sub)
    ms = _time_kernel(lambda: segment_decode.decompress_segments(
        comp, clens, n_seq, tables, BLOCK_LEN))
    # literal bytes, 24 B of table a sequence, lengths and counts in; the
    # rows and codes out
    rows.append(kernel_row("segment_decode", launches, 0, ms, plain_ms,
                           lit_bytes + 24 * seqs + n * BLOCK_LEN + 12 * n,
                           in_bytes, plain_rows=PLAIN_SEG_ROWS))
    del tables

    # one update of a stream batch: STREAM_BATCH blocks of the input
    batch = src[:STREAM_BATCH, :BLOCK_LEN].contiguous().view(-1)
    host_batch = batch.cpu()
    for name, cls, absorb in (
            ("xxh32_stream", xxhash_stream.StreamState32,
             xxhash_stream.absorb32),
            ("xxh64_stream", xxhash_stream.StreamState64,
             xxhash_stream.absorb64)):
        kern, plain = cls(SEED, dev), cls(SEED, "cpu")
        absorb(kern.lanes, batch)
        _, plain_ms = _time_plain(lambda: absorb(plain.lanes, host_batch))
        if kern.lanes.cpu().tolist() != plain.lanes.tolist():
            fail(f"{name} main path: lanes differ from the plain version")
        ms = _time_kernel(lambda: absorb(kern.lanes, batch))
        # the batch's bytes and the lanes in, the lanes out
        rows.append(kernel_row(name, launches, 0, ms, plain_ms,
                               batch.numel() + 64, batch.numel(),
                               plain_rows=STREAM_BATCH))
    return rows


def _cli(*args) -> str:
    res = subprocess.run([sys.executable, "-m", "lz4_tpu_torch", *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, check=False)
    if res.returncode != 0:
        fail(f"python -m lz4_tpu_torch {' '.join(args)}: exit "
             f"{res.returncode}\n{res.stderr[-2000:]}")
    return res.stdout


def phase_stream(dev, main) -> list[dict]:
    """The stream path; returns the rows of the parser, K5 and the two
    streaming updates."""
    rng = np.random.default_rng(SEED + 2)
    _segment_edge_cases(dev, rng)
    _stream_edge_cases(dev, rng)

    raw = main["data"].tobytes()
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        tmp = pathlib.Path(tmp)
        cli_in = tmp / "cli.bin"
        cli_in.write_bytes(raw[:CLI_BYTES])
        wall = {}

        def timed(what, nbytes, fn):
            sync()
            t0 = time.perf_counter()
            out = fn()
            sync()
            dt = time.perf_counter() - t0
            wall[what] = f"{dt * 1e3:.1f} ms, {nbytes / dt / 1e6:.1f} MB/s"
            return out

        def decode(engine):
            out = io.BytesIO()
            decompress_stream(io.BytesIO(frame), out, engine=engine)
            return out.getvalue()

        build.reset_launch_counts()
        sink = io.BytesIO()
        timed("compress_stream(cuda)", len(raw), lambda: compress_stream(
            io.BytesIO(raw), sink, engine="cuda", batch_blocks=STREAM_BATCH))
        frame = sink.getvalue()
        del sink
        restored = {e: timed(f"decompress_stream({e})", len(raw),
                             lambda e=e: decode(e))
                    for e in ("segment", "cuda")}
        hashes = {}
        for cmd in ("xxh32", "xxh64"):
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                timed(f"main(['{cmd}']) on {CLI_BYTES >> 20} MiB", CLI_BYTES,
                      lambda cmd=cmd: cli_main([cmd, str(cli_in)]))
            hashes[cmd] = int(text.getvalue().split()[0], 16)
        launches = build.launch_counts()
        log(f"stream path launches: {launches}")
        log(f"stream path host wall ({len(raw) >> 20} MiB, "
            f"{len(raw) // BLOCK_LEN} blocks in batches of {STREAM_BATCH}): "
            f"{wall}")
        for k in STREAM_PATH:
            if launches.get(k, 0) < 1:
                fail(f"kernel {k} was not launched on the stream path")

        if frame != sharded.compress_frame_packed(raw, BLOCK_LEN, True, dev):
            fail("compress_stream(cuda) differs from compress_frame_packed")
        for engine, got in restored.items():
            if got != raw:
                fail(f"decompress_stream({engine}) did not restore the input")
        cli_raw = raw[:CLI_BYTES]
        if hashes["xxh32"] != _one_shot(cli_raw, 32, 0, dev) or \
                hashes["xxh64"] != _one_shot(cli_raw, 64, 0, dev):
            fail("the command line's hashes differ from the one-shot kernels")
        log(f"stream path: {len(raw)} B -> {len(frame)} B frame, equal to "
            f"compress_frame_packed's; restored exactly by the segment and "
            f"the cuda engines; xxh32/xxh64 of {CLI_BYTES >> 20} MiB equal "
            f"the one-shot kernels")
        del restored, frame

        t0 = time.perf_counter()
        cli_lz4, cli_back = tmp / "cli.lz4", tmp / "cli.back"
        log(_cli("compress", str(cli_in), str(cli_lz4), "--engine", "cuda")
            .strip())
        log(_cli("decompress", str(cli_lz4), str(cli_back), "--engine",
                 "segment").strip())
        if cli_back.read_bytes() != raw[:CLI_BYTES]:
            fail("the command line's round trip differs from the input")
        small = tmp / "hash.bin"
        small.write_bytes(raw[:HASH_FILE_BYTES])
        data = raw[:HASH_FILE_BYTES]
        got32 = _cli("xxh32", str(small)).split()[0]
        got64 = _cli("xxh64", str(small), "--seed", "0x123").split()[0]
        if got32 != f"{xxhash_ref.xxh32(data, 0, len(data), 0):08x}" or \
                got64 != f"{xxhash_ref.xxh64(data, 0, len(data), 0x123):016x}":
            fail("the command line's hashes differ from the host hashes")
        log(f"command line in subprocesses: {CLI_BYTES >> 20} MiB round trip "
            f"(compress --engine cuda, decompress --engine segment) equal; "
            f"xxh32/xxh64 of {HASH_FILE_BYTES >> 20} MiB equal the host "
            f"hashes; {time.perf_counter() - t0:.1f} s")
    return _stream_rows(dev, main, launches)


def phase_frame(dev) -> dict:
    raw = sharded.make_blocks(-(-FRAME_BYTES // BLOCK_LEN), BLOCK_LEN,
                              SEED + 1).tobytes()[:FRAME_BYTES]
    build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    frame = sharded.compress_frame_packed(raw, BLOCK_LEN, True, dev)
    wall = (time.perf_counter() - t0) * 1e3
    counts = build.launch_counts()

    if frame[:7] != frame_header(BLOCK_LEN, True):
        fail("frame header differs")
    pos, blocks, kinds = 7, [], []
    while True:
        (word,) = struct.unpack_from("<I", frame, pos)
        pos += 4
        if word == 0:
            break
        size = word & ~INCOMPRESSIBLE_MASK
        blocks.append(frame[pos:pos + size])
        kinds.append(bool(word & INCOMPRESSIBLE_MASK))
        pos += size
    (checksum,) = struct.unpack_from("<I", frame, pos)
    if pos + 4 != len(frame):
        fail("frame has bytes after its content checksum")
    packed = [b for b, r in zip(blocks, kinds) if not r]
    comp, comp_lens = layout.to_device_layout(packed, device=dev)
    out, out_lens, err = codec.decompress_safe_batch(comp, comp_lens,
                                                     BLOCK_LEN)
    if bool(err.any()):
        fail("frame: a block did not decode")
    decoded = iter(layout.from_device_layout(out, out_lens))
    restored = b"".join(b if r else next(decoded)
                        for b, r in zip(blocks, kinds))
    if restored != raw:
        fail("frame: decoded content differs from the input")
    if checksum != xxh32_bytes(raw):
        fail("frame: content checksum differs from the host hash")
    flat = torch.zeros((1, layout.row_stride(len(raw))), dtype=torch.uint8,
                       device=dev)
    flat[0, :len(raw)] = torch.frombuffer(bytearray(raw), dtype=torch.uint8)
    n1 = torch.tensor([len(raw)], dtype=torch.int32, device=dev)
    n1_ms = _time_kernel(lambda: xxhash.xxh32_batch(flat, n1, 0))
    log(f"K3 with n=1 over {len(raw)} B (the content checksum): "
        f"{n1_ms:.3f} ms ({len(raw) / n1_ms / 1e6:.2f} GB/s)")
    log(f"compress_frame_packed: {len(raw)} B -> {len(frame)} B in "
        f"{wall:.1f} ms host wall ({len(blocks)} blocks, {sum(kinds)} raw); "
        f"decoded through K1 and re-hashed on the host: OK; launches {counts}")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_card()
    phase_build()
    phase_edge_cases(dev)
    rows, main_out = phase_main_path(dev)
    rows += phase_tier(dev, main_out)
    rows += phase_stream(dev, main_out)
    del main_out
    phase_frame(dev)
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log("kernels: " + json.dumps({r["name"]: r["launches"] for r in rows}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
