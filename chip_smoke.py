#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``lz4_tpu_torch``) on one GPU and hold each of
its kernels against its plain version.

Run from the root of a checkout, on a machine with a CUDA card and ``nvcc``::

    python3 chip_smoke.py

(``python3 chip_smoke.py --pack-parse`` times only the main path's steps,
pack and the parser; see :func:`pack_parse_only`. ``python3 chip_smoke.py
--host-split`` runs only phase 7, on whichever package lies beside the
script, the one before the host data plane included; ``--parallel-stream``
only phase 8d's ``parallel`` engine calls, the full batch of 4 MiB blocks
and K7 on its rows included, on whichever package lies beside it.
``python3 chip_smoke.py --idle-split [cell ...] [--seed N] [--seconds S]``
runs each of the benchmark's cells (by default all) traced, as
``python3 -m benchmark.run --trace 1`` does, and splits its idle time by
the port's own spans; see :func:`idle_split`.)

Phases (any failure exits non-zero; nothing is caught):

1. the card's name and power limit, torch and CUDA versions;
2. build of every kernel from ``lz4_tpu_torch/csrc`` (set-up, timed), with
   nvcc's registers and spills, and K1's, K2's, K3's, K4's, K5's, K6's,
   K7's, K8's, the parser's and pack's resident CTAs per SM;
3. each kernel against its plain version on edge-case batches: block sizes
   around the format's limits, data kinds from zeros to incompressible, a
   tight ``dest_cap``, fuzz batches of malformed blocks with a guard region
   behind each output row (the safe and the fast decode), hand-built
   blocks for the decode's one-lane path and ring (periods 1-40, dist about
   len, runs about 16 and 32 bytes, null offsets, matches at the ring's
   edge), ragged hash lengths with two XXH32 and three XXH64 seeds, n = 1
   against the host hashes, and K3 and K4 on the launch shapes that change
   how their CTAs split the rows (n = 1, 2, 131, 132, 133 and 4096, ragged
   lengths around the ring's stage and whole size) against the plain
   versions, and on rows of 1 MiB against the host hashes; K1 with a
   history and K2 with a dictionary (``_window_edge_cases``) on matches
   into histories of 0 to 65,536 bytes, matches reaching before them,
   fuzz, tight caps and guards, and linked blocks in one buffer; the
   linked walk and resolve (``_linked_edge_cases``) on those blocks, fuzz
   and 300-byte linked blocks behind a window, the resolve on each of
   ``testing.resolve_case``'s batches (and a list too short), and linked
   frames with each fault decoded on the card and the CPU alike;
4. the main path: ``roundtrip_step`` on 4096 blocks of 64 KiB (256 MiB),
   3 iterations with launch counts reset just before and read just after,
   every block OK, the packed frame body equal to the one assembled on the
   host; then pack (``frame_body_packed``, one ``frame_pack`` launch), K1,
   K2 and K3 against their plain versions at those shapes,
   with the kernel's time (CUDA events), the plain version's time and the
   bound (bytes the function must move over 3.35 TB/s), and for K3 the
   chain bound of one row and the rows a CTA; then K2, K1 and K1
   fast on the a4, text and random rows apart, and K1 on 132, 1056 and
   4096 a4 rows;
4b. the LZ4Block stream (:func:`phase_lz4block`) at the benchmark cells'
   shape: 4,096 x 64 KiB of the benchmark's mix (``benchmark/data.py``,
   made on the card from the seed), compressed by K2, then
   ``block_stream_body_packed``, ``block_stream_index`` and
   ``decompress_block_stream_batch``, each with launch counts reset just
   before and read just after, each output held exactly to its plain
   version's (the decode's on every 8th record), the decode to the raw
   rows; then the pack, the index (its mark and chain kernels apart by
   ``torch.profiler``), the decode and the verdict timed alone, beside
   their bounds;
5. the ``cuda`` tier at the same width, through ``Lz4Factory`` and
   ``XXHashFactory``: the factories are built (their self-tests run on the
   card), then ``compress_batch``, ``decompress_batch``, the fast
   decompressor and both ``hash_batch`` calls on the main path's 256 MiB,
   twice,
   with launch counts reset just before and read just after; then K4 and
   the fast decode against their plain versions at those shapes, timed (K4
   also beside one row's chain bound);
6. the stream path: first the parser, K5 and the streaming updates
   against their plain versions on edge cases (edge sizes, periods 1-15,
   a null-offset block, fuzz, the parser's run and chain edges with table
   widths down to 1, corrupted and out-of-order tables, a block
   that decodes past its size, random update splits, single updates of
   both widths around the ring's stage size and one 64 MiB update, also
   held against K3 and K4 with n = 1); then the parser
   and K5 on the main path's K2 output (4096 x 64 KiB), timed, with the
   plain versions on a subset of rows, K5 and the parser on the a4, text
   and random rows apart (the parser at 256 rows and at all rows of a
   kind), and the XXH32 and XXH64 updates on 16 MiB and 1 MiB beside
   their chain bounds (the rounds with no loads) in cycles a stripe; then,
   with launch counts
   reset just before and read just after, the main path's 256 MiB through
   ``compress_stream(engine="cuda")`` (equal to ``compress_frame_packed``'s
   frame), ``decompress_stream`` with the ``segment`` and the ``cuda``
   engines, and ``python -m lz4_tpu_torch``'s ``xxh32`` and ``xxh64`` in
   this process, each of them twice; the same at ``batch_blocks=4`` on
   64 MiB (the frame equal to ``compress_frame_packed``'s), and a
   hand-built frame with block checksums and short blocks anywhere
   decoded by both engines at that batch size with one K3 launch a batch;
   last, the command line in subprocesses: a 64 MiB file
   compressed with ``--engine cuda`` and restored with ``--engine segment``,
   and the hashes of a 4 MiB file against the host hashes;
6b. HC (:func:`phase_hc`): K6 against its plain version (run a row a task
   in worker processes) on the edge sizes x zeros, a4, text and random at
   levels 1, 9 and 17, with every row tail 0xA5 too, on
   ``testing.hc_edge_blocks`` at levels 1-17 and at tight caps (n - 1, n,
   n + 1), and on 16 main-path rows of each kind at level 1 and 4 at level
   9; then, with launch counts reset just before and read just after,
   the tier's ``high_compressor(9).compress_batch`` on the main path's
   4096 blocks, twice (every block decoded back by K1; compressed sizes
   beside K2's by kind); K6 timed at levels 1, 9 and 17, at level 9 by
   kind and on 132, 1056 and 4096 a4 rows, and a4 rows alone (the chain
   floor); ``compress_stream(level=9)`` on 64 MiB twice, ``main(['compress',
   '-l', '9'])`` in this process and ``python -m lz4_tpu_torch compress
   -l 9`` in a subprocess, each frame equal to the one put together on the
   host from K6's blocks and decoded by both engines, K6 launched and K2
   never;
7. the host split (:func:`host_split`): the three stream calls and the
   tier's ``compress_batch`` and ``decompress_batch`` on the main path's
   256 MiB, and ``compress_stream(level=9)`` on 64 MiB of it, each twice
   untraced and twice under ``torch.profiler``, with
   the host time of each part of a batch, what no part covers and the
   card's busy and idle share;
8. ``compress_frame_packed`` on about 64 MiB, verified by decoding its
   blocks through the decode kernel and re-hashing on the host; then K3
   and K4 with n = 1 on that input, timed beside the byte and chain
   bounds;
8b. the ``dist`` path (:func:`phase_dist`): one rank over NCCL on
   ``cuda:0`` (a ``file://`` rendezvous, world size 1) runs
   ``sharded_roundtrip_step`` on 4096 blocks of 64 KiB 3 times, with launch
   counts reset just before and read just after (K1, K2, K3 and pack once
   a step), every block OK, its offsets, hashes and body equal to
   ``roundtrip_step``'s, each phase's CUDA-event time and the exchange's
   beside ``roundtrip_step``'s; then ``dryrun_multigpu`` with two ranks
   sharing the card (gloo) on 2 x 512 x 64 KiB and with four on 5 blocks
   (one rank empty), their frames, HC frame and ``shard_xxh64`` digests
   equal to one process's (``compress_frame_packed``, the tier's
   ``high_compressor(9)``, ``xxh64_batch``); and ``cuda_stream`` refusing
   an index past the card count; then the scaling modules
   (:func:`_dist_scaling`) with every rank on ``cuda:0`` (gloo; sharing
   one card, not scaling across cards) on 1,024 blocks of 64 KiB of the
   JAX workers' seeded alphabet-4 data (cut from the main path's 4096:
   the ten spawns of worker processes, about 8 s each, must stay near
   two minutes; ``python -m lz4_tpu_torch.dist.multihost_scaling`` and
   ``.scaling`` run the full width): ``multihost_scaling.measure`` at 2
   and 4 ranks and ``scaling.measure`` at widths 1, 2 and 4, one trial
   each, every digest equal to K2's output in this process on the same
   rows, with each call's wall;
8c. the container formats (:func:`phase_formats`) on 64 MiB at 64 KiB
   blocks with a 64 KiB dictionary: a dictionary frame written and read
   back (one K2-with-dictionary and one K1-with-history launch for the
   1,024 blocks) and through the serial reader; linked frames at 64 KiB
   and 4 MiB blocks, each decoded twice in one batch (one linked walk and
   one resolve), with the batch's peak device memory, and held against
   the serial reader (one K1-with-history launch a compressed block);
   ``decompress_stream`` of both (one walk and resolve a batch of 256
   blocks); LZ4Block streams (one K2, K3 and pack launch to write; one
   index, decode, K3 and verdict launch to read, K1-fast none); the
   command line's ``-D`` and ``--allow-dependent`` in this
   process; each call with launch counts reset just before and read just
   after, its host wall, and its output restored; then the two window
   kernels against their plain versions on 64 of the 1,024 rows, timed
   through their wrappers and alone, beside the same rows without a
   window and one row alone; and the linked walk (against its plain
   version on 8 rows) and resolve (on the first 64 blocks) timed on both
   frames' batches, the resolve also by its kernels' device times;
8d. the parallel compressor and the gather decode (:func:`phase_parallel`):
   K7 against its plain version on ``testing.parallel_blocks`` (sizes
   0-16, 511-513, 2047-2049, 65,535-65,537; zeros, a4, text, random,
   period 46, runs; row tails 0xA5), the window blocks, caps down to 0
   (-1 rows) and 16 rows of 4 MiB; the parser's sentinel tails and K8
   against their plain versions on K2's edge blocks, the chain blocks and
   a null offset, at max_depth 0-3 and 32; K7 on rows of three 64 KiB
   windows and 17 bytes (``testing.window_rows``: runs of period 1-4
   across every window end, a literal run over windows, one repeated
   byte, rows about one and two windows) and one byte repeated over 4 MiB
   + 1; K8 on ``testing.link_tables`` (chains of exactly 2^k - 1 and 2^k
   links, cycles, forward pointers) at max_depth 0-3 and 32; then K7 on
   the main path's 4096 blocks (timed beside K2, the plain version on 64
   rows, every block decoded back by K1, compressed bytes by kind beside
   K2's, peak device memory); with launch counts reset just before and
   read just after each
   call, ``compress_stream(engine="parallel")`` on 64 MiB twice (the frame
   equal to the one put together from K7's blocks), decoded by the
   ``cuda`` and ``segment`` engines, the same at 4 MiB blocks, and the
   command line's ``compress --engine parallel`` in a subprocess restored
   by ``decompress`` (K7 launched, K2 never), and the 64 KiB stream's K7
   launches (256 rows each) timed by CUDA events; a full batch of 256 ×
   4 MiB blocks through the stream (its K7 launch timed the same way, its
   peak memory and what it leaves allocated), then K7 on those 256 rows
   directly (timed; the 16 distinct rows against the plain version, every
   row against its copies and decoded back by K1; peak memory);
   ``get_engine("parallel", 9)`` raising; then K8 on the main path's K2
   output (timed beside K5 and K1, the plain version on 64 rows, max_depth
   0-3) and
   ``gather_decode.decompress_blocks`` restoring all 4096 blocks;
9. the launch counts, the per-kernel JSON line and the final JSON line.
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import ctypes
import importlib.util
import io
import json
import os
import pathlib
import pickle
import selectors
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as tdist

from lz4_tpu_torch import (
    Lz4Factory, XXHashFactory, dryrun_multigpu, formats, testing)
from lz4_tpu_torch.__main__ import main as cli_main
from lz4_tpu_torch.api import cuda_instances
from lz4_tpu_torch.core import xxhash_ref
from lz4_tpu_torch.core.constants import max_compressed_length
from lz4_tpu_torch.core.errors import Lz4Error, Lz4FrameError
from lz4_tpu_torch.dist import (
    mesh as dist_mesh, multihost, multihost_scaling, scaling, sharded)
from lz4_tpu_torch.entry import entry, example_blocks
from lz4_tpu_torch.formats import BlockSize, FrameFlag
from lz4_tpu_torch.formats.frame import (
    INCOMPRESSIBLE_MASK, frame_header, xxh32_bytes)
from lz4_tpu_torch.kernels import (
    build, codec, gather_decode, layout, linked_decode, parallel_compress,
    segment_decode, sequences, xxhash, xxhash_stream)
from lz4_tpu_torch.streams import (
    compress_stream, decompress_stream, get_engine)

try:    # the package before K6 has no kernels.hc; --host-split runs on it
    from lz4_tpu_torch.kernels import hc
except ImportError:
    hc = None

SEED = 1234
N_BLOCKS = 4096
BLOCK_LEN = 1 << 16
ITERS = 3
TIMED_REPS = 5
PLAIN_ROWS = 512                    # rows the plain K1, K2, fast decode run on
PLAIN_SEG_ROWS = 64                 # rows the plain parser and K5 run on
STREAM_BATCH = 256                  # compress_stream's default batch_blocks
OVERLAP_BATCH = 4                   # buffers reused while the hash overlaps
CLI_BYTES = 64 << 20
HASH_FILE_BYTES = 4 << 20
BIG_UPDATE = 64 << 20
REPO = pathlib.Path(__file__).resolve().parent
FRAME_BYTES = (64 << 20) - 777      # a short last block
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
EDGE_SIZES = (0, 5, 12, 13, 1000, 65536, 65546, 65547, 70000)
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
    # K1's safe decode a CTA a row, for batches that leave the card room
    "lz4_decode_smem": ("lz4_tpu_torch/csrc/lz4_decode.cu",
                        "lz4_tpu/kernels/lz4_pallas.py:309"),
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
    # the pure-JAX _frame_body_packed, which runs in the compress jit
    "frame_pack": ("lz4_tpu_torch/csrc/frame_pack.cu",
                   "lz4_tpu/dist/sharded.py:271"),
    # not a Pallas kernel: the pure-JAX HC phase machine the pallas tier
    # runs on its device
    "lz4_hc": ("lz4_tpu_torch/csrc/lz4_hc.cu",
               "lz4_tpu/kernels/jax_hc.py:479"),
    # not TPU kernels: the native history decode and dictionary compress
    # the JAX package runs on the host for linked and dictionary frames
    "lz4_decode_hist": ("lz4_tpu_torch/csrc/lz4_decode.cu",
                        "lz4_tpu/native/src/tpulz4.cpp:1199"),
    "lz4_compress_dict": ("lz4_tpu_torch/csrc/lz4_compress.cu",
                          "lz4_tpu/native/src/tpulz4.cpp:536"),
    # not Pallas kernels: the pure-JAX parallel compressor and gather decode
    "parallel_compress": ("lz4_tpu_torch/csrc/parallel_compress.cu",
                          "lz4_tpu/kernels/parallel_compress.py:323"),
    "gather_decode": ("lz4_tpu_torch/csrc/gather_decode.cu",
                      "lz4_tpu/kernels/gather_decode.py:168"),
    # not TPU kernels: the linked-frame decode a batch at a time, in place
    # of the native history decode the JAX package runs a block at a time
    # (the resolve carries gather_decode.py:127's pointer doubling across
    # blocks)
    "linked_walk": ("lz4_tpu_torch/csrc/linked_decode.cu",
                    "lz4_tpu/native/src/tpulz4.cpp:1199"),
    "linked_resolve": ("lz4_tpu_torch/csrc/linked_decode.cu",
                       "lz4_tpu/native/src/tpulz4.cpp:1199"),
    # not TPU kernels: the LZ4Block stream the JAX package writes and
    # reads a block at a time on the host (the writer's headers, the
    # reader's walk of them, its decode and its check)
    "lz4block_pack": ("lz4_tpu_torch/csrc/frame_pack.cu",
                      "lz4_tpu/formats/block_stream.py:64"),
    "lz4block_mark": ("lz4_tpu_torch/csrc/block_stream.cu",
                      "lz4_tpu/formats/block_stream.py:173"),
    "lz4block_chain": ("lz4_tpu_torch/csrc/block_stream.cu",
                       "lz4_tpu/formats/block_stream.py:173"),
    "lz4block_decode": ("lz4_tpu_torch/csrc/block_stream.cu",
                        "lz4_tpu/formats/block_stream.py:173"),
    "lz4block_verdict": ("lz4_tpu_torch/csrc/block_stream.cu",
                         "lz4_tpu/formats/block_stream.py:173"),
}
MAIN_PATH = ("lz4_compress", "lz4_decode", "xxh32",   # roundtrip_step
             "frame_pack")
TIER_PATH = ("lz4_compress", "lz4_decode", "xxh32", "xxh64", "lz4_decode_fast")
# a stream batch (STREAM_BATCH rows) fits the card in one round of K1's
# CTA-a-row kernel, which decodes it
STREAM_PATH = ("lz4_compress", "lz4_decode_smem", "lz4_parse", "segment_decode",
               "xxh32_stream", "xxh64_stream")
HC_PATH = ("lz4_hc", "frame_pack", "xxh32_stream")   # tier, stream, CLI at -l 9
XXH64_SEEDS = (0, (1 << 64) - 1, 0xCAFEBABE12345678)
OCCUPANCY = (("lz4_compress", "lz4tt_compress_occupancy"),
             ("lz4_decode", "lz4tt_decode_occupancy"),
             ("segment_decode", "lz4tt_segment_occupancy"),
             ("lz4_parse", "lz4tt_parse_occupancy"),
             ("frame_pack", "lz4tt_frame_pack_occupancy"),
             ("xxh32", "lz4tt_xxh32_occupancy"),
             ("xxh64", "lz4tt_xxh64_occupancy"),
             ("lz4_hc", "lz4tt_hc_occupancy"),
             ("lz4_decode", "lz4tt_decode_hist_occupancy"),
             ("lz4_decode", "lz4tt_decode_smem_occupancy"),
             ("parallel_compress", "lz4tt_parallel_occupancy"),
             ("gather_decode", "lz4tt_gather_occupancy"),
             ("linked_decode", "lz4tt_linked_occupancy"),
             ("linked_decode", "lz4tt_linked_segment_occupancy"))
KIND_NAMES = ("a4", "text", "random")    # sharded.block_kinds 0, 1, 2
A4_ROWS = (132, 1056, 4096)              # one block an SM, 8, 31
HC_LEVEL = 9                             # the default level
HC_LEVELS = (1, 9, 17)
HC_PLAIN_ROWS = {1: 16, 9: 4}            # main-path rows of each kind
HC_FLOOR_ROWS = 8                        # a4 rows timed alone
HC_REPS = 2
HC_WORKERS = 7                           # processes of the plain version
DIST_PATH = ("lz4_compress", "lz4_decode", "xxh32", "frame_pack")
DIST_SHARED_BLOCKS = 512                 # blocks a rank, two ranks one card
DIST_ODD = (4, 4 * BLOCK_LEN + 1234)     # 5 blocks over 4 ranks, one empty
DIST_TIMEOUT = 240.0                     # seconds a dry run's workers get
SCALING_BLOCKS = 1024                    # the scaling modules' workload, cut
SCALING_PROCS = (2, 4)                   # multihost_scaling's widths
SCALING_WIDTHS = (1, 2, 4)               # scaling's widths
FORMAT_BLOCKS = 1024                     # 64 MiB at 64 KiB blocks
LZ4BLOCK_PLAIN_STEP = 8                  # the plain decode's records: every 8th
FORMAT_PLAIN_ROWS = 64                   # rows the plain window codecs run on
LINKED_PATH = ("linked_walk", "linked_resolve", "xxh32", "xxh32_stream")
LINKED_PLAIN_ROWS = 8                    # rows the plain linked walk runs on
LINKED_PLAIN_BLOCKS = 64                 # blocks the plain resolve runs on
LINKED_BIG = 4 << 20                     # lz4 -BD's default block size
DICT_ID = 0x5EED
PARALLEL_PATH = ("parallel_compress", "frame_pack", "xxh32_stream")
GATHER_PATH = ("lz4_parse", "gather_decode")
PARALLEL_BIG_ROW = 4 << 20               # -B4MB frame blocks
PARALLEL_PLAIN_ROWS = 64                 # main-path rows the plain K7, K8 run on


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

def sm_clock_mhz() -> int:
    """The SM clock ``nvidia-smi`` reads now, in MHz."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return int(smi.stdout.split()[0])


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
    for source, symbol in OCCUPANCY:
        ctas, threads = build.occupancy(source, symbol)
        log(f"occupancy {source} ({symbol}): {ctas} resident CTAs of "
            f"{threads} threads an SM ({ctas * threads // 32} warps)")


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

    _short_sequence_cases(dev, rng)
    _smem_edge_cases(dev, rng, layout.from_device_layout(comp, comp_lens),
                     fuzz)
    _window_edge_cases(dev, rng)
    _linked_edge_cases(dev, rng)

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
    _hash_shape_cases(dev, rng)

    fn, args = entry(device=dev)
    out, out_lens, err = fn(*args)
    if bool(err.any()) or layout.from_device_layout(out, out_lens) != \
            example_blocks():
        fail("entry(): decode did not restore the example blocks")
    log("entry(): decode OK")


def rows_a_cta(bits: int, n: int) -> int:
    """Rows a CTA of K3 (``bits`` 32) or K4 (64) takes in a launch of
    ``n`` rows (``lz4tt_xxh32_rows``/``lz4tt_xxh64_rows``)."""
    fn = build.c_function(f"xxh{bits}", f"lz4tt_xxh{bits}_rows",
                          [ctypes.c_int, ctypes.POINTER(ctypes.c_int)])
    rows = ctypes.c_int(0)
    if fn(n, ctypes.byref(rows)):
        fail(f"lz4tt_xxh{bits}_rows: CUDA error")
    return rows.value


def _hash_shape_cases(dev, rng) -> None:
    """K3 and K4 on the launch shapes that change how their CTAs split
    the rows (n = 1, 2, 131, 132, 133 and 4096: one CTA a row while the
    rows fit on the card at once, then more), with ragged lengths around
    the ring's edges (0, 15, 16, a stage +- 16, the ring +- 16, 64 KiB),
    against the plain versions; then two rows of about 1 MiB against the
    host hashes (the plain versions take minutes at that length)."""
    st = xxhash_stream.STAGE_BYTES
    ring = 4 * st                          # LZ4TT_XXH_STAGES stages
    edges = [ring + 16, 0, 15, 16, 17, 31, 32, 33, 100, 1000, st - 16, st,
             st + 16, ring - 16, ring, 65536, 65547]
    seeds32 = (0, 0xFFFFFFFF)
    split = {}
    for i, n in enumerate((1, 2, 131, 132, 133, 4096)):
        if n == 4096:
            lens = rng.integers(0, BLOCK_LEN + 1, n)
            lens[:4] = (0, 15, 16, BLOCK_LEN)
        else:
            lens = np.array((edges * (n // len(edges) + 1))[:n])
            lens[len(edges):] = rng.integers(0, ring + 17,
                                             max(0, n - len(edges)))
        width = layout.row_stride(int(lens.max()))
        data = torch.from_numpy(rng.integers(0, 256, (n, width),
                                             dtype=np.uint8)).to(dev)
        lt = torch.from_numpy(lens.astype(np.int32)).to(dev)
        compare_xxh32(f"K3 n={n}", data, lt, seeds32[i % 2])
        compare_xxh64(f"K4 n={n}", data, lt, XXH64_SEEDS[i % 3])
        split[n] = (rows_a_cta(32, n), rows_a_cta(64, n))
    big = [rng.integers(0, 256, (1 << 20) + k, dtype=np.uint8).tobytes()
           for k in (0, 7)]
    bsrc, bl = layout.to_device_layout(big, device=dev)
    h32 = xxhash.xxh32_batch(bsrc, bl, 0).tolist()
    h64 = [xxhash_ref.as_u64(h)
           for h in xxhash.xxh64_batch(bsrc, bl, 0).tolist()]
    if h32 != [xxhash_ref.xxh32(b, 0, len(b), 0) for b in big] or \
            h64 != [xxhash_ref.xxh64(b, 0, len(b), 0) for b in big]:
        fail("K3/K4 on 1 MiB rows: differ from the host hashes")
    log(f"K3 and K4 == plain on n = 1, 2, 131, 132, 133 (lengths {edges} "
        f"and random up to {ring + 16}) and 4096 (random up to {BLOCK_LEN}); "
        f"rows a CTA of K3, K4 by n: {split}; rows of 1 MiB and 1 MiB + 7 "
        f"== the host hashes (seed 0)")


def _short_sequence_cases(dev, rng) -> None:
    """K1 (both entry points) on hand-built blocks for its one-lane path and
    its ring: periods 1-40, dist about len, runs about 16 and 32, null
    offsets, matches at the ring's edge; against the plain versions and
    the expected bytes, guard intact."""
    blocks = [b for case in testing.SHORT_CASES
              for b in testing.short_sequence_blocks(case, rng)]
    comp = [testing.encode_block(*b) for b in blocks]
    want = [testing.expand_block(*b) for b in blocks]
    c, cl = layout.to_device_layout(comp, device=dev)
    out_max = max(map(len, want))
    compare_decode("K1 short sequences", c, cl, out_max, guard=True)
    out, out_lens, err = codec.decompress_safe_batch(c, cl, out_max)
    if bool(err.any()) or layout.from_device_layout(out, out_lens) != want:
        fail("K1 short sequences: a block did not decode to its bytes")
    by_len = {}
    for i, w in enumerate(want):
        by_len.setdefault(len(w), []).append(i)
    for n, idx in by_len.items():
        rows = torch.tensor(idx, device=dev)
        fc, fl = c[rows].contiguous(), cl[rows].contiguous()
        compare_decode_fast(f"K1 fast short sequences ({n} B)", fc, fl, n)
        fout, read, ferr = codec.decompress_fast_batch(fc, fl, n)
        got = [r[:n].cpu().numpy().tobytes() for r in fout]
        if bool(ferr.any()) or not torch.equal(read, fl) or \
                got != [want[i] for i in idx]:
            fail(f"K1 fast short sequences ({n} B): a block failed")
    log(f"K1 and K1 fast == plain and the expected bytes on {len(blocks)} "
        f"hand-built blocks ({', '.join(testing.SHORT_CASES)}); guard intact")


def _smem_edge_cases(dev, rng, comp_blocks, fuzz) -> None:
    """K1's two safe kernels on the same rows: K2's output of the edge
    blocks, ``testing.far_match_blocks`` (matches 3,071 to 65,527 bytes
    back) and fuzz, as many as the CTA-a-row kernel holds at once (the
    wrapper takes it, the launch counts show), then one row more (the warp
    kernel), at out_max 0, 1, 4096, 65535 and 65536: codes, lengths and
    every byte of every row, errors' prefixes too, equal to the plain
    version's, a guard behind every row intact."""
    capacity = codec.smem_capacity(dev.index or 0)
    specs = testing.far_match_blocks(rng)
    far = [testing.encode_block(*b) for b in specs]
    blocks = (comp_blocks + far + fuzz * (capacity // len(fuzz) + 1))
    c, cl = layout.to_device_layout(blocks[:capacity + 1], device=dev)
    plain_rows = len(comp_blocks) + len(far) + 64
    for n, name in ((capacity, "lz4_decode_smem"), (capacity + 1,
                                                     "lz4_decode")):
        for out_max in (0, 1, 4096, 65535, 65536):
            bufs = [torch.full((n, out_max + GUARD), GUARD_BYTE,
                               dtype=torch.uint8, device=dev)
                    for _ in range(2)]
            before = build.launch_counts()
            kern = codec.decompress_safe_batch(c[:n], cl[:n], out_max,
                                               out=bufs[0])
            ran = {k: v - before[k] for k, v in build.launch_counts().items()
                   if v != before[k]}
            if ran != {name: 1}:
                fail(f"K1 at {n} rows, out_max={out_max}: launches {ran}")
            rows = slice(0, n if out_max <= 4096 else min(n, plain_rows))
            plain = codec.decompress_safe_plain(
                c[rows], cl[rows], out_max, out=bufs[1][rows])
            sync()
            same = (torch.equal(kern[2][rows], plain[2])
                    and torch.equal(bufs[0][rows], bufs[1][rows]))
            ok = plain[2] == codec.OK
            if not same or not torch.equal(kern[1][rows][ok], plain[1][ok]):
                fail(f"{name} at {n} rows, out_max={out_max}: codes, "
                     "lengths or bytes differ from the plain version")
            if not bool((bufs[0][:, out_max:] == GUARD_BYTE).all()):
                fail(f"{name} at {n} rows: wrote past out_max={out_max}")
    want = [testing.expand_block(*b) for b in specs]
    fc, fcl = layout.to_device_layout(far, device=dev)
    out, out_lens, err = codec.decompress_safe_batch(fc, fcl, testing.WHOLE)
    fits = [len(w) <= testing.WHOLE for w in want]
    if [e == codec.OK for e in err.tolist()] != fits or \
            [w for w, f in zip(want, fits) if f] != [
                r for r, f in zip(layout.from_device_layout(out, out_lens),
                                  fits) if f]:
        fail("K1 a CTA a row: the far-match blocks did not decode to their "
             "bytes")
    log(f"K1's two safe kernels == plain at {capacity} rows (a CTA a row; "
        f"its capacity) and {capacity + 1} (a warp a row), on K2's edge "
        f"output, {len(far)} far-match blocks and fuzz, out_max 0, 1, 4096, "
        f"65535, 65536, every byte of every row; guard intact")


def _window_edge_cases(dev, rng) -> None:
    """K1 with a history and K2 with a dictionary against their plain
    versions: matches at the history's start and straddling its end,
    periods 1-40 from its tail, sources in it within the ring and past
    it, null offsets, matches reaching before it (MALFORMED) and fuzz, at
    ``testing.HIST_LENS``, full and tight caps, a guard behind every row
    and the histories untouched; history length 0 equal to K1; the
    edge sizes of every kind against dictionaries of every length, at the
    full cap and at 600, decoded back; linked blocks in one buffer."""
    cases = testing.history_blocks(rng)
    comp = [testing.encode_block(s, t) for _, s, t in cases]
    want = [testing.expand_block(s, t, h) for h, s, t in cases]
    hists = [h for h, _, _ in cases]
    over = testing.overreach_blocks(rng)
    fuzz = testing.fuzz_blocks(rng, comp, 256)
    blocks = comp + [b for _, b in over] + fuzz
    hists += [h for h, _ in over] + [hists[i % len(cases)]
                                     for i in range(len(fuzz))]
    c, cl = layout.to_device_layout(blocks, device=dev)
    win, wl = testing.windows(hists, dev)
    before = win.clone()
    codes = {}
    for out_max in (70000, 1000, 64):
        bufs = [torch.full((c.shape[0], out_max + GUARD), GUARD_BYTE,
                           dtype=torch.uint8, device=dev) for _ in range(2)]
        kern = codec.decompress_safe_hist_batch(c, cl, out_max, win, wl,
                                                out=bufs[0])
        plain = codec.decompress_safe_hist_plain(c, cl, out_max, win, wl,
                                                 out=bufs[1])
        sync()
        for name, buf in (("kernel", bufs[0]), ("plain", bufs[1])):
            if not bool((buf[:, out_max:] == GUARD_BYTE).all()):
                fail(f"K1 hist out_max={out_max}: {name} wrote past out_max")
        compare_codec(f"K1 hist out_max={out_max}", kern, plain, out_max,
                      all_lens=False)
        if not torch.equal(win, before):
            fail("K1 hist: a history changed")
        codes[out_max] = torch.bincount(kern[2].long(), minlength=3).tolist()
        if out_max == 70000:
            n, m = len(want), len(over)
            if kern[2][:n + m].tolist() != [0] * n + [codec.ERR_MALFORMED] * m \
                    or layout.from_device_layout(kern[0][:n],
                                                 kern[1][:n]) != want:
                fail("K1 hist: a block did not decode to its bytes, or one "
                     "reaching before its history was not MALFORMED")
    zero, zl = testing.windows([b""] * c.shape[0], dev)
    for out_max in (1, 1000, 70000):
        a = codec.decompress_safe_hist_batch(c, cl, out_max, zero, zl)
        b = codec.decompress_safe_batch(c, cl, out_max)
        if not (torch.equal(a[2], b[2]) and torch.equal(a[0], b[0])
                and torch.equal(a[1][a[2] == 0], b[1][b[2] == 0])):
            fail(f"K1 hist with no history differs from K1 (out_max="
                 f"{out_max})")
    log(f"K1 hist == plain on {len(blocks)} blocks (histories of "
        f"{testing.HIST_LENS} bytes, {len(over)} reaching before theirs, "
        f"{len(fuzz)} fuzzed); guards and histories intact; OK/MALFORMED/"
        f"DEST_TOO_SMALL by out_max: {codes}; with no history == K1")

    srcs, dicts = [], []
    for hl in testing.HIST_LENS:
        d = testing.block_of(rng, "text", hl)
        for size in EDGE_SIZES:
            for kind in testing.KINDS:
                b = testing.block_of(rng, kind, size)
                srcs.append((d[-3000:] + b)[:size] if kind == "alphabet4"
                            else b)
                dicts.append(d)
    src, lens = layout.to_device_layout(srcs, device=dev)
    win, wl = testing.windows(dicts, dev)
    for cap in (600, max_compressed_length(max(EDGE_SIZES))):
        kern = codec.compress_dict_batch(src, lens, cap, win, wl)
        compare_codec(f"K2 dict cap={cap}", kern,
                      codec.compress_dict_plain(src, lens, cap, win, wl), cap)
    out, out_lens, err = codec.decompress_safe_hist_batch(
        kern[0], kern[1], max(EDGE_SIZES), win, wl)
    if bool(err.any()) or layout.from_device_layout(out, out_lens) != srcs:
        fail("K2 dict: a block did not decode back through K1 hist")
    raw = testing.block_of(rng, "text", 40 * 4096 - 99)
    comps = testing.linked_blocks(raw, 4096, dev)
    buf = torch.zeros((len(raw) + 4096,), dtype=torch.uint8, device=dev)
    pos = 0
    for blk in comps:
        bc, bcl = layout.to_device_layout([blk], device=dev)
        h0 = max(0, pos - codec.WINDOW)
        _, n, e = codec.decompress_safe_hist_batch(
            bc, bcl, 4096, buf[h0:max(pos, 1)].view(1, -1),
            torch.tensor([pos - h0], dtype=torch.int32, device=dev),
            out=buf[pos:pos + 4096].view(1, -1))
        if int(e[0]):
            fail("linked blocks in one buffer: a block failed")
        pos += int(n[0])
    if buf[:pos].cpu().numpy().tobytes() != raw:
        fail("linked blocks in one buffer: content differs")
    log(f"K2 dict == plain on {len(srcs)} blocks (edge sizes x kinds x "
        f"dictionaries of {testing.HIST_LENS} bytes) at caps 600 and full, "
        f"decoded back by K1 hist; {len(comps)} linked blocks of 4 KiB "
        f"decoded in one buffer")


def _linked_edge_cases(dev, rng) -> None:
    """The linked walk and resolve against their plain versions: the walk
    (as shipped, and with every block cut into chunks of 64 bytes) on K2's
    edge blocks, the boundary, chain, history and overreach blocks and
    fuzz (some flagged raw) at block sizes 64 KiB, 100 and 0 and at a
    table of 5 records; the resolve on linked blocks of 300 bytes behind a
    window of 5,000; then ``decode_frames`` of linked frames with a block
    reaching before the frame, one decoding past its slot, a block
    checksum mismatch and a cut stream, on the card and on the CPU, at
    batches of 2 and 256 blocks: bytes written and error equal."""
    raws = testing.mixed_blocks(rng, EDGE_SIZES)
    src, lens = layout.to_device_layout(raws, device=dev)
    comp, clens, _ = codec.compress_fast_batch(src, lens,
                                               max_compressed_length(70000))
    blocks = layout.from_device_layout(comp, clens)
    blocks += testing.boundary_blocks()
    blocks += [b for b, _ in testing.chain_blocks(rng)]
    blocks += [testing.encode_block(q, t)
               for _, q, t in testing.history_blocks(rng)]
    blocks += [b for _, b in testing.overreach_blocks(rng)]
    blocks += testing.fuzz_blocks(rng, blocks, 256)
    c, cl = layout.to_device_layout(blocks, device=dev)
    flags = torch.from_numpy(rng.random(len(blocks)) < 0.1).to(dev)
    width = linked_decode.table_width(cl.tolist(), flags.tolist())
    codes = {}
    host = (cl.tolist(), flags.tolist())
    for dest_cap, w in ((BLOCK_LEN, width), (100, width), (0, width),
                        (BLOCK_LEN, 5)):
        plain = linked_decode.walk_linked_plain(c, cl, flags, dest_cap, w)
        # the shipped walk, and every block cut into chunks of 64 bytes
        for chunk, whole in ((linked_decode.CHUNK, linked_decode.WHOLE_BELOW),
                             (64, 0)):
            kern = linked_decode._walk_cuda(c, cl, flags, dest_cap, w, host,
                                            chunk, whole)
            if not _walks_equal(kern, plain):
                fail(f"linked walk dest_cap={dest_cap} width={w} chunk="
                     f"{chunk}: differs from the plain version")
        codes[f"{dest_cap}/{w}"] = torch.bincount(kern[3].long(),
                                                  minlength=4).tolist()
    data = testing.block_of(rng, "alphabet4", 5000 + 300 * 200)
    comps = testing.linked_blocks(data, 300, dev)[17:]   # after 5,100 bytes
    raws = [data[i:i + 300] for i in range(17 * 300, len(data), 300)]
    pays = testing.payloads(raws, comps)
    c, cl = layout.to_device_layout(pays, device=dev)
    flags = torch.tensor([len(q) >= len(r) for r, q in zip(raws, comps)],
                         device=dev)
    win = layout.upload_bytes(data[:17 * 300], dev)
    walk = linked_decode.walk_linked(c, cl, flags, 300)
    plan = linked_decode.frame_plan(walk[2], walk[3], walk[4], win.numel())
    args = (c, walk[0], walk[1], plan[0], plan[2], plan[3], win,
            win.numel() + len(pays) * 300)
    kern, opened = linked_decode.resolve_linked(*args)
    want, _ = linked_decode.resolve_linked_plain(*args)
    m = int(plan[3])
    if int(plan[2]) != len(pays) or int(opened[-1]) or \
            not torch.equal(kern[:m], want[:m]) or \
            kern[:m].cpu().numpy().tobytes() != data[:m]:
        fail("linked resolve: 300-byte blocks differ from the plain version "
             "or the input")
    cases = _resolve_cases(dev, rng)
    outcomes = _linked_frame_faults(dev, rng)
    log(f"linked walk == plain on {len(blocks)} blocks, OK/MALFORMED/"
        f"DEST_TOO_SMALL/TOO_MANY by block size/table width: {codes}; "
        f"linked resolve == plain on {len(pays)} blocks of 300 B (open "
        f"after the pass, listed, rounds: {opened.tolist()[:3]}) and on "
        f"testing.resolve_case's batches (the same): {cases}; linked frames "
        f"on the card == on the CPU: {outcomes}")


def _resolve_cases(dev, rng) -> dict:
    """The resolve on each of ``testing.resolve_case``'s batches against its
    plain version (max abs error 0) and the batch's content, its open nodes
    and list against ``testing.resolve_sets``, no list entry left open;
    and in chunks of a third of its open exits and of one: the same bytes.
    Returns each case's (open, listed, rounds)."""
    out = {}
    for case in testing.RESOLVE_CASES:
        window, raws, comps, dest_cap, n_ok = testing.resolve_case(case, rng)
        c, cl = layout.to_device_layout(testing.payloads(raws, comps),
                                        device=dev)
        flags = torch.tensor([len(q) >= len(r) for r, q in zip(raws, comps)],
                             device=dev)
        win = layout.upload_bytes(window, dev) if window else \
            torch.empty((0,), dtype=torch.uint8, device=dev)
        walk = linked_decode.walk_linked(c, cl, flags, dest_cap)
        plan = linked_decode.frame_plan(walk[2], walk[3], walk[4], win.numel())
        args = (c, walk[0], walk[1], plan[0], plan[2], plan[3], win,
                win.numel() + len(raws) * dest_cap)
        kern, opened = linked_decode.resolve_linked(*args)
        want, _ = linked_decode.resolve_linked_plain(*args)
        m = int(plan[3])
        leaves, listed = testing.resolve_sets(
            walk[0], walk[1], plan[0], plan[2], win.numel(), m,
            linked_decode.SEGMENT)
        if int(plan[2]) != n_ok or int(opened[-1]) or \
                not torch.equal(kern[:m], want[:m]) or \
                kern[:m].cpu().numpy().tobytes() != \
                window + b"".join(raws[:n_ok]) or \
                opened.tolist()[:2] != [int(leaves.sum()), int(listed.sum())]:
            fail(f"linked resolve, case {case}: differs from the plain "
                 f"version, the input or the records "
                 f"({opened.tolist()}, {int(leaves.sum())}, "
                 f"{int(listed.sum())})")
        out[case] = opened.tolist()[:3]
        rooms = {"big_block": (int(opened[1]) // 3 + 1,),
                 "long_record": (1,)}
        for room in rooms.get(case, ()):
            part, popen = linked_decode._resolve_cuda(*args, room)
            if not torch.equal(part[:m], want[:m]) or \
                    popen.tolist()[:2] != opened.tolist()[:2] or popen[3]:
                fail(f"linked resolve, case {case}: in chunks of {room} "
                     f"differs ({popen.tolist()})")
    return out


def _linked_frame_faults(dev, rng) -> dict:
    """``decode_frames`` of a linked frame of 5 x 64 KiB a4 blocks, whole
    and with each fault, on the card and the CPU at batches of 2 and 256:
    the same bytes written and error; one walk and resolve a batch on the
    card, no history decode. Returns each case's error."""
    from lz4_tpu_torch.streams.pipeline import decode_frames

    data = testing.block_of(rng, "alphabet4", 5 * BLOCK_LEN + 999)
    raws = [data[i:i + BLOCK_LEN] for i in range(0, len(data), BLOCK_LEN)]
    good = testing.linked_blocks(data, BLOCK_LEN, dev)
    out = {}
    for fault in ("none", "reach", "oversized", "checksum", "premature"):
        comps = list(good)
        if fault == "reach":
            comps[0] = testing.encode_block([(b"ab", 100, 4)], b"x" * 9)
        elif fault == "oversized":
            comps[3] = testing.encode_block([(b"ab", 1, BLOCK_LEN)], b"x" * 9)
        frame = bytearray(testing.build_frame(raws, comps, independent=False))
        if fault == "checksum":
            frame[-40] ^= 1
        elif fault == "premature":
            frame = frame[:len(frame) // 2]
        seen = set()
        for batch in (2, 256):
            for d in (dev, torch.device("cpu")):
                sink = io.BytesIO()
                build.reset_launch_counts()
                try:
                    decode_frames(io.BytesIO(bytes(frame)), sink, "cuda", batch,
                                  d, allow_dependent=True)
                    err = None
                except Lz4Error as e:
                    err = f"{type(e).__name__}: {e}"
                counts = build.launch_counts()
                if d.type == "cuda" and (
                        counts["lz4_decode_hist"] or not counts["linked_walk"]
                        or counts["linked_walk"] != counts["linked_resolve"]):
                    fail(f"linked frame ({fault}): launches {counts}")
                seen.add((sink.getvalue(), err))
        if len(seen) != 1 or (fault == "none") != (err is None) or \
                (fault == "none" and sink.getvalue() != data):
            fail(f"linked frame ({fault}): the card and the CPU differ, or "
                 f"the outcome is wrong: {[e for _, e in seen]}")
        out[fault] = err
    return out


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


def _time_plain(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def kernel_row(name: str, launches: dict, max_err: int, ms: float | None,
               plain_ms: float, nbytes: int, in_bytes: int,
               plain_rows: int | None = None, rows: int = N_BLOCKS) -> dict:
    """One entry of the ``kernels`` JSON line; the bound is ``nbytes`` (each
    input read once, each output written once) over the HBM rate. ``ms``
    None where the kernel's time was not measured.
    ``plain_rows`` is the rows the plain version was timed on (all
    ``rows`` of the timed batch unless given)."""
    plain_rows = plain_rows or rows
    src_file, replaces = KERNELS[name]
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    timed = ("not measured" if ms is None else
             f"{ms:.3f} ms on the card ({in_bytes / ms / 1e6:.2f} GB/s of "
             f"input)")
    log(f"{name}: {timed}, plain {plain_ms:.1f} ms on {plain_rows} of {rows} "
        f"rows, bound {bound_ms:.4f} ms, max abs err {max_err}, "
        f"{launches[name]} launches")
    return {"name": name, "route": "cuda", "source": src_file,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "plain_rows": plain_rows, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None}


def time_by_kind(src, lens, comp, clens) -> dict:
    """K2, K1 and K1 fast on the a4, text and random rows of the main path
    apart; then K1 on ``A4_ROWS`` a4 rows (repeated past the 2048 there
    are): a time that does not grow with the rows is set by one block's
    chain, one that grows by issue slots. Returns ms by name."""
    kinds = torch.from_numpy(sharded.block_kinds(src.shape[0], SEED)).to(
        src.device)
    cap = max_compressed_length(BLOCK_LEN)
    ms = {}
    for k, name in enumerate(KIND_NAMES):
        idx = torch.nonzero(kinds == k).flatten()
        s, sl = src[idx].contiguous(), lens[idx].contiguous()
        c, cl = comp[idx].contiguous(), clens[idx].contiguous()
        ms[f"K2 {name}"] = testing.cuda_ms(
            lambda: codec.compress_fast_batch(s, sl, cap), TIMED_REPS)
        ms[f"K1 {name}"] = testing.cuda_ms(
            lambda: codec.decompress_safe_batch(c, cl, BLOCK_LEN),
            TIMED_REPS)
        ms[f"K1 fast {name}"] = testing.cuda_ms(
            lambda: codec.decompress_fast_batch(c, cl, BLOCK_LEN),
            TIMED_REPS)
    a4 = torch.nonzero(kinds == 0).flatten()
    for rows in A4_ROWS:
        pick = a4.repeat(-(-rows // a4.numel()))[:rows]
        c, cl = comp[pick].contiguous(), clens[pick].contiguous()
        ms[f"K1 {rows} a4 rows"] = testing.cuda_ms(
            lambda: codec.decompress_safe_batch(c, cl, BLOCK_LEN),
            TIMED_REPS)
    counts = torch.bincount(kinds, minlength=3).tolist()
    log(f"by kind (rows {dict(zip(KIND_NAMES, counts))}), ms on the card: "
        + json.dumps(ms))
    return ms


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

    # pack: the kernel against the plain version (torch gathers on the
    # card) on every row; payload bytes and lengths in, the body out
    kern = sharded.frame_body_packed(src, lens, st.comp, st.comp_lens)
    plain, plain_ms = _time_plain(lambda: sharded.frame_body_packed_plain(
        src, lens, st.comp, st.comp_lens))
    if kern[1] != plain[1] or not torch.equal(kern[0], plain[0]) or \
            not torch.equal(kern[0], st.body[:st.body_total]):
        fail("frame_pack main path: the body differs from the plain "
             "version's or the step's")
    del kern, plain
    pack = time_pack(src, lens, st.comp, st.comp_lens)
    rows.append(kernel_row("frame_pack", launches, 0, pack["pack_ms"],
                           plain_ms, 2 * pack["body_bytes"] + 4 * n,
                           pack["body_bytes"]))

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
    ms = testing.cuda_ms(lambda: codec.compress_fast_batch(src, lens, cap),
                         TIMED_REPS)
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
    ms = testing.cuda_ms(lambda: codec.decompress_safe_batch(
        comp, clens, BLOCK_LEN), TIMED_REPS)
    rows.append(kernel_row("lz4_decode", launches, err, ms, plain_ms,
                           comp_bytes + in_bytes + 12 * n, in_bytes,
                           plain_rows=csub.shape[0]))
    del kern, plain, csub

    # K3: input bytes + lengths in, hashes out
    kern = xxhash.xxh32_batch(src, lens, 0)
    plain, plain_ms = _time_plain(lambda: xxhash.xxh32_plain(src, lens, 0))
    if not torch.equal(kern, plain) or not torch.equal(kern, st.hashes):
        fail("K3 main path: hashes differ from the plain version")
    ms = testing.cuda_ms(lambda: xxhash.xxh32_batch(src, lens, 0), TIMED_REPS)
    rows.append(kernel_row("xxh32", launches, 0, ms, plain_ms,
                           in_bytes + 8 * n, in_bytes))
    rows[-1].update(_hash_batch_bounds(dev, 32, rows[-1], n))
    time_by_kind(src, lens, st.comp, st.comp_lens)
    return rows, {"data": data, "comp": st.comp, "comp_lens": st.comp_lens}


def phase_lz4block(dev) -> list[dict]:
    """The LZ4Block stream's three calls on a batch of the benchmark cells'
    shape (``N_BLOCKS`` x ``BLOCK_LEN`` of ``benchmark/data.py``'s mix, made
    on the card from ``SEED``, compressed by K2): each call's launches
    counted from a reset just before it, its output held exactly to its
    plain version's (the decode's on every ``LZ4BLOCK_PLAIN_STEP``-th
    record) and the decode to the raw rows; then each kernel timed alone
    (CUDA events; the index's two kernels apart by ``torch.profiler``),
    beside the bytes it must move. Returns their rows of the ``kernels``
    line."""
    from benchmark import data as bench_data
    from lz4_tpu_torch.kernels import block_stream as bs

    n, L = N_BLOCKS, BLOCK_LEN
    src, _ = bench_data.make_batch(n, L, layout.row_stride(L),
                                   bench_data.generator(SEED, dev), dev)
    lens = torch.full((n,), L, dtype=torch.int32, device=dev)
    comp, comp_lens, err = codec.compress_fast_batch(
        src, lens, max_compressed_length(L))
    if bool(err.any()):
        fail("lz4block: K2 failed on the benchmark's mix")
    launches = {}

    def counted(what, fn, want):
        build.reset_launch_counts()
        out = fn()
        sync()
        got = {k: v for k, v in build.launch_counts().items() if v}
        if got != want:
            fail(f"lz4block {what}: launches {got}, expected {want}")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        return out

    body, total = counted("pack", lambda: sharded.block_stream_body_packed(
        src, lens, comp, comp_lens, L), {"xxh32": 1, "lz4block_pack": 1})
    (want, want_total), pack_plain_ms = _time_plain(
        lambda: bs.block_stream_body_packed_plain(src, lens, comp, comp_lens,
                                                  L))
    if total != want_total or not torch.equal(body, want):
        fail("lz4block pack: the stream differs from the plain version's")
    del want
    index = counted("index", lambda: sharded.block_stream_index(
        body, total, n + 1), {"lz4block_index": 1})
    plain_index, index_plain_ms = _time_plain(
        lambda: bs.block_stream_index_plain(body, total, n + 1))
    if not (torch.equal(index.table, plain_index.table)
            and torch.equal(index.meta, plain_index.meta)
            and torch.equal(index.order, plain_index.order)):
        fail("lz4block index: the records differ from the plain version's")
    if index.meta.tolist() != [n + 1, total]:
        fail(f"lz4block index: meta {index.meta.tolist()}, expected "
             f"{[n + 1, total]}")
    out, out_lens, codes = counted(
        "decode", lambda: sharded.decompress_block_stream_batch(body, index, L),
        {"lz4block_decode": 1, "xxh32": 1, "lz4block_verdict": 1})
    if (codes.tolist() != [bs.OK] * (n + 1)
            or out_lens.tolist() != [L] * n + [0]
            or not torch.equal(out[:n, :L], src[:, :L])):
        fail("lz4block decode: the rows, lengths or codes are not the "
             "stream's blocks")
    sub = slice(None, None, LZ4BLOCK_PLAIN_STEP)
    plain, decode_plain_ms = _time_plain(
        lambda: bs.decompress_block_stream_batch_plain(body, index[sub], L))
    if not (torch.equal(codes[sub], plain[2])
            and torch.equal(out_lens[sub], plain[1])
            and torch.equal(out[sub][:, :L], plain[0][:, :L])):
        fail("lz4block decode: differs from the plain version")
    plain_records = plain[1].numel()
    del plain

    # the kernels alone, on the tensors above
    t = index.table
    raw = t[bs.METHOD] == bs.COMPRESSION_METHOD_RAW
    n_raw = int((raw & (t[bs.OLEN] > 0)).sum())
    payload = int(t[bs.CLEN].to(torch.int64).sum())
    records = n + 1
    emit = torch.where(lens > 0,
                       torch.minimum(lens, comp_lens) + bs.HEADER_LENGTH, 0)
    offs = (torch.cumsum(emit, 0) - emit).to(torch.int32)
    checks = xxhash.xxh32_rows(src, lens, bs.DEFAULT_SEED)
    stream = layout.cuda_stream(src)
    pack_ms = _time_alone(
        bs.LZ4BLOCK_PACK, src.data_ptr(), src.stride(0), lens.data_ptr(),
        comp.data_ptr(), comp.stride(0), comp_lens.data_ptr(),
        offs.data_ptr(), checks.data_ptr(), bs.compression_level(L),
        body.data_ptr(), total - bs.HEADER_LENGTH, n, stream)
    if not torch.equal(body, sharded.block_stream_body_packed(
            src, lens, comp, comp_lens, L)[0]):
        fail("lz4block pack: differs when launched alone")
    index_ms = testing.cuda_ms(
        lambda: bs.block_stream_index(body, total, n + 1), TIMED_REPS)
    index_us = testing.kernel_us(
        lambda: bs.block_stream_index(body, total, n + 1))
    hashes = xxhash.xxh32_rows(out, out_lens, bs.DEFAULT_SEED)
    decode_ms = _time_alone(
        bs.LZ4BLOCK_DECODE, body.data_ptr(), t.data_ptr(), t.stride(0),
        index.order.data_ptr(), records, out.data_ptr(), out.stride(0), L,
        out_lens.data_ptr(), codes.data_ptr(), stream)
    verdict_ms = _time_alone(
        bs.LZ4BLOCK_VERDICT, hashes.data_ptr(), t.data_ptr(), t.stride(0),
        out_lens.data_ptr(), codes.data_ptr(), records, stream)
    if codes.tolist() != [bs.OK] * records or \
            not torch.equal(out[:n, :L], src[:, :L]):
        fail("lz4block decode or verdict: differs when launched alone")

    def device_ms(kernel):
        us = [v for k, v in index_us.items() if kernel in k]
        return sum(us) / 1e3 if us else None

    in_bytes = n * L
    launches["lz4block_mark"] = launches["lz4block_chain"] = \
        launches["lz4block_index"]
    rows = [
        # the payloads read from their rows, four int32 a block (the two
        # lengths, the offset, the check), the stream written
        kernel_row("lz4block_pack", launches, 0, pack_ms, pack_plain_ms,
                   payload + 16 * n + total, in_bytes, rows=n),
        # the stream read once
        kernel_row("lz4block_mark", launches, 0, device_ms("lz4block_mark"),
                   index_plain_ms, total, total, rows=records),
        # 21 B read a record, its six fields and its place in the order
        # written
        kernel_row("lz4block_chain", launches, 0,
                   device_ms("lz4block_chain"), index_plain_ms,
                   (21 + 28) * records, total, rows=records),
        # the payloads read, the rows written, the record's fields read and
        # its length and code written
        kernel_row("lz4block_decode", launches, 0, decode_ms, decode_plain_ms,
                   payload + in_bytes + 32 * records, in_bytes,
                   plain_rows=plain_records, rows=records),
        # a hash, a check, a length and a code read, a code written
        kernel_row("lz4block_verdict", launches, 0, verdict_ms,
                   decode_plain_ms, 20 * records, 20 * records,
                   plain_rows=plain_records, rows=records)]
    for r in rows[1:3]:
        r["index_ms"] = index_ms
        r["index_kernels_us"] = index_us
    log(f"lz4block: {n} x {L} B, {n - n_raw} LZ4 and {n_raw} raw blocks, "
        f"stream {total} B, every call equal to its plain version, "
        f"launches {launches}; the index call {index_ms:.4f} ms, its "
        f"kernels (us) {json.dumps(index_us)}")
    return rows


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
    for rnd in (1, 2):          # the first call also grows the staging buffers
        comp = timed(f"compress_batch #{rnd}",
                     lambda: lz4.fast_compressor().compress_batch(blocks))
        restored = timed(f"decompress_batch #{rnd}",
                         lambda: lz4.safe_decompressor().decompress_batch(
                             comp, BLOCK_LEN))
        fast_out, src_read = timed(
            f"fast decompress_batch #{rnd}",
            lambda: lz4.fast_decompressor().decompress_batch(comp, BLOCK_LEN))
        h32 = timed(f"hash32 hash_batch #{rnd}",
                    lambda: xxh.hash32().hash_batch(data, lens_np, SEED))
        hi, lo = timed(f"hash64 hash_batch #{rnd}",
                       lambda: xxh.hash64().hash_batch(data, lens_np, seed64))
    # the streaming hash on a small input (HC has its own phase)
    stream = timed("streaming XXH64 of one block in 1000-byte updates",
                   lambda: _stream64(xxh, blocks[0], seed64))
    launches = build.launch_counts()
    log(f"tier launches: {launches}")
    log(f"tier host wall, ms (layout copies and transfers included): {wall}")
    log(f"tier roles on the card: fast_compressor (K2), safe_decompressor "
        f"(K1), fast_decompressor (K1 fast), hash32 (K3), hash64 (K4), the "
        f"streaming hashes (the stream entry points of K3 and K4); "
        f"high_compressor (K6) in the HC phase")
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
    log(f"tier: {n} x {BLOCK_LEN} B compressed byte-identical to the main "
        f"path, every block restored by the safe and the fast decompressor, "
        f"bytes read equal to the compressed lengths; streaming XXH64 "
        f"agrees")

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
    ms = testing.cuda_ms(lambda: xxhash.xxh64_batch(src, lens, seed64),
                         TIMED_REPS)
    rows.append(kernel_row("xxh64", launches, 0, ms, plain_ms,
                           in_bytes + 12 * n, in_bytes))
    rows[-1].update(_hash_batch_bounds(dev, 64, rows[-1], n))
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
    ms = testing.cuda_ms(lambda: codec.decompress_fast_batch(
        comp_t, clens, BLOCK_LEN), TIMED_REPS)
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
    and totals equal. Memory of the tables' size is filled with garbage
    and freed just before the launch, so that the caching allocator hands
    it to the wrapper's ``torch.empty``: the kernel must write every
    entry. Returns the kernel's output and the plain version's
    milliseconds."""
    s = max_seq or sequences.max_seq_for(int(comp_lens.max()))
    junk = torch.full((6, comp.shape[0], s), 0x5A5A5A5A, dtype=torch.int32,
                      device=comp.device)
    del junk
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


def _stage_edge_updates(dev, rng) -> list[int]:
    """Single XXH32 and XXH64 updates around the ring's stage size: 1
    stripe, a stage less one stripe, a stage, a stage and one stripe, the
    whole ring, one stripe past it, nine stages and a part (the ring twice
    and more), each with 7 bytes left over; lanes against the plain
    version, digests against the host hash. Returns the sizes."""
    st = xxhash_stream.STAGE_BYTES
    ring = 4 * st                      # LZ4TT_XXH_STAGES stages
    sizes = [16, 32, st - 32, st - 16, st, st + 16, st + 32, ring - 32,
             ring, ring + 16, ring + 32, 9 * st + 8272]
    cases = [(32, xxhash_stream.StreamState32, xxhash_ref.xxh32, s)
             for s in (0, 0xFFFFFFFF)]
    cases += [(64, xxhash_stream.StreamState64, xxhash_ref.xxh64, s)
              for s in XXH64_SEEDS[1:]]
    for n in sizes:
        data = rng.integers(0, 256, n + 7, dtype=np.uint8).tobytes()
        for bits, cls, ref, seed in cases:
            kern, plain = cls(seed, dev), cls(seed, "cpu")
            kern.update(data)
            plain.update(data)
            if kern.lanes.cpu().tolist() != plain.lanes.tolist() or \
                    kern.digest() != ref(data, 0, len(data), seed):
                fail(f"XXH{bits} stream update of {n + 7} B seed={seed:#x}: "
                     f"lanes or digest differ from the plain version or the "
                     f"host hash")
    return sizes


def _stream_edge_cases(dev, rng) -> None:
    """The streaming updates against their plain versions and the host
    hash on random update splits, single XXH32 updates around the stage
    size, and one 64 MiB update."""
    sizes = _stage_edge_updates(dev, rng)
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
        "K3/K4 with n = 1 on those 64 MiB (every seed); single XXH32 and "
        f"XXH64 updates of {[n + 7 for n in sizes]} B (stage "
        f"{xxhash_stream.STAGE_BYTES} B) == plain and host hash, seeds 0, "
        "0xFFFFFFFF and 2^64-1, 0xCAFEBABE12345678")


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

    _parse_run_cases(dev)

    bad = tables.clone()
    rows = torch.nonzero(n_seq > 1).flatten()[:16]
    bad[1, rows, 0] = f.shape[1]               # literals past the block
    (_, berr), _ = compare_segments("K5 corrupted tables", f, fl, n_seq, bad,
                                    out_max)
    if not bool((berr[rows] == codec.ERR_MALFORMED).all()):
        fail("K5 corrupted tables: a corrupted row was not MALFORMED")
    ooo = tables.clone()
    # the second sequence's literals one byte before the first one's end:
    # in bounds, out of order
    ooo[0, rows, 1] = ooo[3, rows, 0] + ooo[5, rows, 0] - 1
    (obuf, oerr), _ = compare_segments("K5 out-of-order tables", f, fl, n_seq,
                                       ooo, out_max)
    if not bool((oerr[rows] == codec.ERR_MALFORMED).all()) or \
            bool(obuf[rows, :out_max].any()):
        fail("K5 out-of-order tables: a row was not MALFORMED with zeros")
    long_block = Lz4Factory.cuda_instance(dev).fast_compressor() \
        .compress_batch([bytes(range(16)) * 250])
    try:
        segment_decode.decompress_blocks(long_block, 64, dev)
    except Lz4Error:
        pass
    else:
        fail("decompress_blocks returned a block that decodes past out_len")
    log(f"K5 on {rows.numel()} corrupted and {rows.numel()} out-of-order "
        f"table rows: MALFORMED in both, rows zeros, guard intact; a block "
        f"decoding past out_len raises")


def _parse_run_cases(dev) -> None:
    """The parser at the edges of its runs of 3-byte sequences and its
    chains of short ones (``testing.run_blocks``): a malformed offset at
    lanes 0, 1 and 31 of a step and at lanes 0 and 1 of the next, and at
    several places of a chain, runs and chains ending exactly at the block
    end or closed by last literals, length extensions of one byte and
    more, and table widths of 1, 2, 31, 32 and 33 inside a run and 101,
    102 around a 102-sequence block; against the plain version, then K5
    on them."""
    blocks = testing.run_blocks()
    c, cl = layout.to_device_layout(blocks, device=dev)
    for max_seq in (None, 1, 2, 31, 32, 33, 101, 102):
        (tables, n_seq, total), _ = compare_parse(
            f"parse run edges, max_seq={max_seq}", c, cl, max_seq)
        if max_seq is None:
            bad = testing.RUN_MALFORMED
            if n_seq[:bad].tolist() != [sequences.PARSE_MALFORMED] * bad or \
                    bool((n_seq[bad:] <= 0).any()):
                fail("parse run edges: a malformed row was accepted or a "
                     "valid one refused")
            out_max = int(total.max())
            compare_segments("K5 run edges", c, cl, n_seq, tables, out_max)
    log(f"parse == plain on {len(blocks)} run- and chain-edge blocks "
        f"(malformed offsets at run lanes {testing.RUN_BAD_AT} and chain "
        f"places {testing.CHAIN_BAD_AT}, ends at the block end) with widths "
        f"default, 1, 2, 31, 32, 33, 101, 102; K5 == plain on them")


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
    ms = testing.cuda_ms(lambda: sequences.parse_sequences(comp, clens),
                         TIMED_REPS)
    # compressed bytes + lengths in; tables, counts and totals out
    rows.append(kernel_row("lz4_parse", launches, 0, ms, plain_ms,
                           comp_bytes + 4 * n + 24 * n * s + 8 * n, in_bytes,
                           plain_rows=PLAIN_SEG_ROWS))
    _, plain_ms = compare_segments("K5 main path", comp, clens, n_seq, tables,
                                   BLOCK_LEN, rows=sub)
    ms = testing.cuda_ms(lambda: segment_decode.decompress_segments(
        comp, clens, n_seq, tables, BLOCK_LEN), TIMED_REPS)
    # literal bytes, 24 B of table a sequence, lengths and counts in; the
    # rows and codes out
    rows.append(kernel_row("segment_decode", launches, 0, ms, plain_ms,
                           lit_bytes + 24 * seqs + n * BLOCK_LEN + 12 * n,
                           in_bytes, plain_rows=PLAIN_SEG_ROWS))
    kinds = torch.from_numpy(sharded.block_kinds(n, SEED)).to(dev)
    by_kind = {}
    for k, name in enumerate(KIND_NAMES):
        idx = torch.nonzero(kinds == k).flatten()
        args = (comp[idx].contiguous(), clens[idx].contiguous(),
                n_seq[idx].contiguous(), tables[:, idx].contiguous())
        by_kind[f"K5 {name}"] = testing.cuda_ms(
            lambda: segment_decode.decompress_segments(*args, BLOCK_LEN),
            TIMED_REPS)
        del args
    log(f"K5 by kind, ms on the card: {json.dumps(by_kind)}")
    time_parse_by_kind(comp, clens)
    del tables
    at_sizes = _time_at_stream_sizes(src, lens, comp, clens)

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
        ms = testing.cuda_ms(lambda: absorb(kern.lanes, batch), TIMED_REPS)
        # the batch's bytes and the lanes in, the lanes out
        rows.append(kernel_row(name, launches, 0, ms, plain_ms,
                               batch.numel() + 64, batch.numel(),
                               plain_rows=STREAM_BATCH))
    for row, bits in zip(rows[-2:], (32, 64)):       # stripes of bits / 2 B
        row.update(_chain_bound(dev, bits, row, batch.numel() * 2 // bits))
        small = {"name": f"{row['name']} 1 MiB",
                 "ms": at_sizes[f"{row['name']} 1 MiB"]}
        chain = _chain_bound(dev, bits, small, (1 << 20) * 2 // bits)
        row.update({"ms_1mib": small["ms"],
                    "chain_bound_ms_1mib": chain["chain_bound_ms"]})
    return rows


def time_parse_by_kind(comp, clens) -> dict:
    """The parser on the a4, text and random rows of the main path's K2
    output apart, at the stream path's launch size (the first
    ``STREAM_BATCH`` rows of the kind) and at all rows of the kind, with
    the main path's table width; and, apart from any launch, the
    ``torch.zeros`` of tables of 256 and 4096 rows at that width (what
    the parser's wrapper did before its kernel wrote the zero tails).
    Returns ms by name."""
    n = comp.shape[0]
    kinds = torch.from_numpy(sharded.block_kinds(n, SEED)).to(comp.device)
    s = sequences.max_seq_for(int(clens.max()))
    ms = {}
    for k, name in enumerate(KIND_NAMES):
        idx = torch.nonzero(kinds == k).flatten()
        for rows in (STREAM_BATCH, idx.numel()):
            c = comp[idx[:rows]].contiguous()
            cl = clens[idx[:rows]].contiguous()
            ms[f"parse {name} {rows} rows"] = testing.cuda_ms(
                lambda: sequences.parse_sequences(c, cl, s), TIMED_REPS)
    for rows in (STREAM_BATCH, n):
        ms[f"torch.zeros of {rows} rows' tables"] = testing.cuda_ms(
            lambda: torch.zeros((6, rows, s), dtype=torch.int32,
                                device=comp.device), TIMED_REPS)
    log(f"parse by kind (S = {s}), ms on the card: {json.dumps(ms)}")
    return ms


def time_pack(src, lens, comp, clens) -> dict:
    """``frame_body_packed`` alone on the main path's blocks, beside its
    byte bound: each payload byte read once, the body written once, the
    lengths read."""
    n = src.shape[0]
    ms = testing.cuda_ms(lambda: sharded.frame_body_packed(
        src, lens, comp, clens), TIMED_REPS)
    total = int(sharded.frame_body_packed(src, lens, comp, clens)[1])
    nbytes = 2 * total + 4 * n
    out = {"pack_ms": ms, "pack_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "body_bytes": total}
    log(f"frame_body_packed on {n} blocks: {ms:.4f} ms for a body of {total} "
        f"B, bound {out['pack_bound_ms']:.4f} ms")
    return out


def _time_at_stream_sizes(src, lens, comp, clens) -> dict:
    """The stream path's kernels at the sizes it launches them: K2, K1,
    the parser and K5 on one batch (the first ``STREAM_BATCH`` rows), the
    updates on 1 MiB (the command line's chunks). Returns ms by name."""
    b = slice(0, STREAM_BATCH)
    s, sl = src[b].contiguous(), lens[b].contiguous()
    c, cl = comp[b].contiguous(), clens[b].contiguous()
    tables, n_seq, _ = sequences.parse_sequences(c, cl)
    cap = max_compressed_length(BLOCK_LEN)
    chunk = src[:16, :BLOCK_LEN].contiguous().view(-1)
    ms = {"lz4_compress": testing.cuda_ms(
              lambda: codec.compress_fast_batch(s, sl, cap), TIMED_REPS),
          "lz4_decode": testing.cuda_ms(
              lambda: codec.decompress_safe_batch(c, cl, BLOCK_LEN),
              TIMED_REPS),
          "lz4_parse": testing.cuda_ms(
              lambda: sequences.parse_sequences(c, cl), TIMED_REPS),
          "segment_decode": testing.cuda_ms(
              lambda: segment_decode.decompress_segments(c, cl, n_seq, tables,
                                                         BLOCK_LEN),
              TIMED_REPS)}
    for name, cls, absorb in (
            ("xxh32_stream 1 MiB", xxhash_stream.StreamState32,
             xxhash_stream.absorb32),
            ("xxh64_stream 1 MiB", xxhash_stream.StreamState64,
             xxhash_stream.absorb64)):
        lanes = cls(SEED, src.device).lanes
        ms[name] = testing.cuda_ms(lambda: absorb(lanes, chunk), TIMED_REPS)
    log(f"at the stream path's sizes ({STREAM_BATCH} rows a batch, 1 MiB "
        f"updates), ms on the card: {json.dumps(ms)}")
    return ms


def _chain_bound(dev, bits: int, row: dict, n_stripes: int) -> dict:
    """The chain bound of one XXH``bits`` row of ``n_stripes`` stripes:
    ``lz4tt_xxh<bits>_chain``, the shipped rounds on register data with no
    loads, one warp a lane, timed with CUDA events; the SM clock
    ``nvidia-smi`` reads while it runs; cycles a stripe at that clock of
    the chain and of the kernel (``row``, its kernel row: an update, or a
    one-shot hash of that one row)."""
    chain = build.c_function(f"xxh{bits}", f"lz4tt_xxh{bits}_chain",
                             [ctypes.c_longlong, ctypes.c_void_p,
                              ctypes.c_void_p])
    state = torch.zeros((4,), dtype=torch.uint32 if bits == 32 else torch.int64,
                        device=dev)
    stream = layout.cuda_stream(state)

    def call():
        if chain(n_stripes, state.data_ptr(), stream):
            fail(f"lz4tt_xxh{bits}_chain: CUDA error at launch")

    ms = testing.cuda_ms(call, TIMED_REPS)
    for _ in range(40):                 # the card busy while nvidia-smi reads
        call()
    mhz = sm_clock_mhz()
    sync()
    out = {"chain_bound_ms": ms, "sm_clock_mhz": mhz,
           "chain_cycles_per_stripe": ms * 1e-3 * mhz * 1e6 / n_stripes,
           "cycles_per_stripe": row["ms"] * 1e-3 * mhz * 1e6 / n_stripes}
    log(f"{row['name']} over {n_stripes} stripes: {row['ms']:.3f} ms, chain "
        f"bound {ms:.3f} ms (the rounds alone); at {mhz} MHz "
        f"{out['cycles_per_stripe']:.2f} cycles a stripe against the chain's "
        f"{out['chain_cycles_per_stripe']:.2f}")
    return out


def _hash_batch_bounds(dev, bits: int, row: dict, n: int) -> dict:
    """K3's (``bits`` 32) or K4's (64) kernel row at ``n`` rows of
    ``BLOCK_LEN``: the chain bound of one row (the least time if every row
    ran at once) beside the byte bound, and the rows a CTA takes."""
    ms = _chain_bound(dev, bits, {"name": f"one row of {row['name']}",
                                  "ms": row["ms"]},
                      BLOCK_LEN * 2 // bits)["chain_bound_ms"]
    split = rows_a_cta(bits, n)
    log(f"{row['name']} at {n} x {BLOCK_LEN} B: {row['ms']:.4f} ms against "
        f"the byte bound {row['bound_ms']:.4f} ms "
        f"({row['ms'] / row['bound_ms']:.2f}x) and one row's chain "
        f"{ms:.4f} ms; {split} rows a CTA, {-(-n // split)} CTAs")
    return {"chain_bound_ms": ms, "rows_a_cta": split}


def _cli(*args) -> str:
    res = subprocess.run([sys.executable, "-m", "lz4_tpu_torch", *args],
                         capture_output=True, text=True, timeout=300,
                         cwd=REPO, check=False)
    if res.returncode != 0:
        fail(f"python -m lz4_tpu_torch {' '.join(args)}: exit "
             f"{res.returncode}\n{res.stderr[-2000:]}")
    return res.stdout


def _overlap_cases(dev, raw: bytes) -> None:
    """The stream path in batches of ``OVERLAP_BATCH`` blocks, so that the
    pinned and device buffers are reused hundreds of times while the
    content hash runs on its own stream: ``compress_stream`` on the
    first ``CLI_BYTES`` of the input against ``compress_frame_packed``,
    and both engines restoring it; then a hand-built frame with block
    checksums and short blocks anywhere (``testing.ragged_sizes``,
    compressed and raw), whose batches leave content-hash remainders,
    through both engines: restored exactly, one K3 launch a batch."""
    data = raw[:CLI_BYTES]
    sink = io.BytesIO()
    t0 = time.perf_counter()
    compress_stream(io.BytesIO(data), sink, engine="cuda",
                    batch_blocks=OVERLAP_BATCH)
    walls = {"compress": round((time.perf_counter() - t0) * 1e3, 1)}
    if sink.getvalue() != sharded.compress_frame_packed(data, BLOCK_LEN, True,
                                                        dev):
        fail(f"compress_stream at batch_blocks={OVERLAP_BATCH} differs from "
             "compress_frame_packed")
    for engine in ("cuda", "segment"):
        out = io.BytesIO()
        t0 = time.perf_counter()
        decompress_stream(io.BytesIO(sink.getvalue()), out, engine=engine,
                          batch_blocks=OVERLAP_BATCH)
        walls[engine] = round((time.perf_counter() - t0) * 1e3, 1)
        if out.getvalue() != data:
            fail(f"decompress_stream({engine}) at batch_blocks="
                 f"{OVERLAP_BATCH} did not restore the input")

    rng = np.random.default_rng(SEED + 3)
    sizes = testing.ragged_sizes(rng, 4 * OVERLAP_BATCH * 10 + 3)
    pos = np.cumsum([0] + sizes)
    raw = raw * -(-int(pos[-1]) // len(raw))     # once at the full size
    raws = [raw[a:b] for a, b in zip(pos[:-1], pos[1:])]
    comps = Lz4Factory.cuda_instance(dev).fast_compressor().compress_batch(raws)
    frame = testing.build_frame(raws, comps)
    n_batches = -(-len(raws) // OVERLAP_BATCH)
    totals = [sum(sizes[i:i + OVERLAP_BATCH])
              for i in range(0, len(sizes), OVERLAP_BATCH)]
    if all(t % 16 == 0 for t in totals):
        fail("ragged frame: no batch leaves a content-hash remainder")
    for engine in ("cuda", "segment"):
        build.reset_launch_counts()
        out = io.BytesIO()
        decompress_stream(io.BytesIO(frame), out, engine=engine,
                          batch_blocks=OVERLAP_BATCH)
        counts = build.launch_counts()
        if out.getvalue() != b"".join(raws):
            fail(f"ragged frame through {engine}: not restored")
        if counts["xxh32"] != n_batches or counts["xxh32_stream"] < 1:
            fail(f"ragged frame through {engine}: {counts['xxh32']} K3 "
                 f"launches for {n_batches} batches")
    log(f"stream path at batch_blocks={OVERLAP_BATCH}: {len(data)} B "
        f"compressed equal to compress_frame_packed and restored by both "
        f"engines (host wall, ms: {walls}); a frame of {len(raws)} blocks "
        f"with block checksums, {sum(s < BLOCK_LEN for s in sizes)} short "
        f"and {sum(len(c) >= len(r) for r, c in zip(raws, comps))} raw, "
        f"restored by both engines with one K3 launch a batch "
        f"({n_batches}); {sum(t % 16 != 0 for t in totals)} batches left a "
        f"content-hash remainder")


def phase_stream(dev, main) -> list[dict]:
    """The stream path; returns the rows of the parser, K5 and the two
    streaming updates."""
    rng = np.random.default_rng(SEED + 2)
    _segment_edge_cases(dev, rng)
    _stream_edge_cases(dev, rng)

    raw = main["data"].tobytes()
    _overlap_cases(dev, raw)
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
        for rnd in (1, 2):
            sink = io.BytesIO()
            timed(f"compress_stream(cuda) #{rnd}", len(raw),
                  lambda: compress_stream(io.BytesIO(raw), sink, engine="cuda",
                                          batch_blocks=STREAM_BATCH))
            frame = sink.getvalue()
            del sink
            restored = {e: timed(f"decompress_stream({e}) #{rnd}", len(raw),
                                 lambda e=e: decode(e))
                        for e in ("segment", "cuda")}
            hashes = {}
            for cmd in ("xxh32", "xxh64"):
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    timed(f"main(['{cmd}']) on {CLI_BYTES >> 20} MiB #{rnd}",
                          CLI_BYTES,
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


# ---------------------------------------------------------------------------
# HC (K6)
# ---------------------------------------------------------------------------

_HC_WORKER = """
import pickle, sys, time
from lz4_tpu_torch.kernels import hc, layout
out, sys.stdout = sys.stdout.buffer, sys.stderr
while True:
    try:
        data, dest_cap, level = pickle.load(sys.stdin.buffer)
    except EOFError:
        break
    t0 = time.perf_counter()
    src, lens = layout.to_device_layout([data], device="cpu")
    dest, n, err = hc.compress_hc_plain(src, lens, dest_cap, level)
    pickle.dump((dest[0].numpy().tobytes(), int(n[0]), int(err[0]),
                 time.perf_counter() - t0), out)
    out.flush()
"""


class PlainPool:
    """Worker processes of K6's plain version, a row a task: each one is a
    ``python -c`` that reads pickled ``(bytes, dest_cap, level)`` jobs on
    its stdin and writes ``(row bytes, len, code, seconds)`` on its stdout.
    Leaving the ``with`` ends and reaps every worker (killed if the block
    raised), so no process outlives the script."""

    def __init__(self, workers: int):
        self.procs = []
        try:
            for _ in range(workers):
                self.procs.append(subprocess.Popen(
                    [sys.executable, "-c", _HC_WORKER], cwd=REPO,
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        except BaseException:
            self.close(kill=True)
            raise

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *_):
        self.close(kill=exc_type is not None)

    def close(self, kill: bool = False) -> None:
        for p in self.procs:
            if kill:
                p.kill()
            with contextlib.suppress(OSError):
                p.stdin.close()
        for p in self.procs:
            try:
                p.wait(timeout=60)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
        self.procs = []

    def map(self, jobs: list) -> list:
        """The results of ``jobs`` in order; a free worker takes the next."""
        res = [None] * len(jobs)
        todo = list(enumerate(jobs))[::-1]
        idle, busy = list(self.procs), {}
        with selectors.DefaultSelector() as sel:
            for p in self.procs:
                sel.register(p.stdout, selectors.EVENT_READ, p)
            while todo or busy:
                while todo and idle:
                    p = idle.pop()
                    i, job = todo.pop()
                    pickle.dump(job, p.stdin)
                    p.stdin.flush()
                    busy[p] = i
                for key, _ in sel.select():
                    p = key.data
                    if p not in busy:
                        fail(f"plain HC worker exited with {p.poll()}")
                    try:
                        res[busy.pop(p)] = pickle.load(p.stdout)
                    except EOFError:
                        fail(f"plain HC worker exited with {p.wait()}")
                    idle.append(p)
        return res


def hc_plain(pool, src, lens, dest_cap, level):
    """K6's plain version (``hc.compress_hc_plain``) on the rows of a batch,
    a row a task in the worker processes of ``pool`` (a :class:`PlainPool`);
    returns its ``(dest, lens, err)`` and the seconds the rows took, summed."""
    rows = src.cpu().numpy()
    jobs = [(rows[i, :n].tobytes(), dest_cap, level)
            for i, n in enumerate(lens.cpu().tolist())]
    res = pool.map(jobs)
    dest = np.zeros((len(res), layout.row_stride(dest_cap)), np.uint8)
    for i, r in enumerate(res):
        dest[i] = np.frombuffer(r[0], np.uint8)
    return ((torch.from_numpy(dest),
             torch.tensor([r[1] for r in res], dtype=torch.int32),
             torch.tensor([r[2] for r in res], dtype=torch.int32)),
            sum(r[3] for r in res))


def compare_hc(pool, what, src, lens, dest_cap, level, rows=None) -> float:
    """K6 against its plain version on the rows ``rows`` (an index tensor,
    all by default) of one launch on the whole batch: codes and lengths
    on every row, bytes on OK rows. Returns the plain version's seconds."""
    kern = hc.compress_hc_batch(src, lens, dest_cap, level)
    if rows is not None:
        src, lens = src[rows].contiguous(), lens[rows].contiguous()
        kern = tuple(t[rows] for t in kern)
    plain, secs = hc_plain(pool, src, lens, dest_cap, level)
    sync()
    compare_codec(what, kern, plain, dest_cap)
    return secs


def _tails(src, lens):
    """``src`` with every byte past a row's length ``GUARD_BYTE``."""
    col = torch.arange(src.shape[1], device=src.device)
    return torch.where(col[None, :] >= lens[:, None].long(),
                       torch.full_like(src, GUARD_BYTE), src)


def _hc_edge_cases(dev, pool) -> None:
    """K6 against its plain version on ``EDGE_SIZES`` x the HC kinds at
    levels 1, 9 and 17, on ``testing.hc_edge_blocks`` and
    ``testing.hc_collision_blocks`` (where the speculated walk's links
    fail) at every level, with tight caps (n - 1, n, n + 1 of rows'
    outputs), and with every row tail ``GUARD_BYTE`` (the same output)."""
    rng = np.random.default_rng(SEED + 5)
    src, lens = layout.to_device_layout(
        [testing.block_of(rng, k, n) for n in EDGE_SIZES
         for k in testing.HC_KINDS], device=dev)
    cap = max_compressed_length(max(EDGE_SIZES))
    tails = _tails(src, lens)
    for level in HC_LEVELS:
        compare_hc(pool, f"K6 edge sizes, level {level}", src, lens, cap,
                   level)
        a = hc.compress_hc_batch(src, lens, cap, level)
        b = hc.compress_hc_batch(tails, lens, cap, level)
        if not all(torch.equal(x, y) for x, y in zip(a, b)):
            fail(f"K6 level {level}: row tails of {GUARD_BYTE:#x} change "
                 "the output")
    edge, elens = layout.to_device_layout(testing.hc_edge_blocks(rng),
                                          device=dev)
    ecap = max_compressed_length(int(elens.max()))
    for level in range(1, 18):
        compare_hc(pool, f"K6 HC edge blocks, level {level}", edge, elens,
                   ecap, level)
    coll, clens = layout.to_device_layout(testing.hc_collision_blocks(rng),
                                          device=dev)
    ccap = max_compressed_length(int(clens.max()))
    for level in range(1, 18):
        compare_hc(pool, f"K6 HC collision blocks, level {level}", coll,
                   clens, ccap, level)
    n_tight = 0
    for level in (1, HC_LEVEL):
        out_lens = hc.compress_hc_batch(edge, elens, ecap, level)[1]
        for i in (2, 5, 9, 12, 20):
            n = int(out_lens[i])
            for c in (n - 1, n, n + 1):
                compare_hc(pool, f"K6 cap {c}, level {level}", edge, elens,
                           c, level)
                n_tight += 1
    log(f"K6 == plain on {src.shape[0]} edge blocks at levels {HC_LEVELS} "
        f"(and with row tails of {GUARD_BYTE:#x}), on {edge.shape[0]} HC "
        f"edge blocks and {coll.shape[0]} collision blocks at levels 1-17, "
        f"and at {n_tight} tight caps")


def _hc_timings(src, lens, kinds) -> dict:
    """K6 at levels 1, 9 and 17 on all rows, at level 9 on the a4, text
    and random rows apart and on ``A4_ROWS`` a4 rows, and the chain floor:
    ``HC_FLOOR_ROWS`` a4 rows at level 9 each alone (one team); a batch
    cannot finish before its slowest row. Returns ms by name."""
    cap = max_compressed_length(BLOCK_LEN)
    ms = {}
    for level in HC_LEVELS:
        ms[f"level {level}"] = testing.cuda_ms(
            lambda: hc.compress_hc_batch(src, lens, cap, level), HC_REPS)
    for k, name in enumerate(KIND_NAMES):
        idx = torch.nonzero(kinds == k).flatten()
        s, sl = src[idx].contiguous(), lens[idx].contiguous()
        ms[f"level 9 {name}"] = testing.cuda_ms(
            lambda: hc.compress_hc_batch(s, sl, cap, HC_LEVEL), HC_REPS)
    a4 = torch.nonzero(kinds == 0).flatten()
    for rows in A4_ROWS:
        pick = a4.repeat(-(-rows // a4.numel()))[:rows]
        s, sl = src[pick].contiguous(), lens[pick].contiguous()
        ms[f"level 9 {rows} a4 rows"] = testing.cuda_ms(
            lambda: hc.compress_hc_batch(s, sl, cap, HC_LEVEL), HC_REPS)
    alone = []
    for i in a4[:HC_FLOOR_ROWS].tolist():
        s, sl = src[i:i + 1].contiguous(), lens[i:i + 1].contiguous()
        alone.append(testing.cuda_ms(
            lambda: hc.compress_hc_batch(s, sl, cap, HC_LEVEL), 1))
    ms["a4 rows alone"] = alone
    ms["chain floor"] = max(alone)
    log(f"K6 ms on the card: {json.dumps(ms)}")
    return ms


def _host_frame(raws: list[bytes], comps: list[bytes], dev) -> bytes:
    """A frame of independent 64 KiB blocks with the content checksum,
    put together on the host from the blocks' compressed forms."""
    parts = [frame_header(BLOCK_LEN, True)]
    for raw, comp in zip(raws, comps):
        if len(comp) >= len(raw):
            parts += [struct.pack("<I", len(raw) | INCOMPRESSIBLE_MASK), raw]
        else:
            parts += [struct.pack("<I", len(comp)), comp]
    raw = b"".join(raws)
    parts.append(struct.pack("<II", 0, _one_shot(raw, 32, 0, dev)))
    return b"".join(parts)


def _hc_stream(dev, main, k6_blocks) -> dict:
    """``compress_stream(level=9)`` on the first ``CLI_BYTES`` of the main
    path's data in batches of ``STREAM_BATCH``, twice, and the command
    line's ``compress -l 9`` in this process and in a subprocess, launch
    counts reset before and read after each call: K6, never K2; the frame
    equal to the one put together on the host from K6's blocks, decoded
    by both engines. Returns host walls and launches by call."""
    raw = main["data"].tobytes()[:CLI_BYTES]
    nblk = CLI_BYTES // BLOCK_LEN
    want = _host_frame([raw[i:i + BLOCK_LEN]
                        for i in range(0, CLI_BYTES, BLOCK_LEN)],
                       k6_blocks[:nblk], dev)
    out = {}

    def checked(what, fn):
        build.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        dt = time.perf_counter() - t0
        counts = build.launch_counts()
        if counts["lz4_compress"] or min(counts[k] for k in HC_PATH) < 1:
            fail(f"{what}: launches {counts}: K2 run, or a kernel of "
                 f"{HC_PATH} not")
        if got != want:
            fail(f"{what}: the frame differs from the host's")
        out[what] = {"wall_ms": round(dt * 1e3, 1),
                     "MB/s": round(len(raw) / dt / 1e6, 2),
                     "lz4_hc": counts["lz4_hc"]}
        return counts

    for rnd in (1, 2):
        def run():
            sink = io.BytesIO()
            compress_stream(io.BytesIO(raw), sink, level=HC_LEVEL,
                            batch_blocks=STREAM_BATCH)
            return sink.getvalue()
        counts = checked(f"compress_stream(level=9) #{rnd}", run)
    for engine in ("cuda", "segment"):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(want), back, engine=engine)
        if back.getvalue() != raw:
            fail(f"HC frame: decompress_stream({engine}) did not restore it")
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        src, dst = pathlib.Path(tmp) / "in.bin", pathlib.Path(tmp) / "hc.lz4"
        src.write_bytes(raw)

        def cli_in_process():
            with contextlib.redirect_stdout(io.StringIO()):
                if cli_main(["compress", str(src), str(dst), "-l", "9"]):
                    fail("main(['compress', '-l', '9']) failed")
            return dst.read_bytes()
        checked("main(['compress', '-l', '9'])", cli_in_process)
        dst.unlink()
        t0 = time.perf_counter()
        log(_cli("compress", str(src), str(dst), "-l", "9").strip())
        out["python -m lz4_tpu_torch compress -l 9"] = {
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 1)}
        if dst.read_bytes() != want:
            fail("python -m lz4_tpu_torch compress -l 9: the frame differs "
                 "from the host's")
    log(f"HC stream ({CLI_BYTES >> 20} MiB, {nblk} blocks in batches of "
        f"{STREAM_BATCH}): {json.dumps(out)}; frame {len(want)} B, equal to "
        f"the host's from K6's blocks, restored by both engines; launches "
        f"of the last stream call {counts}")
    return out


def phase_hc(dev, main) -> list[dict]:
    """K6: edge cases, the main path's rows against the plain version, the
    tier's ``high_compressor(9)`` on all 4096 rows twice (every block
    decoded back by K1), timings, and the stream and command line at
    level 9. Returns K6's row."""
    workers = min(HC_WORKERS, max(1, (os.cpu_count() or 2) - 1))
    with PlainPool(workers) as pool:
        _hc_edge_cases(dev, pool)
        data = main["data"]
        n = data.shape[0]
        src, lens = sharded.upload_blocks(data, dev)
        kinds = torch.from_numpy(sharded.block_kinds(n, SEED)).to(dev)
        cap = max_compressed_length(BLOCK_LEN)
        plain_s = {}
        for level, per_kind in HC_PLAIN_ROWS.items():
            rows = torch.cat([torch.nonzero(kinds == k).flatten()[:per_kind]
                              for k in range(3)])
            plain_s[level] = compare_hc(
                pool, f"K6 main path, level {level}", src, lens, cap, level,
                rows)
            log(f"K6 == plain on {rows.numel()} main-path rows at level "
                f"{level} ({per_kind} of each kind; the plain version "
                f"{plain_s[level]:.1f} s in all)")

    blocks = [r.tobytes() for r in data]
    lz4 = Lz4Factory.cuda_instance(dev)
    build.reset_launch_counts()
    walls = []
    for _ in range(2):
        sync()
        t0 = time.perf_counter()
        comp = lz4.high_compressor(HC_LEVEL).compress_batch(blocks)
        walls.append(round((time.perf_counter() - t0) * 1e3, 1))
    tier_launches = build.launch_counts()
    if tier_launches["lz4_hc"] != 2 or tier_launches["lz4_compress"]:
        fail(f"tier HC: launches {tier_launches}")
    kern = hc.compress_hc_batch(src, lens, cap, HC_LEVEL)
    if comp != layout.from_device_layout(kern[0], kern[1]):
        fail("tier high_compressor(9) differs from K6 on the same rows")
    out, _, err = codec.decompress_safe_batch(kern[0], kern[1], BLOCK_LEN)
    if bool(err.any()) or not torch.equal(out[:, :BLOCK_LEN],
                                          src[:, :BLOCK_LEN]):
        fail("K6 main path: a block did not decode back to its input")
    k2_lens = main["comp_lens"]
    sizes = {name: (int(kern[1][kinds == k].sum()),
                    int(k2_lens[kinds == k].sum()))
             for k, name in enumerate(KIND_NAMES)}
    log(f"tier high_compressor(9).compress_batch of {n} x {BLOCK_LEN} B: "
        f"host walls {walls} ms; every block decoded by K1 to its input; "
        f"compressed bytes (K6 level 9, K2) by kind: {sizes}")

    smem_row = _smem_hc_row(src, kern)
    ms = _hc_timings(src, lens, kinds)
    stream = _hc_stream(dev, main, layout.from_device_layout(kern[0],
                                                             kern[1]))
    launches = {"lz4_hc": tier_launches["lz4_hc"] + sum(
        v.get("lz4_hc", 0) for v in stream.values())}
    in_bytes = int(lens.sum())
    comp_bytes = int(kern[1].sum())
    row = kernel_row("lz4_hc", launches, 0, ms["level 9"],
                     plain_s[HC_LEVEL] * 1e3, in_bytes + comp_bytes + 12 * n,
                     in_bytes, plain_rows=3 * HC_PLAIN_ROWS[HC_LEVEL])
    row.update({"level": HC_LEVEL, "ms_by_level": {
        lv: ms[f"level {lv}"] for lv in HC_LEVELS},
        "chain_floor_ms": ms["chain floor"], "tier_walls_ms": walls,
        "stream": stream})
    return [row, smem_row]


def _smem_hc_row(src, kern) -> dict:
    """K1 on the LZ4 rows (those K6 shrinks) of the first 512 main-path
    rows at HC level 9, a read batch of the ``block64k_hc9`` cell: the
    wrapper takes the CTA-a-row kernel (one launch), every row decodes to
    its input, eight rows equal the plain version's; the kernel timed
    beside the warp-a-row kernel on the same rows. Returns its row of the
    ``kernels`` line."""
    idx = torch.arange(512, device=src.device)
    keep = idx[(kern[2][:512] == 0) & (kern[1][:512] < BLOCK_LEN)]
    c, cl = kern[0][keep].contiguous(), kern[1][keep].contiguous()
    n = c.shape[0]
    before = build.launch_counts()
    got = codec.decompress_safe_batch(c, cl, BLOCK_LEN)
    ran = {k: v - before[k] for k, v in build.launch_counts().items()
           if v != before[k]}
    if ran != {"lz4_decode_smem": 1} or bool(got[2].any()) or not \
            torch.equal(got[0][:, :BLOCK_LEN], src[keep][:, :BLOCK_LEN]):
        fail(f"K1 on {n} HC-9 rows: launches {ran}, or a row did not decode "
             "to its input")
    sub = slice(0, n, n // 8)
    plain, plain_ms = _time_plain(lambda: codec.decompress_safe_plain(
        c[sub].contiguous(), cl[sub].contiguous(), BLOCK_LEN))
    err = compare_codec(f"K1 a CTA a row, {n} HC-9 rows",
                        tuple(t[sub] for t in got), plain, BLOCK_LEN)
    ms = testing.cuda_ms(
        lambda: codec.decompress_safe_batch(c, cl, BLOCK_LEN), TIMED_REPS)
    out, ol, e = (torch.empty_like(t) for t in got)
    warp_ms = testing.cuda_ms(lambda: codec.DECODE(
        c.data_ptr(), c.stride(0), cl.data_ptr(), out.data_ptr(),
        out.stride(0), BLOCK_LEN, ol.data_ptr(), e.data_ptr(), n,
        torch.cuda.current_stream().cuda_stream, device=c.device.index),
        TIMED_REPS)
    if not (torch.equal(out[:, :BLOCK_LEN], got[0][:, :BLOCK_LEN])
            and torch.equal(e, got[2])):
        fail(f"K1 on {n} HC-9 rows: the warp kernel differs")
    comp_bytes, in_bytes = int(cl.sum()), n * BLOCK_LEN
    row = kernel_row("lz4_decode_smem", {"lz4_decode_smem": 1}, err, ms,
                     plain_ms, comp_bytes + in_bytes + 12 * n, in_bytes,
                     plain_rows=len(range(n)[sub]), rows=n)
    row["warp_kernel_ms"] = warp_ms
    log(f"K1 on {n} HC-9 rows: a CTA a row {ms:.3f} ms, a warp a row "
        f"{warp_ms:.3f} ms")
    return row


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
    one_row = {}
    for name, bits, fn in (("xxh32", 32, xxhash.xxh32_batch),
                           ("xxh64", 64, xxhash.xxh64_batch)):
        ms = testing.cuda_ms(lambda: fn(flat, n1, 0), TIMED_REPS)
        bound = (len(raw) + 16) / HBM_BYTES_PER_S * 1e3
        chain = _chain_bound(dev, bits, {"name": f"{name} n=1", "ms": ms},
                             len(raw) * 2 // bits)
        log(f"{name} with n=1 over {len(raw)} B: {ms:.3f} ms "
            f"({len(raw) / ms / 1e6:.2f} GB/s) against the byte bound "
            f"{bound:.4f} ms and the chain bound "
            f"{chain['chain_bound_ms']:.3f} ms "
            f"({ms / chain['chain_bound_ms']:.3f}x)")
        one_row[name] = {"n1_bytes": len(raw), "n1_ms": ms,
                         "n1_bound_ms": bound,
                         "n1_chain_bound_ms": chain["chain_bound_ms"]}
    log(f"compress_frame_packed: {len(raw)} B -> {len(frame)} B in "
        f"{wall:.1f} ms host wall ({len(blocks)} blocks, {sum(kinds)} raw); "
        f"decoded through K1 and re-hashed on the host: OK; launches {counts}")
    return one_row


def _format_data():
    """64 MiB of ``make_blocks`` data, the kinds of its blocks, and a 64 KiB
    dictionary: a text block of the same draw (its vocabulary), taken out
    of the data."""
    blocks = sharded.make_blocks(FORMAT_BLOCKS + 1, BLOCK_LEN, SEED + 3)
    kinds = sharded.block_kinds(FORMAT_BLOCKS + 1, SEED + 3)
    t = int(np.flatnonzero(kinds == 1)[0])
    return (np.delete(blocks, t, axis=0), np.delete(kinds, t),
            blocks[t].tobytes())


def _time_alone(kernel, *args) -> float:
    """Milliseconds per launch of ``kernel``'s C entry point on card 0 with
    ``args`` (CUDA events), without its wrapper's checks and with no
    launch counted."""
    fn = build.c_function(kernel.source, kernel.symbol, kernel.argtypes)

    def launch():
        if fn(*args):
            fail(f"{kernel.symbol}: CUDA error")

    return testing.cuda_ms(launch, TIMED_REPS)


def _card_frame(raw: bytes, bs: int, comps, dev, independent: bool):
    """A frame of ``raw``'s blocks of ``bs`` bytes stored as ``comps``
    (raw where not shorter), with block and content checksums from K3 (the
    host hash takes seconds on 64 MiB)."""
    raws = [raw[i:i + bs] for i in range(0, len(raw), bs)]
    pays = testing.payloads(raws, comps)
    rows, lens = layout.to_device_layout(pays, device=dev)
    sums = xxhash.xxh32_batch(rows, lens, 0).tolist()
    flat = layout.upload_bytes(raw, dev).view(1, -1)
    content = int(xxhash.xxh32_batch(
        flat, torch.tensor([len(raw)], dtype=torch.int32, device=dev), 0)[0])
    bd = {b.num_bytes: b.value for b in BlockSize}[bs]
    return testing.build_frame(raws, comps, bd, independent=independent,
                               sums=sums, content_sum=content), content


def phase_formats(dev, card: str = "") -> tuple[list[dict], dict]:
    """The container formats on 64 MiB (``_format_data``): dictionary
    frames, linked frames at 64 KiB and 4 MiB blocks, LZ4Block streams and
    the CLI's ``-D``, each call with launch counts reset just before and
    read just after and its host wall; then K2 and K1 with the dictionary
    against their plain versions on rows of the batch, and timed. Returns
    the two kernels' rows and each kernel's launches over the calls.
    ``card`` (the card's name and power limit) goes beside the linked
    decode's timings."""
    data, kinds, dictionary = _format_data()
    raw = data.tobytes()
    n = data.shape[0]
    walls, counts, total = {}, {}, {}

    def call(what, fn):
        build.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        walls[what] = (time.perf_counter() - t0) * 1e3
        counts[what] = {k: v for k, v in build.launch_counts().items() if v}
        for k, v in counts[what].items():
            total[k] = total.get(k, 0) + v
        log(f"  {what}: {walls[what]:.1f} ms host wall, launches "
            f"{counts[what]}")
        return out

    def expect(what, name, want):
        got = counts[what].get(name, 0)
        if got != want:
            fail(f"{what}: {got} launches of {name}, expected {want}")

    flat = layout.upload_bytes(raw, dev).view(1, -1)
    content = int(xxhash.xxh32_batch(
        flat, torch.tensor([len(raw)], dtype=torch.int32, device=dev), 0)[0])
    del flat

    # dictionary frames: one K2-dict launch for the batch, K2 again on the
    # rows it did not shrink, one K3 for the block checksums; the decode one
    # K1-hist launch for the batch, the serial reader one a block
    feats = (FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.CONTENT_CHECKSUM,
             FrameFlag.BLOCK_CHECKSUM)
    fr = call("compress_frame(dictionary)", lambda: formats.compress_frame(
        raw, BlockSize.SIZE_64KB, feats, dictionary=dictionary,
        dict_id=DICT_ID, device=dev))
    expect("compress_frame(dictionary)", "lz4_compress_dict", 1)
    if fr[4] != 0x75 or struct.unpack_from("<I", fr, 6)[0] != DICT_ID or \
            struct.unpack_from("<I", fr, len(fr) - 4)[0] != content:
        fail("dictionary frame: flags, DictID or content checksum wrong")
    back = call("decompress_frame(dictionary)", lambda: formats.decompress_frame(
        fr, dictionary=dictionary, device=dev))
    expect("decompress_frame(dictionary)", "lz4_decode_hist", 1)
    if back != raw:
        fail("dictionary frame: decoded content differs")
    reader = formats.Lz4FrameInputStream(io.BytesIO(fr), dictionary=dictionary,
                                         device=dev)
    back = call("Lz4FrameInputStream(dictionary)", reader.read)
    n_comp = counts["Lz4FrameInputStream(dictionary)"].get("lz4_decode_hist", 0)
    if back != raw or reader.dict_id != DICT_ID or not n_comp:
        fail("dictionary frame: the serial reader differs")
    plain_frame = call("compress_frame", lambda: formats.compress_frame(
        raw, BlockSize.SIZE_64KB, feats, device=dev))
    log(f"dictionary frame: {len(raw)} B -> {len(fr)} B ({len(plain_frame)} "
        f"B without the dictionary); {n_comp} blocks decoded by the serial "
        f"reader, one K1-hist launch each")

    # linked frames (lz4 -BD): each block compressed against the content
    # before it (one K2-dict launch); decoded in one batch (one walk, one
    # resolve, one K3 for the block checksums, one content-hash update),
    # twice, and held against the serial reader (one K1-hist launch a
    # compressed block) and the input
    linked = {}
    for bs in (BLOCK_LEN, LINKED_BIG):
        comps = call(f"linked_blocks({bs})",
                     lambda: testing.linked_blocks(raw, bs, dev))
        expect(f"linked_blocks({bs})", "lz4_compress_dict", 1)
        lfr, _ = _card_frame(raw, bs, comps, dev, independent=False)
        n_comp = sum(len(c) < bs for c in comps)
        for rnd in (1, 2):
            what = f"decompress_frame(linked, {bs}) #{rnd}"
            back = call(what, lambda: formats.decompress_frame(
                lfr, allow_dependent_blocks=True, device=dev))
            for name in LINKED_PATH:
                expect(what, name, 1)
            expect(what, "lz4_decode_hist", 0)
            if back != raw:
                fail(f"linked frame at {bs}: decoded content differs")
        # the device memory of a batch: its peak and what it leaves held
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        formats.decompress_frame(lfr, allow_dependent_blocks=True, device=dev)
        sync()
        mem = {"peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
               "held_gib": (torch.cuda.memory_allocated() - base) / 2 ** 30}
        what = f"Lz4FrameInputStream(linked, {bs})"
        reader = formats.Lz4FrameInputStream(
            io.BytesIO(lfr), allow_dependent_blocks=True, device=dev)
        if call(what, reader.read) != raw:
            fail(f"linked frame at {bs}: the serial reader differs")
        expect(what, "lz4_decode_hist", n_comp)
        linked[bs] = {"frame": lfr, "comps": comps, "frame_bytes": len(lfr),
                      "compressed_blocks": n_comp, **mem}
        log(f"linked frame at {bs} B blocks: {len(raw)} B -> {len(lfr)} B, "
            f"{n_comp} of {len(comps)} blocks compressed; decoded in one "
            f"batch (one walk, one resolve), equal to the serial reader's "
            f"{n_comp} K1-hist launches; device memory of the batch "
            f"{json.dumps(mem)}")
    # decompress_stream's batches of 256 blocks: 4 at 64 KiB, 1 at 4 MiB
    for bs, batches in ((BLOCK_LEN, FORMAT_BLOCKS // STREAM_BATCH),
                        (LINKED_BIG, 1)):
        out = io.BytesIO()
        what = f"decompress_stream(allow_dependent, {bs})"
        call(what, lambda: decompress_stream(
            io.BytesIO(linked[bs]["frame"]), out, batch_blocks=STREAM_BATCH,
            allow_dependent=True, device=dev))
        for name in ("linked_walk", "linked_resolve"):
            expect(what, name, batches)
        expect(what, "lz4_decode_hist", 0)
        if out.getvalue() != raw:
            fail(f"{what}: content differs")
    lfr = linked[LINKED_BIG]["frame"]

    # LZ4Block streams: K2, K3 and the pack once to write; the index, the
    # decode, K3 and the verdict once to read, K1-fast never
    blob = call("compress_block_stream", lambda: formats.compress_block_stream(
        raw, BLOCK_LEN, device=dev))
    for name in ("lz4_compress", "xxh32", "lz4block_pack"):
        expect("compress_block_stream", name, 1)
    back = call("decompress_block_stream",
                lambda: formats.decompress_block_stream(blob, device=dev))
    for name in ("lz4block_index", "lz4block_decode", "xxh32",
                 "lz4block_verdict"):
        expect("decompress_block_stream", name, 1)
    expect("decompress_block_stream", "lz4_decode_fast", 0)
    if back != raw:
        fail("block stream: decoded content differs")
    head = raw[:4 * BLOCK_LEN]
    out = io.BytesIO()
    writer = formats.Lz4BlockOutputStream(out, device=dev)
    writer.write(head)
    writer.finish()
    if out.getvalue() != formats.compress_block_stream(head, device=dev) or \
            formats.Lz4BlockInputStream(io.BytesIO(out.getvalue()),
                                        device=dev).read() != head:
        fail("block stream: the stream classes differ from the one-shot")

    # the command line: -D both ways, --allow-dependent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "in.bin").write_bytes(raw[:16 << 20])
        (tmp / "dict.bin").write_bytes(dictionary)
        (tmp / "linked.lz4").write_bytes(lfr)
        with contextlib.redirect_stdout(io.StringIO()):
            rcs = [call("cli compress -D", lambda: cli_main(
                       ["compress", "-D", str(tmp / "dict.bin"), "--dict-id",
                        "7", str(tmp / "in.bin"), str(tmp / "d.lz4")])),
                   call("cli decompress -D", lambda: cli_main(
                       ["decompress", "-D", str(tmp / "dict.bin"),
                        str(tmp / "d.lz4"), str(tmp / "back.bin")])),
                   call("cli decompress --allow-dependent", lambda: cli_main(
                       ["decompress", "--allow-dependent",
                        str(tmp / "linked.lz4"), str(tmp / "l.bin")]))]
        if rcs != [0, 0, 0] or \
                (tmp / "back.bin").read_bytes() != raw[:16 << 20] or \
                (tmp / "l.bin").read_bytes() != raw:
            fail(f"cli -D / --allow-dependent: {rcs}")
        for name in ("linked_walk", "linked_resolve"):
            expect("cli decompress --allow-dependent", name, 1)

    # the kernels against their plain versions on rows of the batch, timed
    src, lens = sharded.upload_blocks(data, dev)
    win, wlen = cuda_instances.window_tensor(dictionary, dev)
    wl = torch.full((n,), wlen, dtype=torch.int32, device=dev)
    cap = max_compressed_length(BLOCK_LEN)
    sub = slice(None, None, n // FORMAT_PLAIN_ROWS)
    kern = codec.compress_dict_batch(src, lens, cap, win, wl)
    plain, plain_ms = _time_plain(lambda: codec.compress_dict_plain(
        src[sub].contiguous(), lens[sub].contiguous(), cap, win,
        wl[sub].contiguous()))
    err = compare_codec("K2 dict, the formats batch",
                        tuple(t[sub] for t in kern), plain, cap)
    ms = testing.cuda_ms(
        lambda: codec.compress_dict_batch(src, lens, cap, win, wl), TIMED_REPS)
    in_bytes, comp_bytes = int(lens.sum()), int(kern[1].sum())
    rows = [kernel_row("lz4_compress_dict", total, err, ms, plain_ms,
                       in_bytes + wlen + comp_bytes + 16 * n, in_bytes,
                       plain_rows=FORMAT_PLAIN_ROWS, rows=n)]
    out = torch.zeros_like(kern[0])
    scratch = torch.empty((2, n), dtype=torch.int32, device=dev)
    seed = torch.empty((codec.SEED_WORDS,), dtype=torch.int32, device=dev)
    for key, seed_len in (("alone_ms", wlen), ("seeded_by_each_cta_ms", -1)):
        rows[-1][key] = _time_alone(
            codec.COMPRESS_DICT, src.data_ptr(), src.stride(0),
            lens.data_ptr(), win.data_ptr() + win.shape[1], 0, wl.data_ptr(),
            out.data_ptr(), out.stride(0), cap, scratch[0].data_ptr(),
            scratch[1].data_ptr(), n, seed.data_ptr(), seed_len,
            layout.cuda_stream(src))
        if not torch.equal(out[:, :cap], kern[0][:, :cap]):
            fail(f"K2 dict ({key}): differs from the wrapper's launch")
    rows[-1].update(_dict_linked_rows(dev, raw, src, lens, cap))
    comp, clens = kern[0], kern[1]
    kern = codec.decompress_safe_hist_batch(comp, clens, BLOCK_LEN, win, wl)
    plain, plain_ms = _time_plain(lambda: codec.decompress_safe_hist_plain(
        comp[sub].contiguous(), clens[sub].contiguous(), BLOCK_LEN, win,
        wl[sub].contiguous()))
    err = compare_codec("K1 hist, the formats batch",
                        tuple(t[sub] for t in kern), plain, BLOCK_LEN,
                        all_lens=False)
    if not torch.equal(kern[0][:, :BLOCK_LEN], src[:, :BLOCK_LEN]):
        fail("K1 hist: the formats batch did not decode to its input")
    ms = testing.cuda_ms(lambda: codec.decompress_safe_hist_batch(
        comp, clens, BLOCK_LEN, win, wl), TIMED_REPS)
    rows.append(kernel_row("lz4_decode_hist", total, err, ms, plain_ms,
                           comp_bytes + wlen + in_bytes + 16 * n, in_bytes,
                           plain_rows=FORMAT_PLAIN_ROWS, rows=n))
    out = torch.empty((n, layout.row_stride(BLOCK_LEN)), dtype=torch.uint8,
                      device=dev)
    rows[-1]["alone_ms"] = _time_alone(
        codec.DECODE_HIST, comp.data_ptr(), comp.stride(0), clens.data_ptr(),
        out.data_ptr(), out.stride(0), BLOCK_LEN,
        win.data_ptr() + win.shape[1], 0, wl.data_ptr(),
        scratch[0].data_ptr(), scratch[1].data_ptr(), n,
        layout.cuda_stream(comp))
    log(f"alone (the C entry point, no wrapper; {card}), ms: K2 dict "
        f"{rows[0]['alone_ms']:.3f} (seeded by each CTA, the first design: "
        f"{rows[0]['seeded_by_each_cta_ms']:.3f}), K1 hist "
        f"{rows[1]['alone_ms']:.3f}")
    # the same rows without the window, for what the window costs
    c2, cl2, _ = codec.compress_fast_batch(src, lens, cap)
    bare = {"K2": testing.cuda_ms(
                lambda: codec.compress_fast_batch(src, lens, cap), TIMED_REPS),
            "K1": testing.cuda_ms(lambda: codec.decompress_safe_batch(
                c2, cl2, BLOCK_LEN), TIMED_REPS)}
    rows[0]["without_window_ms"] = bare["K2"]
    rows[1]["without_window_ms"] = bare["K1"]
    log(f"the formats batch without a window (K1 on K2's output), ms: "
        f"{bare}")
    # one block alone: what a launch of the serial decode costs
    one = {}
    for k, name in enumerate(KIND_NAMES[:2]):
        i = int(np.flatnonzero(kinds == k)[0])
        c1, l1 = comp[i:i + 1].contiguous(), clens[i:i + 1].contiguous()
        one[name] = testing.cuda_ms(lambda: codec.decompress_safe_hist_batch(
            c1, l1, BLOCK_LEN, win, wl[:1]), TIMED_REPS)
    rows[-1]["one_row_ms"] = one
    log(f"K1 hist on one row alone (CUDA events), ms: {one}")
    rows += _linked_kernels(dev, raw, linked, total, card)
    log(f"formats walls, ms ({card}): " + json.dumps(
        {k: round(v, 3) for k, v in walls.items()}))
    return rows, {"walls": walls, "counts": counts, "total": total}


def _dict_linked_rows(dev, raw: bytes, src, lens, cap) -> dict:
    """K2 with a dictionary on the formats batch's linked rows (each row's
    dictionary the 64 KiB of content before it, ``testing.linked_blocks``'
    strided view), against its plain version on ``FORMAT_PLAIN_ROWS`` rows
    and against the same rows with their dictionaries copied, and timed
    both ways."""
    n, w = src.shape[0], codec.WINDOW
    buf = torch.zeros((w + n * BLOCK_LEN,), dtype=torch.uint8, device=dev)
    buf[w:] = src[:, :BLOCK_LEN].reshape(-1)
    rows = buf[w:].view(n, BLOCK_LEN)
    dicts = buf.as_strided((n, w), (BLOCK_LEN, 1))
    copies = dicts.contiguous()
    dl = torch.tensor([min(i * BLOCK_LEN, w) for i in range(n)],
                      dtype=torch.int32, device=dev)
    kern = codec.compress_dict_batch(rows, lens, cap, dicts, dl)
    two = codec.compress_dict_batch(rows, lens, cap, copies, dl)
    if not all(torch.equal(x, y) for x, y in zip(kern, two)):
        fail("K2 dict: linked rows differ from their copied dictionaries'")
    sub = slice(None, None, n // FORMAT_PLAIN_ROWS)
    plain = codec.compress_dict_plain(rows[sub].contiguous(),
                                      lens[sub].contiguous(), cap,
                                      dicts[sub], dl[sub].contiguous())
    compare_codec("K2 dict, the formats batch's linked rows",
                  tuple(t[sub] for t in kern), plain, cap)
    got = {"linked_rows_ms": testing.cuda_ms(
               lambda: codec.compress_dict_batch(rows, lens, cap, dicts, dl),
               TIMED_REPS),
           "linked_rows_copied_dicts_ms": testing.cuda_ms(
               lambda: codec.compress_dict_batch(rows, lens, cap, copies, dl),
               TIMED_REPS)}
    log(f"K2 dict on the linked rows == plain on {FORMAT_PLAIN_ROWS} rows, "
        f"== with copied dictionaries; ms: {json.dumps(got)}")
    return got


def _walks_equal(a, b) -> bool:
    """Two walks' n_seq, out_total, code, reach and every row's records."""
    if not all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])):
        return False
    used = (torch.arange(a[0].shape[2], device=a[0].device)
            < a[1].long()[:, None])
    return torch.equal(a[0][:, used], b[0][:, used])


def _linked_kernels(dev, raw: bytes, linked: dict, launches: dict,
                    card: str) -> list:
    """The linked walk and resolve on the formats path's frames (1,024
    blocks of 64 KiB, 16 of 4 MiB; one batch each), against their plain
    versions (the walk on ``LINKED_PLAIN_ROWS`` rows of the 64 KiB batch
    and on one 4 MiB row, the resolve on its first ``LINKED_PLAIN_BLOCKS``
    blocks, 4 MiB, its open nodes and list against the records'), the walk
    against its first design on every row of both batches, and timed
    through their wrappers: the walk (and its first design and every
    block cut beside it), the resolve (and its kernels' device times,
    ``torch.profiler``), the resolve's own peak memory, with its open
    nodes, list and rounds (its first design is timed by
    ``python3 design_variants.py --resolve``). Returns their
    rows of the ``kernels`` line, the 64 KiB batch's numbers as ``ms``,
    the 4 MiB batch's beside them."""
    win = torch.empty((0,), dtype=torch.uint8, device=dev)
    got = {}
    for bs in (BLOCK_LEN, LINKED_BIG):
        raws = [raw[i:i + bs] for i in range(0, len(raw), bs)]
        comps = linked[bs]["comps"]
        c, cl = layout.to_device_layout(testing.payloads(raws, comps),
                                        device=dev)
        flags = torch.tensor([len(cm) >= len(r) for r, cm in zip(raws, comps)],
                             device=dev)
        width = linked_decode.table_width(cl.tolist(), flags.tolist())
        n, cap = c.shape[0], c.shape[0] * bs
        tables, n_seq, out_total, code, reach = linked_decode.walk_linked(
            c, cl, flags, bs, width)
        block_at, _, n_ok, n_nodes = linked_decode.frame_plan(
            out_total, code, reach, 0)
        args = (c, tables, n_seq, block_at, n_ok, n_nodes, win, cap)
        out, opened = linked_decode.resolve_linked(*args)
        if int(n_ok) != n or int(n_nodes) != len(raw) or \
                out[:len(raw)].cpu().numpy().tobytes() != raw:
            fail(f"linked kernels at {bs}: the batch did not decode to its "
                 f"input")
        if int(opened[-1]):
            fail(f"linked resolve at {bs}: nodes left open")

        def peak_gib(fn):
            sync()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            fn()
            sync()
            return (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        used = torch.arange(width, device=dev) < n_seq.long()[:, None]
        seqs = int(n_seq.sum())
        lit_bytes = int(tables[2][used].long().sum())
        comp_bytes = int(cl.sum())
        host = (cl.cpu().numpy(), flags.cpu().numpy())
        walk = (tables, n_seq, out_total, code, reach)
        # the walk's other layouts: every block cut into chunks
        # (whole_below 0), the first design alone (a warp a block)
        designs = {}
        for design, whole in (("cut", 0), ("warp", 1 << 31)):
            def call():
                return linked_decode._walk_cuda(c, cl, flags, bs, width, host,
                                                linked_decode.CHUNK, whole)
            if not _walks_equal(call(), walk):
                fail(f"linked walk at {bs}: differs from its {design} design")
            designs[f"{design}_walk_ms"] = testing.cuda_ms(call, TIMED_REPS)
        walk_ms = testing.cuda_ms(lambda: linked_decode.walk_linked(
            c, cl, flags, bs, width, host), TIMED_REPS)
        lay, n_chunks, n_tab = linked_decode.chunk_layout(*host, bs)
        lay = torch.from_numpy(lay).to(dev) if n_chunks > n else None
        scratch = linked_decode.SCRATCH.take(c, n_tab * 3 * linked_decode.CHUNK
                                             + 5 * n_chunks)
        got[bs] = {
            "walk_ms": walk_ms,
            "walk_alone_ms": _time_alone(
                linked_decode.WALK, c.data_ptr(), c.stride(0), cl.data_ptr(),
                flags.data_ptr(), n, bs, tables.data_ptr(), width,
                n_seq.data_ptr(), out_total.data_ptr(), code.data_ptr(),
                reach.data_ptr(), None if lay is None else lay.data_ptr(),
                n_chunks, n_tab, linked_decode.CHUNK, scratch.data_ptr(),
                layout.cuda_stream(c)),
            **designs,
            "walk_scratch_gib": linked_decode.SCRATCH.last_nbytes / 2 ** 30,
            "chunks": n_chunks,
            "resolve_ms": testing.cuda_ms(
                lambda: linked_decode.resolve_linked(*args), TIMED_REPS),
            # its kernels' device times (us a call; empty where the trace
            # has none)
            "resolve_kernels_us": testing.kernel_us(
                lambda: linked_decode.resolve_linked(*args)),
            "resolve_peak_gib": peak_gib(
                lambda: linked_decode.resolve_linked(*args)),
            **dict(zip(("open_after_pass", "list", "rounds"),
                       opened.tolist()[:3])),
            "list_room": -(-cap // linked_decode.LIST_SHARE),
            "sequences": seqs, "table_width": width,
            # the payloads, their lengths and flags in; 24 B of table a
            # sequence and 16 B a block out
            "walk_bytes": comp_bytes + 5 * n + 24 * seqs + 16 * n,
            # the tables and literals in, the output out
            "resolve_bytes": 24 * seqs + 8 * n + lit_bytes + len(raw)}
        if bs != BLOCK_LEN:
            # the plain walk on the 4 MiB batch's first compressed row
            i = int(torch.nonzero(~flags)[0])
            one, one_ms = _time_plain(lambda: linked_decode.walk_linked_plain(
                c[i:i + 1].contiguous(), cl[i:i + 1].contiguous(),
                flags[i:i + 1].contiguous(), bs, width))
            if not _walks_equal(one, tuple(t[:, i:i + 1] if t.dim() == 3
                                           else t[i:i + 1] for t in walk)):
                fail("linked walk: a 4 MiB row differs from the plain version")
            got[bs]["plain_row_ms"] = one_ms
            continue
        # the plain walk on rows spread over the batch
        idx = torch.arange(0, n, n // LINKED_PLAIN_ROWS, device=dev)
        cs_, cls_, fs_ = c[idx].contiguous(), cl[idx].contiguous(), flags[idx]
        plain, walk_plain_ms = _time_plain(
            lambda: linked_decode.walk_linked_plain(cs_, cls_, fs_, bs, width))
        for a, b in zip(plain[1:], (n_seq[idx], out_total[idx], code[idx],
                                    reach[idx])):
            if not torch.equal(a, b):
                fail("linked walk: differs from the plain version")
        for j, k in enumerate(plain[1].tolist()):
            if not torch.equal(plain[0][:, j, :k], tables[:, idx[j], :k]):
                fail(f"linked walk: row {int(idx[j])}'s records differ")
        # the plain resolve on the batch of the first blocks
        k = LINKED_PLAIN_BLOCKS
        ck, clk, fk = c[:k].contiguous(), cl[:k].contiguous(), flags[:k]
        wk = linked_decode.walk_linked(ck, clk, fk, bs, width)
        plan = linked_decode.frame_plan(wk[2], wk[3], wk[4], 0)
        args = (ck, wk[0], wk[1], plan[0], plan[2], plan[3], win, k * bs)
        kern, kopen = linked_decode.resolve_linked(*args)
        (want, _), resolve_plain_ms = _time_plain(
            lambda: linked_decode.resolve_linked_plain(*args))
        m = int(plan[3])
        resolve_err = int((kern[:m].int() - want[:m].int()).abs().max())
        if resolve_err or kern[:m].cpu().numpy().tobytes() != raw[:m]:
            fail("linked resolve: differs from the plain version")
        leaves, listed = testing.resolve_sets(
            wk[0], wk[1], plan[0], plan[2], 0, m, linked_decode.SEGMENT)
        if kopen.tolist()[:2] != [int(leaves.sum()), int(listed.sum())]:
            fail(f"linked resolve: open nodes and list {kopen.tolist()[:2]}"
                 f", the records say {int(leaves.sum())}, "
                 f"{int(listed.sum())}")
    small, big = got[BLOCK_LEN], got[LINKED_BIG]
    rows = [kernel_row("linked_walk", launches, 0, small["walk_ms"],
                       walk_plain_ms, small["walk_bytes"], len(raw),
                       plain_rows=LINKED_PLAIN_ROWS, rows=FORMAT_BLOCKS),
            kernel_row("linked_resolve", launches, resolve_err,
                       small["resolve_ms"], resolve_plain_ms,
                       small["resolve_bytes"], len(raw),
                       plain_rows=LINKED_PLAIN_BLOCKS, rows=FORMAT_BLOCKS)]
    for row, key in zip(rows, ("walk", "resolve")):
        row["at_4mib_blocks"] = {
            "ms": big[f"{key}_ms"],
            "bound_ms": big[f"{key}_bytes"] / HBM_BYTES_PER_S * 1e3}
    for k in ("walk_alone_ms", "cut_walk_ms", "warp_walk_ms",
              "walk_scratch_gib", "chunks"):
        rows[0][k] = small[k]
        rows[0]["at_4mib_blocks"][k] = big[k]
    rows[0]["card"] = card
    resolve_keys = ("resolve_kernels_us", "resolve_peak_gib",
                    "open_after_pass", "list", "list_room", "rounds")
    for row in rows[1:]:
        row.update({k: small[k] for k in resolve_keys})
        row["at_4mib_blocks"].update({k: big[k] for k in resolve_keys})
    for bs in (BLOCK_LEN, LINKED_BIG):
        info = dict(got[bs])
        info.update({k: linked[bs][k] for k in (
            "frame_bytes", "compressed_blocks", "peak_gib", "held_gib")})
        log(f"linked kernels at {bs} B blocks, one batch of "
            f"{len(raw) >> 20} MiB (ms, CUDA events; {card}): "
            f"{json.dumps(info)}")
    log(f"linked walk == plain on {LINKED_PLAIN_ROWS} rows "
        f"({walk_plain_ms:.1f} ms) and on a {LINKED_BIG >> 10} KiB row "
        f"({big['plain_row_ms']:.1f} ms), == its warp design and every "
        f"block cut on all {FORMAT_BLOCKS} + {len(raw) // LINKED_BIG} rows; linked "
        f"resolve == plain on {LINKED_PLAIN_BLOCKS} blocks "
        f"({resolve_plain_ms:.1f} ms)")
    log(f"linked resolve ({card}), ms at 64 KiB; 4 MiB blocks: "
        f"{small['resolve_ms']:.3f}; {big['resolve_ms']:.3f} (5 kernels, us "
        f"a call: {small['resolve_kernels_us']}; "
        f"{big['resolve_kernels_us']}); open after the pass "
        f"{small['open_after_pass']}; {big['open_after_pass']} of "
        f"{len(raw)} bytes, listed {small['list']}; {big['list']} (room "
        f"{small['list_room']}), rounds {small['rounds']}; {big['rounds']}; "
        f"the resolve's own peak {small['resolve_peak_gib']:.3f}; "
        f"{big['resolve_peak_gib']:.3f} GiB")
    log(f"linked walk ({card}), ms: shipped {small['walk_ms']:.3f} at 64 KiB "
        f"(one chunk a block), {big['walk_ms']:.3f} at 4 MiB ("
        f"{big['chunks']} chunks); its C entry point alone "
        f"{small['walk_alone_ms']:.3f} and {big['walk_alone_ms']:.3f}; "
        f"every block cut {small['cut_walk_ms']:.3f}"
        f" and {big['cut_walk_ms']:.3f}; warp (the first design) {small['warp_walk_ms']:.3f} and "
        f"{big['warp_walk_ms']:.3f}; scratch {big['walk_scratch_gib']:.3f} "
        f"GiB at 4 MiB")
    return rows


# ---------------------------------------------------------------------------
# the parallel compressor (K7), its engine, and the gather decode (K8)
# ---------------------------------------------------------------------------

def _scratch_gib(module) -> float:
    """GiB of the scratch of a wrapper's last launch (K7's, K8's)."""
    return module.SCRATCH.last_nbytes / 2 ** 30


def compare_parallel(what, src, lens, cap) -> int:
    """K7 against its plain version: every length and every row byte,
    the rows at -1 included (their first ``cap`` bytes)."""
    out, out_lens = parallel_compress.compress_parallel_batch(src, lens, cap)
    plain, plain_lens = parallel_compress.compress_parallel_plain(src, lens,
                                                                  cap)
    sync()
    if not torch.equal(out_lens, plain_lens):
        bad = torch.nonzero(out_lens != plain_lens).flatten()[:8].tolist()
        fail(f"{what}: lengths differ at rows {bad}: kernel "
             f"{out_lens[bad].tolist()} plain {plain_lens[bad].tolist()}")
    worst = int((out.to(torch.int16) - plain.to(torch.int16)).abs().max()) \
        if out.numel() else 0
    if worst:
        fail(f"{what}: bytes differ (max abs diff {worst})")
    return worst


def compare_gather(what, comp, tables, out_len, max_depth=32) -> int:
    got = gather_decode.gather_decompress_batch(comp, *tables, out_len,
                                                max_depth)
    want = gather_decode.gather_decompress_plain(comp, *tables, out_len,
                                                 max_depth)
    sync()
    if not torch.equal(got, want):
        bad = torch.nonzero((got != want).any(1)).flatten()[:8].tolist()
        fail(f"{what}: K8 differs from its plain version at rows {bad}")
    return 0


def _parallel_edge_cases(dev, rng) -> dict:
    """K7 against its plain version on ``testing.parallel_blocks`` at the
    sizes about 0-16, 512, 2048 and 65,536, the window blocks and 256
    blocks of random kind and size (every row tail 0xA5), at tight caps
    (-1) too, on ``testing.window_rows`` (three 64 KiB windows and 17
    bytes), one byte over 4 MiB + 1 and 16 rows of 4 MiB (timed, its peak
    memory; returned); K8 on ``testing.link_tables`` and on the parser's
    sentinel tables of K2's and K7's output of edge blocks, the chain
    blocks and the null-offset block, at max_depth 0-3 and 32."""
    fuzz = [testing.block_of(rng, testing.PARALLEL_KINDS[int(k)], int(n))
            for k, n in zip(rng.integers(0, len(testing.PARALLEL_KINDS), 256),
                            rng.integers(0, 70000, 256))]
    blocks = (testing.parallel_blocks(rng) + testing.parallel_blocks(
        rng, testing.PARALLEL_BIG_SIZES) + testing.window_clamp_blocks()
        + fuzz)
    src, lens = layout.to_device_layout(blocks, device=dev)
    col = torch.arange(src.shape[1], device=dev)
    src[col >= lens[:, None]] = GUARD_BYTE
    cap = max_compressed_length(src.shape[1])
    for c in (cap, 600, 40, 0):
        compare_parallel(f"K7 edge blocks cap={c}", src, lens, c)
    out, out_lens = parallel_compress.compress_parallel_batch(src, lens, cap)
    tight = parallel_compress.compress_parallel_batch(src, lens, 40)[1]
    dec = codec.decompress_safe_batch(out, out_lens, src.shape[1])
    if layout.from_device_layout(dec[0], dec[1]) != blocks or \
            bool(dec[2].any()) or not bool((tight == -1).any()):
        fail("K7 edge blocks: K1 did not restore them, or no row was -1 "
             "at cap 40")
    k7_blocks = layout.from_device_layout(out, out_lens)
    window = k7_blocks[-len(fuzz) - 2:-len(fuzz)]
    if not len(window[1]) < len(window[0]) - 20:
        fail("K7: the repeat inside the window did not compress")
    log(f"K7 == plain on {len(blocks)} edge blocks (sizes "
        f"{testing.PARALLEL_SIZES + testing.PARALLEL_BIG_SIZES} x "
        f"{testing.PARALLEL_KINDS}, the window blocks, {len(fuzz)} of random "
        f"kind and size up to 70,000; tails 0xA5) at caps "
        f"{cap}, 600, 40, 0 ({int((tight == -1).sum())} rows -1 at 40); "
        f"K1 restores them; window blocks {len(window[0])} and "
        f"{len(window[1])} B")

    rows = testing.window_rows(rng)
    wsrc, wlens = layout.to_device_layout(rows, device=dev)
    wcap = max_compressed_length(wsrc.shape[1])
    compare_parallel("K7 window rows", wsrc, wlens, wcap)
    out, out_lens = parallel_compress.compress_parallel_batch(wsrc, wlens,
                                                              wcap)
    dec = codec.decompress_safe_batch(out, out_lens, wsrc.shape[1])
    if bool(dec[2].any()) or layout.from_device_layout(dec[0],
                                                       dec[1]) != rows:
        fail("K7 window rows: K1 did not restore them")
    one = (4 << 20) + 1
    rsrc, rlens = layout.to_device_layout([b"\x61" * one], device=dev)
    rcap = max_compressed_length(rsrc.shape[1])
    compare_parallel("K7 one byte over 4 MiB + 1", rsrc, rlens, rcap)
    run_len = parallel_compress.compress_parallel_batch(rsrc, rlens,
                                                        rcap)[1].item()
    if run_len != 1 + 1 + 2 + 1 + (one - 10 - 15) // 255 + 1 + 5:
        fail(f"K7: one byte over 4 MiB + 1 is {run_len} B, not one match "
             "sequence and the last literals")
    log(f"K7 == plain on {len(rows)} window rows (three 64 KiB windows and "
        f"17 bytes: runs of period 1-4 across every window end, a literal "
        f"run over windows, one repeated byte; rows about one and two "
        f"windows), K1 restores them; one byte over 4 MiB + 1: {run_len} B, "
        f"one match sequence")
    del wsrc, rsrc, out, dec
    for out_len in (40, 8):
        tables, comp = testing.link_tables(out_len)
        t = torch.from_numpy(tables).to(dev)
        c = torch.from_numpy(comp).to(dev)
        for depth in (0, 1, 2, 3, 32):
            compare_gather(f"K8 link tables out_len={out_len} "
                           f"max_depth={depth}", c, t, out_len, depth)
    log("K8 == plain on the link tables (chains of 2^k - 1 and 2^k links, "
        "k = 0-3, forward pointers, a cycle, a self-parent, a null offset) "
        "at out_len 40 and 8, max_depth 0-3 and 32")

    big = sharded.make_blocks(16, PARALLEL_BIG_ROW, SEED + 5)
    bsrc, blens = sharded.upload_blocks(big, dev)
    bcap = max_compressed_length(PARALLEL_BIG_ROW)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    bout, bl = parallel_compress.compress_parallel_batch(bsrc, blens, bcap)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    ms = testing.cuda_ms(lambda: parallel_compress.compress_parallel_batch(
        bsrc, blens, bcap), TIMED_REPS)
    compare_parallel("K7 16 x 4 MiB", bsrc, blens, bcap)
    dec = codec.decompress_safe_batch(bout, bl, PARALLEL_BIG_ROW)
    if bool(dec[2].any()) or not torch.equal(dec[0][:, :PARALLEL_BIG_ROW],
                                             bsrc[:, :PARALLEL_BIG_ROW]):
        fail("K7 16 x 4 MiB: K1 did not restore the rows")
    big16 = {"ms": ms, "peak_gib": peak / 2 ** 30,
             "windows_a_row": parallel_compress.windows(PARALLEL_BIG_ROW),
             "scratch_gib": _scratch_gib(parallel_compress)}
    log(f"K7 on 16 x 4 MiB == plain, restored by K1: {ms:.3f} ms "
        f"({parallel_compress.windows(PARALLEL_BIG_ROW)} windows a row, a CTA "
        f"each, {parallel_compress.resident_teams(0)} CTAs), "
        f"{int(bl.sum())} B out; peak device memory of the call "
        f"{peak / 2 ** 30:.3f} GiB above its inputs, K7's scratch "
        f"{_scratch_gib(parallel_compress):.3f} GiB")
    del bsrc, bout, dec

    raws = testing.mixed_blocks(rng, EDGE_SIZES)
    r, rl = layout.to_device_layout(raws, device=dev)
    comp, clens, _ = codec.compress_fast_batch(r, rl, max_compressed_length(
        max(EDGE_SIZES)))
    cblocks = layout.from_device_layout(comp, clens) + k7_blocks
    raws += blocks
    chains = testing.chain_blocks(rng)
    cblocks += [c for c, _ in chains] + [testing.boundary_blocks()[0]]
    raws += [d for _, d in chains] + [b"*" + bytes(4) + b"*" * 8]
    c, cl = layout.to_device_layout(cblocks, device=dev)
    compare_parse("parser sentinel tails", c, cl)
    tables, n_seq, _ = sequences.parse_sequences(c, cl, sentinel_tails=True)
    want = sequences.parse_plain(c, cl, sentinel_tails=True)
    if not torch.equal(tables, want[0].to(dev)):
        fail("parser: the sentinel tables differ from the plain version's")
    out_len = max(len(x) for x in raws)
    for depth in (0, 1, 2, 3, 32):
        compare_gather(f"K8 edge blocks max_depth={depth}", c, tables,
                       out_len, depth)
    if gather_decode.decompress_blocks(cblocks, out_len, dev) != raws:
        fail("gather_decode.decompress_blocks did not restore the edge "
             "blocks")
    log(f"parser sentinel tails == plain; K8 == plain on {len(cblocks)} "
        f"blocks (K2's and K7's edge blocks, {len(chains)} chain blocks, a "
        f"null offset) at max_depth 0, 1, 2, 3, 32; decompress_blocks "
        f"restores them")
    return big16


@contextlib.contextmanager
def _k7_timed():
    """K7's launches inside the block timed where they run: CUDA events
    around each wrapper call, on its stream; yields the list of event
    pairs, complete when the block ends."""
    events, launch = [], parallel_compress.compress_parallel_batch

    def timed_launch(*args, **kw):
        pair = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        pair[0].record()
        result = launch(*args, **kw)
        pair[1].record()
        events.append(pair)
        return result

    parallel_compress.compress_parallel_batch = timed_launch
    try:
        yield events
    finally:
        parallel_compress.compress_parallel_batch = launch
        sync()


def _k7_full_batch(dev, full: bytes, distinct: int) -> dict:
    """K7 on the full batch's 256 rows of 4 MiB directly: timed, its peak
    device memory, the 16 distinct rows (the 64 MiB repeated) against the
    plain version 4 at a time, every row equal to its first copy's (row r
    is row r % ``distinct``), all decoded back by K1."""
    src = torch.frombuffer(bytearray(full), dtype=torch.uint8).to(dev).view(
        STREAM_BATCH, PARALLEL_BIG_ROW)
    lens = torch.full((STREAM_BATCH,), PARALLEL_BIG_ROW, dtype=torch.int32,
                      device=dev)
    cap = max_compressed_length(PARALLEL_BIG_ROW)
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, out_lens = parallel_compress.compress_parallel_batch(src, lens, cap)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    ms = testing.cuda_ms(lambda: parallel_compress.compress_parallel_batch(
        src, lens, cap), TIMED_REPS)
    copies = torch.arange(STREAM_BATCH, device=dev) % distinct
    if not (torch.equal(out, out[copies]) and
            torch.equal(out_lens, out_lens[copies])):
        fail("K7 full batch: a row differs from its first copy's")
    for r in range(0, distinct, 4):
        plain = parallel_compress.compress_parallel_plain(
            src[r:r + 4], lens[r:r + 4], cap)
        if not (torch.equal(plain[1], out_lens[r:r + 4])
                and torch.equal(plain[0], out[r:r + 4])):
            fail(f"K7 full batch: rows {r}-{r + 3} differ from the plain "
                 "version")
        del plain
    dec = codec.decompress_safe_batch(out, out_lens, PARALLEL_BIG_ROW)
    if bool(dec[2].any()) or not torch.equal(dec[0][:, :PARALLEL_BIG_ROW],
                                             src):
        fail("K7 full batch: K1 did not restore the rows")
    del dec
    log(f"K7 on {STREAM_BATCH} x 4 MiB: {ms:.3f} ms; the {distinct} distinct "
        f"rows == plain, every row == its first copy, K1 restores them; "
        f"peak device memory {peak / 2 ** 30:.3f} GiB above its inputs")
    return {"ms": ms, "peak_gib": peak / 2 ** 30,
            "scratch_gib": _scratch_gib(parallel_compress),
            "distinct_rows_equal_plain": distinct}


def _parallel_stream(dev, raw: bytes, k7_blocks: list[bytes]) -> dict:
    """The ``parallel`` engine: ``compress_stream`` on 64 MiB twice (its
    frame equal to the one put together from K7's blocks), decoded by the
    ``cuda`` and ``segment`` engines; the same at 4 MiB blocks; the CLI's
    ``compress --engine parallel`` in a subprocess, restored by
    ``decompress``; each call with launch counts reset just before and read
    just after: K7 run, K2 never. Returns walls and launches by call."""
    want = _host_frame([raw[i:i + BLOCK_LEN]
                        for i in range(0, len(raw), BLOCK_LEN)],
                       k7_blocks, dev)
    out, total = {}, {}

    def call(what, fn, path, nbytes=len(raw)):
        build.reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        got = fn()
        sync()
        dt = time.perf_counter() - t0
        counts = build.launch_counts()
        missing = [k for k in path if counts.get(k, 0) < 1]
        if missing or (path == PARALLEL_PATH and counts["lz4_compress"]):
            fail(f"{what}: launches {counts}: K2 run, or {missing} not")
        out[what] = {"wall_ms": round(dt * 1e3, 1),
                     "MB/s": round(nbytes / dt / 1e6, 2),
                     "launches": {k: v for k, v in counts.items() if v}}
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        return got

    def compress(bs, data=raw):
        sink = io.BytesIO()
        compress_stream(io.BytesIO(data), sink, engine="parallel",
                        block_size=bs, batch_blocks=STREAM_BATCH)
        return sink.getvalue()

    def decompress(frame, engine):
        back = io.BytesIO()
        decompress_stream(io.BytesIO(frame), back, engine=engine)
        return back.getvalue()

    for rnd in (1, 2):
        frame = call(f"compress_stream(parallel) #{rnd}",
                     lambda: compress(BlockSize.SIZE_64KB), PARALLEL_PATH)
        if frame != want:
            fail("compress_stream(parallel): the frame differs from the one "
                 "put together from K7's blocks")
    # the stream's K7 launches (256 rows each) timed where they run: CUDA
    # events around each, on the stream it launches on
    with _k7_timed() as events:
        frame = call("compress_stream(parallel) #3, K7 timed",
                     lambda: compress(BlockSize.SIZE_64KB), PARALLEL_PATH)
    k7_ms = [a.elapsed_time(b) for a, b in events]
    if frame != want or len(k7_ms) != len(raw) // (STREAM_BATCH * BLOCK_LEN):
        fail(f"compress_stream(parallel) with K7 timed: the frame differs, "
             f"or {len(k7_ms)} launches")
    out["compress_stream(parallel) #3, K7 timed"]["k7_launch_ms"] = k7_ms
    for engine, path in (("cuda", ("lz4_decode_smem",)),
                         ("segment", ("lz4_parse", "segment_decode"))):
        if call(f"decompress_stream({engine})",
                lambda: decompress(want, engine), path) != raw:
            fail(f"decompress_stream({engine}) did not restore the "
                 "parallel frame")
    big = call("compress_stream(parallel, 4 MiB blocks)",
               lambda: compress(BlockSize.SIZE_4MB), PARALLEL_PATH)
    for engine in ("cuda", "segment"):
        if decompress(big, engine) != raw:
            fail(f"the 4 MiB parallel frame: decompress_stream({engine}) "
                 "did not restore it")
    # the device memory a full batch of 4 MiB blocks leaves allocated (K7's
    # scratch at its budget is the launch's own) and its peak
    what = "compress_stream(parallel, 4 MiB blocks, a full batch)"
    full = raw * (STREAM_BATCH * PARALLEL_BIG_ROW // len(raw))
    parallel_compress.SCRATCH.clear()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with _k7_timed() as events:
        frame = call(what, lambda: compress(BlockSize.SIZE_4MB, full),
                     PARALLEL_PATH, len(full))
    out[what].update({
        "k7_launch_ms": [a.elapsed_time(b) for a, b in events],
        "held_gib": (torch.cuda.memory_allocated() - base) / 2 ** 30,
        "peak_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30,
        "scratch_kept_gib": parallel_compress.SCRATCH.nbytes() / 2 ** 30,
        "scratch_launch_gib": _scratch_gib(parallel_compress),
        "reserved_gib": torch.cuda.memory_reserved() / 2 ** 30})
    if decompress(frame, "cuda") != full:
        fail(f"{what}: decompress_stream(cuda) did not restore it")
    del frame
    out["K7 on the full batch's 256 x 4 MiB rows"] = _k7_full_batch(
        dev, full, len(raw) // PARALLEL_BIG_ROW
        if len(raw) % PARALLEL_BIG_ROW == 0 else STREAM_BATCH)
    del full
    try:
        get_engine("parallel", 9, dev)
        fail("get_engine('parallel', 9) did not raise")
    except Lz4FrameError as e:
        log(f"get_engine('parallel', 9) raises: {e}")
    work = REPO / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        src = pathlib.Path(tmp) / "in.bin"
        dst, back = src.with_suffix(".lz4"), src.with_suffix(".back")
        src.write_bytes(raw)
        t0 = time.perf_counter()
        log(_cli("compress", str(src), str(dst), "--engine", "parallel")
            .strip())
        log(_cli("decompress", str(dst), str(back)).strip())
        out["python -m lz4_tpu_torch compress --engine parallel"] = {
            "wall_ms": round((time.perf_counter() - t0) * 1e3, 1)}
        if dst.read_bytes() != want or back.read_bytes() != raw:
            fail("the command line's parallel frame differs from the "
                 "engine's, or its round trip from the input")
    log(f"parallel engine ({len(raw) >> 20} MiB): {json.dumps(out)}; frame "
        f"{len(want)} B at 64 KiB, {len(big)} B at 4 MiB blocks, both "
        f"restored by the cuda and segment engines and the command line")
    return {"calls": out, "total": total}


def phase_parallel(dev) -> list[dict]:
    """Phase 8d: K7 and K8 on their edge cases; K7 on the main path's
    blocks (timed beside K2, the plain version on some rows, every block
    decoded back by K1, sizes by kind); the ``parallel`` engine and its
    command line; K8 on the main path's K2 output (timed beside K5 and K1,
    the plain version on some rows) and ``gather_decode.
    decompress_blocks``. Returns the rows of K7 and K8."""
    rng = np.random.default_rng(SEED + 4)
    big16 = _parallel_edge_cases(dev, rng)

    data = sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED)
    kinds = torch.from_numpy(sharded.block_kinds(N_BLOCKS, SEED)).to(dev)
    src, lens = sharded.upload_blocks(data, dev)
    n = N_BLOCKS
    cap = max_compressed_length(BLOCK_LEN)
    in_bytes = int(lens.sum())
    sub = slice(None, None, n // PARALLEL_PLAIN_ROWS)

    # the peak of a first call at this shape: its scratch (kept by the
    # wrapper, grown by the edge cases' 4 MiB rows) allocated anew
    parallel_compress.SCRATCH.clear()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    comp, comp_lens = parallel_compress.compress_parallel_batch(src, lens, cap)
    sync()
    peak = torch.cuda.max_memory_allocated() - base
    ssub, lsub = src[sub].contiguous(), lens[sub].contiguous()
    plain, plain_ms = _time_plain(
        lambda: parallel_compress.compress_parallel_plain(ssub, lsub, cap))
    if not (torch.equal(plain[1], comp_lens[sub])
            and torch.equal(plain[0], comp[sub])):
        fail("K7 main path: differs from the plain version")
    dec = codec.decompress_safe_batch(comp, comp_lens, BLOCK_LEN)
    if bool(dec[2].any()) or not torch.equal(dec[0][:, :BLOCK_LEN],
                                             src[:, :BLOCK_LEN]):
        fail("K7 main path: K1 did not decode every block to its input")
    del dec
    ms = testing.cuda_ms(lambda: parallel_compress.compress_parallel_batch(
        src, lens, cap), TIMED_REPS)
    k2 = codec.compress_fast_batch(src, lens, cap)
    k2_ms = testing.cuda_ms(
        lambda: codec.compress_fast_batch(src, lens, cap), TIMED_REPS)
    sizes = {name: (int(comp_lens[kinds == k].sum()),
                    int(k2[1][kinds == k].sum()))
             for k, name in enumerate(KIND_NAMES)}
    log(f"K7 on {n} x {BLOCK_LEN} B: {ms:.3f} ms (K2 {k2_ms:.3f} ms on the "
        f"same blocks); plain {plain_ms:.1f} ms on {ssub.shape[0]} rows, "
        f"equal; every block decoded by K1 to its input; compressed bytes "
        f"(K7, K2) by kind {sizes}; peak device memory of the call "
        f"{peak / 2 ** 30:.3f} GiB above its inputs, its scratch "
        f"{_scratch_gib(parallel_compress):.3f} GiB of it "
        f"({parallel_compress.resident_teams(0)} teams)")
    k7_blocks = layout.from_device_layout(comp[:CLI_BYTES // BLOCK_LEN],
                                          comp_lens[:CLI_BYTES // BLOCK_LEN])
    stream = _parallel_stream(dev, data.tobytes()[:CLI_BYTES], k7_blocks)
    comp_bytes = int(comp_lens.sum())
    k7 = kernel_row("parallel_compress", stream["total"], 0, ms, plain_ms,
                    in_bytes + comp_bytes + 8 * n, in_bytes,
                    plain_rows=ssub.shape[0])
    k7.update({"k2_ms": k2_ms, "16x4MiB": big16,
               "full_batch_256x4MiB": stream["calls"][
                   "K7 on the full batch's 256 x 4 MiB rows"],
               "bytes_by_kind_k7_k2": sizes,
               "peak_gib": peak / 2 ** 30, "stream": stream["calls"],
               "stream_launch_ms": stream["calls"][
                   "compress_stream(parallel) #3, K7 timed"]["k7_launch_ms"]})
    del comp, plain, ssub

    # K8 on the main path's K2 output, beside K5 and K1
    c, cl = k2[0], k2[1]
    tables, n_seq, total = sequences.parse_sequences(c, cl,
                                                     sentinel_tails=True)
    if bool((n_seq < 0).any()) or not bool((total == BLOCK_LEN).all()):
        fail("parser main path: a block was refused")
    gather_decode.SCRATCH.clear()
    sync()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = gather_decode.gather_decompress_batch(c, *tables, BLOCK_LEN)
    sync()
    k8_peak = torch.cuda.max_memory_allocated() - base
    if not torch.equal(out, src[:, :BLOCK_LEN]):
        fail("K8 main path: a block differs from the input")
    csub = c[sub].contiguous()
    tsub = tables[:, sub].contiguous()
    plain, k8_plain_ms = _time_plain(
        lambda: gather_decode.gather_decompress_plain(csub, *tsub,
                                                      BLOCK_LEN))
    if not torch.equal(plain, out[sub]):
        fail("K8 main path: differs from the plain version")
    for depth in (0, 1, 2, 3):
        compare_gather(f"K8 main path rows max_depth={depth}", csub, tsub,
                       BLOCK_LEN, depth)
    k8_ms = testing.cuda_ms(lambda: gather_decode.gather_decompress_batch(
        c, *tables, BLOCK_LEN), TIMED_REPS)
    plain_seg = sequences.parse_sequences(c, cl)
    k5_ms = testing.cuda_ms(lambda: segment_decode.decompress_segments(
        c, cl, plain_seg[1], plain_seg[0], BLOCK_LEN), TIMED_REPS)
    k1_ms = testing.cuda_ms(
        lambda: codec.decompress_safe_batch(c, cl, BLOCK_LEN), TIMED_REPS)
    del out, plain, plain_seg
    blocks = layout.from_device_layout(c, cl)
    build.reset_launch_counts()
    sync()
    t0 = time.perf_counter()
    restored = gather_decode.decompress_blocks(blocks, BLOCK_LEN, dev)
    wall = (time.perf_counter() - t0) * 1e3
    launches = build.launch_counts()
    if [k for k in GATHER_PATH if launches.get(k, 0) < 1]:
        fail(f"gather_decode.decompress_blocks: launches {launches}")
    if restored != [r.tobytes() for r in data]:
        fail("gather_decode.decompress_blocks did not restore the input")
    log(f"K8 on {n} x {BLOCK_LEN} B of K2 output: {k8_ms:.3f} ms (K5 "
        f"{k5_ms:.3f}, K1 {k1_ms:.3f} ms on the same blocks); plain "
        f"{k8_plain_ms:.1f} ms on {csub.shape[0]} rows, equal at max_depth "
        f"0, 1, 2, 3, 32; peak device memory {k8_peak / 2 ** 30:.3f} GiB above "
        f"its inputs, its scratch {_scratch_gib(gather_decode):.3f} GiB of "
        f"it; "
        f"decompress_blocks restored all {n} blocks in "
        f"{wall:.1f} ms, launches {launches}")
    # literal bytes, 24 B of table a sequence and the sentinel after it in;
    # the rows out
    lit_bytes = int(tables[2].sum())
    k8 = kernel_row("gather_decode", launches, 0, k8_ms, k8_plain_ms,
                    lit_bytes + 24 * int((n_seq + 1).sum()) + in_bytes,
                    in_bytes, plain_rows=csub.shape[0])
    k8.update({"k5_ms": k5_ms, "k1_ms": k1_ms, "peak_gib": k8_peak / 2 ** 30,
               "decompress_blocks_wall_ms": round(wall, 1)})
    return [k7, k8]


def _dist_one_rank(dev) -> dict:
    """``sharded_roundtrip_step`` on one NCCL rank, held to
    ``roundtrip_step``; returns the launches of its steps."""
    for _ in range(2):                  # the second one's times are kept
        ref = sharded.roundtrip_step(N_BLOCKS, BLOCK_LEN, SEED, dev)
    ref_body = ref.body[:ref.body_total]
    with tempfile.TemporaryDirectory() as td:
        tdist.init_process_group(
            "nccl", init_method=pathlib.Path(td, "rendezvous").as_uri(),
            world_size=1, rank=0)
        try:
            mesh = dist_mesh.block_mesh(dev)
            if mesh.backend != "nccl" or mesh.group is None:
                fail(f"dist: expected a one-rank NCCL mesh, got {mesh}")
            t0 = time.perf_counter()
            tdist.barrier(device_ids=[dev.index or 0])  # NCCL's set-up
            sync()
            log(f"dist: NCCL communicator set up in "
                f"{(time.perf_counter() - t0) * 1e3:.1f} ms (first barrier)")
            build.reset_launch_counts()
            for i in range(ITERS):
                t0 = time.perf_counter()
                st = sharded.sharded_roundtrip_step(mesh, N_BLOCKS, BLOCK_LEN,
                                                    SEED)
                sync()
                wall = (time.perf_counter() - t0) * 1e3
                if not bool(st.ok.all()):
                    fail(f"dist step {i}: {int((~st.ok).sum())} blocks not OK")
                if not (torch.equal(st.offsets, ref.offsets)
                        and torch.equal(st.hashes, ref.hashes)
                        and torch.equal(st.body, ref_body)
                        and st.compressed_total == ref.compressed_total):
                    fail(f"dist step {i}: offsets, hashes or body differ "
                         "from roundtrip_step's")
                phases = ", ".join(f"{k} {v:.3f}" for k, v in
                                   st.phase_ms.items())
                log(f"dist step {i} (1 NCCL rank, {N_BLOCKS} x {BLOCK_LEN} B):"
                    f" all OK, equal to roundtrip_step; ms: {phases}; step "
                    f"wall {wall:.1f} ms (data made and body checked on the "
                    f"host included)")
            counts = build.launch_counts()
        finally:
            tdist.destroy_process_group()
    log("dist: roundtrip_step ms: " + ", ".join(
        f"{k} {v:.3f}" for k, v in ref.phase_ms.items()))
    log(f"dist one-rank launches: {counts}")
    for k in DIST_PATH:
        if counts[k] != ITERS:
            fail(f"dist: {k} launched {counts[k]} times in {ITERS} steps")
    return {"phase_ms": st.phase_ms, "ref_phase_ms": ref.phase_ms,
            "launches": counts}


def _dist_shared(dev, n: int, data_bytes: int, blocks_per_rank: int) -> None:
    """``dryrun_multigpu(n, share_card=True)``, its frames, HC frame and
    XXH64 digests held to one process's on the same bytes."""
    t0 = time.perf_counter()
    out = dryrun_multigpu(n, "cuda", share_card=True, data_bytes=data_bytes,
                          blocks_per_rank=blocks_per_rank,
                          block_len=BLOCK_LEN, timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    data = multihost.dryrun_data(data_bytes)
    if not (out["frame"] == out["packed_frame"]
            == sharded.compress_frame_packed(data, BLOCK_LEN, True, dev)):
        fail(f"dist {n} ranks: frames differ from compress_frame_packed's")
    hc_data = data[:multihost.HC_BYTES]
    blocks = sharded.split_frame_blocks(hc_data, BLOCK_LEN)
    comps = Lz4Factory.cuda_instance(dev).high_compressor(9).compress_batch(
        blocks)
    if out["hc_frame"] != _host_frame(blocks, comps, dev):
        fail(f"dist {n} ranks: the HC frame differs from the tier's")
    frame_blocks = sharded.split_frame_blocks(data, BLOCK_LEN)
    src, src_lens = layout.to_device_layout(frame_blocks, BLOCK_LEN, dev)
    h = xxhash.xxh64_batch(src, src_lens, 0).tolist()
    if out["xxh64"] != [v & (2 ** 64 - 1) for v in h]:
        fail(f"dist {n} ranks: shard_xxh64 differs from xxh64_batch")
    one = multihost.run_job(dist_mesh.block_mesh(dev), {
        "data_bytes": 0, "step": [n * blocks_per_rank, BLOCK_LEN]})
    if out["step"] != one["step"]:
        fail(f"dist {n} ranks: the step differs from one rank's")
    ranges = [dist_mesh.block_range(len(frame_blocks), r, n)
              for r in range(n)]
    log(f"dist {n} ranks sharing the card (gloo): {len(data)} B in "
        f"{len(frame_blocks)} frame blocks, ranges {ranges}; frames, HC "
        f"frame and XXH64 equal to one process's; step "
        f"{out['step']['blocks']} blocks OK; {wall:.1f} s wall (worker "
        f"start-up included); step ms by rank {out['phase_ms']}")


def _dist_scaling(dev, card: str) -> None:
    """The two scaling modules with ranks sharing the card; every digest
    held to K2's output in this process on the same seeded rows."""
    build.build_all()
    src, lens = sharded.upload_blocks(
        multihost_scaling.scaling_blocks(SCALING_BLOCKS, BLOCK_LEN), dev)
    comp, comp_lens, err = codec.compress_fast_batch(
        src, lens, max_compressed_length(BLOCK_LEN))
    if bool(err.any()):
        fail("dist scaling: K2 failed on the scaling blocks")
    blocks = layout.from_device_layout(comp, comp_lens)
    del src, lens, comp, comp_lens, err
    whole = multihost_scaling.sha256_of(blocks)
    for n in SCALING_PROCS:
        t0 = time.perf_counter()
        out = multihost_scaling.measure(SCALING_BLOCKS, BLOCK_LEN, n,
                                        DIST_TIMEOUT, 1, share_card=True)
        wall = time.perf_counter() - t0
        share = multihost_scaling.sha256_of(blocks[:SCALING_BLOCKS // n])
        if out["sha256"] != whole or out["share_sha256"] != share:
            fail(f"dist scaling: multihost_scaling at {n} ranks compressed "
                 "other bytes than K2 in this process")
        log(f"dist scaling: multihost_scaling.measure at {n} ranks "
            f"({out['placement']}; sharing one card, not scaling across "
            f"cards), {SCALING_BLOCKS} x {BLOCK_LEN} B, 1 trial: t_multi "
            f"{out['t_multi_s']} s, t_os {out['t_os_s']} s, t_ref "
            f"{out['t_ref_s']} s; multihost_efficiency "
            f"{out['multihost_efficiency']}, os_ceiling_efficiency "
            f"{out['os_ceiling_efficiency']}, multihost_vs_os_ceiling "
            f"{out['multihost_vs_os_ceiling']}; digests of the group and of "
            f"a share equal to K2's in this process; wall {wall:.1f} s "
            f"({2 * n + 1} worker processes' start-up included); {card}")
    t0 = time.perf_counter()
    out = scaling.measure(SCALING_BLOCKS, BLOCK_LEN, SCALING_WIDTHS, 1,
                          share_card=True, timeout=DIST_TIMEOUT)
    wall = time.perf_counter() - t0
    if set(out["sha256"].values()) != {whole}:
        fail("dist scaling: scaling compressed other bytes than K2 in this "
             "process")
    shown = {k: v for k, v in out.items() if k != "sha256"}
    log(f"dist scaling: scaling.measure at widths {SCALING_WIDTHS} (sharing "
        f"one card, not scaling across cards), {SCALING_BLOCKS} x "
        f"{BLOCK_LEN} B, 1 trial: {json.dumps(shown)}; every width's digest "
        f"equal to K2's in this process; wall {wall:.1f} s "
        f"({1 + sum(SCALING_WIDTHS)} worker processes' start-up included); "
        f"{card}")


def phase_dist(dev, card: str) -> dict:
    """The ``dist`` path (phase 8b); returns its launches by kernel."""
    one = _dist_one_rank(dev)
    _dist_shared(dev, 2, 2 * DIST_SHARED_BLOCKS * BLOCK_LEN,
                 DIST_SHARED_BLOCKS)
    _dist_shared(dev, DIST_ODD[0], DIST_ODD[1], 1)
    _dist_scaling(dev, card)
    layout.cuda_stream(torch.empty(1, device=dev))
    past = torch.device("cuda", torch.cuda.device_count())
    try:
        layout.cuda_stream(past)
    except ValueError:
        log(f"dist: cuda_stream refuses {past}")
    else:
        fail(f"dist: cuda_stream accepted {past}")
    log(f"dist: {card}")
    return one["launches"]


def pack_parse_only(dev) -> None:
    """``--pack-parse``: the main path's steps, ``frame_body_packed`` and
    the parser (by kind, at a stream batch and at all rows) on the main
    path's blocks, two rounds, and each kind's sequences: how many, and
    how many are 3-byte ones (no literals, a match of 4-18 bytes). No
    kernel is checked here; the full run does that. It uses only what
    the parser and pack had before their redesign, so it also runs
    against the earlier package."""
    build.build_all()
    data = sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED)
    src, lens = sharded.upload_blocks(data, dev)
    comp, clens, _ = codec.compress_fast_batch(
        src, lens, max_compressed_length(BLOCK_LEN))
    for i in range(ITERS):
        st = sharded.roundtrip_step(N_BLOCKS, BLOCK_LEN, SEED, dev)
        log(f"step {i}: {json.dumps(st.phase_ms)}, "
            f"{sum(st.phase_ms.values()):.3f} ms in all")
        del st
    batch = slice(0, STREAM_BATCH)
    c, cl = comp[batch].contiguous(), clens[batch].contiguous()
    for _ in range(2):
        time_pack(src, lens, comp, clens)
        time_parse_by_kind(comp, clens)
        few = testing.cuda_ms(lambda: sequences.parse_sequences(c, cl),
                              TIMED_REPS)
        full = testing.cuda_ms(lambda: sequences.parse_sequences(comp, clens),
                               TIMED_REPS)
        log(f"parse through its wrapper: {STREAM_BATCH} rows {few:.4f} "
            f"ms, {N_BLOCKS} rows {full:.4f} ms")
    tables, n_seq, _ = sequences.parse_sequences(comp, clens)
    kinds = torch.from_numpy(sharded.block_kinds(N_BLOCKS, SEED)).to(dev)
    live = torch.arange(tables.shape[2], device=dev) < n_seq[:, None]
    short = live & (tables[2] == 0) & (tables[5] >= 4) & (tables[5] <= 18)
    for k, name in enumerate(KIND_NAMES):
        rows = kinds == k
        ns = n_seq[rows]
        log(f"{name}: {int(ns.min())}-{int(ns.max())} sequences a block, "
            f"{int(short[rows].sum())} of {int(ns.sum())} 3-byte")


# ---------------------------------------------------------------------------
# the host split of the stream and tier calls
# ---------------------------------------------------------------------------

SPAN = "lz4tt."                 # the prefix of the parts' spans
HOST_PARTS = ("read", "upload", "kernels", "check", "download",
              "content_hash", "write")
GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = "host_split.call"


class _Sink(io.BytesIO):
    """``dst`` of the traced stream calls: every write a ``write`` span."""

    def write(self, b):
        with torch.profiler.record_function(SPAN + "write"):
            return super().write(b)


def _patch_parts():
    """Name the parts of a batch on the timeline in a package that has no
    spans of its own (the one before ``lz4_tpu_torch.utils``), by wrapping
    the functions that do them; returns the undo. A no-op for a package
    with its own spans."""
    if importlib.util.find_spec("lz4_tpu_torch.utils") is not None:
        return lambda: None
    from lz4_tpu_torch.api import cuda_instances as ci
    from lz4_tpu_torch.streams import pipeline
    targets = [(pipeline, "_read_full", "read"),
               (ci, "to_device_layout", "upload"),
               (segment_decode, "to_device_layout", "upload"),
               (ci, "from_device_layout", "download"),
               (segment_decode, "from_device_layout", "download"),
               (codec, "compress_fast_batch", "kernels"),
               (codec, "decompress_safe_batch", "kernels"),
               (segment_decode, "parse_sequences", "kernels"),
               (segment_decode, "decompress_segments", "kernels"),
               (segment_decode, "raise_on_parse_error", "check"),
               (ci, "_raise_on_bad_block", "check"),
               (xxhash_stream._StreamState, "update", "content_hash"),
               (ci.XXH32, "hash", "kernels")]
    saved = []
    for owner, name, what in targets:
        fn = getattr(owner, name)

        def wrapped(*args, _fn=fn, _span=SPAN + what, **kw):
            with torch.profiler.record_function(_span):
                return _fn(*args, **kw)

        saved.append((owner, name, fn))
        setattr(owner, name, wrapped)

    def undo():
        for owner, name, fn in saved:
            setattr(owner, name, fn)
    return undo


def _union(intervals) -> float:
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total


def read_trace(path) -> dict:
    """The host split and the card's busy time of one traced call from its
    Chrome trace: each part's exclusive time on the host (its spans less
    the spans nested in them), what no span covers, and the union of the
    card's kernel, copy and set intervals within the call (ms)."""
    events = [e for e in json.loads(pathlib.Path(path).read_text())
              ["traceEvents"] if e.get("ph") == "X"]
    call = next(e for e in events if e.get("name") == CALL_SPAN)
    t0, t1 = call["ts"], call["ts"] + call["dur"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"][len(SPAN):],
                     e.get("tid")) for e in events
                    if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith(SPAN)),
                   key=lambda x: (x[3], x[0], -x[1]))
    parts = dict.fromkeys(HOST_PARTS, 0.0)
    stack = []                  # open spans of one thread: [end, name, tid]
    for a, b, name, tid in spans:
        while stack and (stack[-1][2] != tid or stack[-1][0] <= a):
            stack.pop()
        if stack:
            parts[stack[-1][1]] = parts.get(stack[-1][1], 0.0) - (b - a)
        parts[name] = parts.get(name, 0.0) + (b - a)
        stack.append([b, name, tid])
    gpu = [(max(e["ts"], t0), min(e["ts"] + e["dur"], t1)) for e in events
           if e.get("cat") in GPU_CATS and e["ts"] < t1
           and e["ts"] + e["dur"] > t0]
    wall = (t1 - t0) / 1e3
    busy = _union(gpu) / 1e3
    parts = {k: round(v / 1e3, 3) for k, v in parts.items()}
    cats = [e.get("cat") for e in events if e.get("cat") in GPU_CATS]
    return {"wall_ms": round(wall, 3), "parts_ms": parts,
            "other_ms": round(wall - sum(parts.values()), 3),
            "device_busy_ms": round(busy, 3),
            "device_idle_share": round(1 - busy / wall, 4) if wall else None,
            "kernels": cats.count("kernel"),
            "copies": cats.count("gpu_memcpy") + cats.count("gpu_memset")}


def _traced(what: str, fn, work: pathlib.Path) -> dict:
    """``fn()`` once under ``torch.profiler`` (host and card); its split,
    or, where the trace holds no device time, CUDA events around the call
    and no split of the card's time."""
    path = work / f"{what.replace(' ', '_').replace('(', '_').replace(')', '')}.json"
    undo = _patch_parts()
    try:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(CALL_SPAN):
                fn()
                sync()
        prof.export_chrome_trace(str(path))
    finally:
        undo()
    out = read_trace(path)
    device_total = sum(getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0))
                       for e in prof.key_averages())
    out["key_averages_device_ms"] = round(device_total / 1e3, 3)
    if not device_total and not out["device_busy_ms"]:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        out["cuda_event_ms"] = start.elapsed_time(end)
        out["device_busy_ms"] = out["device_idle_share"] = "not measured"
    return out


def host_split(dev, main=None) -> dict:
    """The three stream calls on the main path's 256 MiB in batches of
    ``STREAM_BATCH`` blocks and the tier's ``compress_batch`` and
    ``decompress_batch`` on its 4096 blocks, and, where the package has
    K6, ``compress_stream(level=9)`` on ``CLI_BYTES`` of them: each run
    twice untraced (the host wall of each), then twice traced, each with
    its host split by part (``HOST_PARTS``), what no part covers, and the
    card's busy and idle share (``read_trace``). Runs on the package before
    the host data plane too (``_patch_parts``). Returns the results by
    call."""
    data = main["data"] if main else sharded.make_blocks(N_BLOCKS, BLOCK_LEN,
                                                         SEED)
    raw = data.tobytes()
    blocks = [r.tobytes() for r in data]
    lz4 = Lz4Factory.cuda_instance(dev)
    work = REPO / "build" / "chip_smoke" / "host_split"
    work.mkdir(parents=True, exist_ok=True)
    got = {}

    def stream_compress():
        sink = _Sink()
        compress_stream(io.BytesIO(raw), sink, engine="cuda",
                        batch_blocks=STREAM_BATCH)
        got["frame"] = sink.getvalue()

    def stream_decompress(engine):
        sink = _Sink()
        decompress_stream(io.BytesIO(got["frame"]), sink, engine=engine,
                          batch_blocks=STREAM_BATCH)
        got[engine] = sink.getvalue()

    def tier_compress():
        got["comp"] = lz4.fast_compressor().compress_batch(blocks)

    def stream_hc():
        sink = _Sink()
        compress_stream(io.BytesIO(raw[:CLI_BYTES]), sink, level=HC_LEVEL,
                        batch_blocks=STREAM_BATCH)
        got["hc"] = sink.getvalue()

    def tier_decompress():
        got["blocks"] = lz4.safe_decompressor().decompress_batch(
            got["comp"], BLOCK_LEN)

    calls = (("compress_stream(cuda)", stream_compress),
             ("decompress_stream(cuda)", lambda: stream_decompress("cuda")),
             ("decompress_stream(segment)",
              lambda: stream_decompress("segment")),
             ("compress_batch", tier_compress),
             ("decompress_batch", tier_decompress))
    if hc is not None:
        calls += (("compress_stream(level=9)", stream_hc),)
    out = {}
    for what, fn in calls:
        walls = []
        for _ in range(2):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            walls.append(round((time.perf_counter() - t0) * 1e3, 1))
        res = [_traced(what, fn, work) for _ in range(2)]
        out[what] = {"walls_ms": walls, "traced": res}
        for r in res:
            log(f"host split {what}: walls {walls} ms untraced; traced "
                + json.dumps(r))
    if got["cuda"] != raw or got["segment"] != raw or got["blocks"] != blocks:
        fail("host split: a call did not restore the input")
    if "hc" in got:
        back = io.BytesIO()
        decompress_stream(io.BytesIO(got["hc"]), back)
        if back.getvalue() != raw[:CLI_BYTES]:
            fail("host split: the HC frame did not restore the input")
    return out


# ---------------------------------------------------------------------------
# the idle split of the benchmark's cells by the port's own spans
# ---------------------------------------------------------------------------

# the entry span each cell kernel's launch must lie in (``profiling.entry``)
ENTRY_OF = {"decode_kernel": "decompress_safe_batch",
            "decode_smem_kernel": "decompress_safe_batch",
            "compress_kernel": "compress_fast_batch",
            "hc_kernel": "compress_hc_batch",
            "pack_kernel": "frame_body_packed",
            "lz4block_pack_kernel": "block_stream_body_packed",
            "lz4block_mark_kernel": "block_stream_index",
            "lz4block_chain_kernel": "block_stream_index",
            "lz4block_decode_kernel": "decompress_block_stream_batch",
            "lz4block_verdict_kernel": "decompress_block_stream_batch"}
SYNC_SPAN = "sync."


def innermost(spans) -> list[tuple[int, int, str]]:
    """The host's timeline under ``spans`` ((start, end, name) of one
    thread, nested as ``record_function`` ranges nest) as ordered pieces
    that do not overlap, each with the name of the innermost span there."""
    pieces, stack, t = [], [], None

    def close(until):
        nonlocal t
        while stack and stack[-1][0] <= until:
            end, name = stack.pop()
            if end > t:
                pieces.append((t, end, name))
                t = end

    for s, e, name in sorted(spans, key=lambda x: (x[0], -x[1])):
        close(s)
        if stack and s > t:
            pieces.append((t, s, stack[-1][1]))
        t = s
        stack.append((e, name))
    close(float("inf"))
    return pieces


def idle_by_span(gaps, spans) -> dict:
    """The idle intervals ``gaps`` ((start, end), ordered) split by the
    innermost of ``spans`` the host was in meanwhile, ns by name; None
    for time under none."""
    out: dict = {}
    pieces = innermost(spans)
    j = 0
    for g0, g1 in gaps:
        covered = 0
        while j < len(pieces) and pieces[j][1] <= g0:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < g1:
            a, b, name = pieces[k]
            d = min(b, g1) - max(a, g0)
            if d > 0:
                out[name] = out.get(name, 0) + d
                covered += d
            k += 1
        if g1 - g0 > covered:
            out[None] = out.get(None, 0) + g1 - g0 - covered
    return out


def idle_shares(by_span: dict, window_ns: int) -> dict:
    """``sync_idle_pct``: the window's share (%) idle while the host was in
    a read-back span; ``enqueue_idle_pct``: in an entry span but in no
    read-back span."""
    sync = sum(v for k, v in by_span.items()
               if k is not None and k.startswith(SYNC_SPAN))
    enqueue = sum(v for k, v in by_span.items()
                  if k in ENTRY_OF.values())
    return {"sync_idle_pct": 100.0 * sync / window_ns,
            "enqueue_idle_pct": 100.0 * enqueue / window_ns}


def launches_in_entries(launches, spans) -> dict:
    """For each cell kernel of ``launches`` ((device op name, host launch
    time or None)), how many launches lie inside an entry span of its own
    (:data:`ENTRY_OF`), of how many: ``{kernel: [inside, all]}``. Spans of
    one entry do not nest."""
    by_entry: dict[str, list] = {}
    for s, e, n in sorted(spans):
        by_entry.setdefault(n, []).append((s, e))
    out = {}
    for name, t in launches:
        kernel = next((k for k in ENTRY_OF if f"::{k}<" in name
                       or f"::{k}(" in name), None)
        if kernel is None:
            continue
        inside = False
        if t is not None:
            ivs = by_entry.get(ENTRY_OF[kernel], [])
            i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
            inside = i >= 0 and ivs[i][0] <= t <= ivs[i][1]
        counts = out.setdefault(kernel, [0, 0])
        counts[0] += inside
        counts[1] += 1
    return out


def _port_events(prof):
    """From a finished ``torch.profiler`` session: the port's host spans
    (start, end, name less ``lz4tt.``) and each device operation's name
    with the host time of the runtime call that launched it."""
    spans, launch_at, ops = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        on_host = str(e.device_type()).endswith("CPU")
        if on_host and name.startswith(SPAN):
            spans.append((e.start_ns(), e.end_ns(), name[len(SPAN):]))
        elif on_host and name.startswith("cu") and e.correlation_id():
            launch_at.setdefault(e.correlation_id(), e.start_ns())
        elif not on_host and not e.is_user_annotation():
            ops.append((name, e.correlation_id()))
    return spans, [(n, launch_at.get(c)) for n, c in ops]


def idle_split(cells=(), seed: int = SEED, seconds: float = 20.0):
    """Each of ``cells`` (every cell of ``BENCHMARK.json`` by default)
    traced once, as ``python3 -m benchmark.run --trace 1`` runs it
    (``benchmark.harness.run``), with the port's spans read from the same
    profiler session: its result line, and its idle time split by the
    port's innermost span (``lz4tt.sync.*`` read-backs, the entry spans,
    none), the shares of the window that the read-back and the entry
    spans hold idle, the idle share the run's breakdown charges to the
    benchmark's spans around the port's calls, the program's read-backs a
    batch (``profiling.sync_counts`` before and after the window) and
    whether every K1, K2, K6 and pack launch lies in its entry span.
    Returns the results by cell."""
    from benchmark import cells as bench_cells, harness, system
    from benchmark import trace as bench_trace
    from lz4_tpu_torch.utils import profiling

    class Port(system.Port):
        """The benchmark's program, with the read-back count taken where
        the harness takes the launch count: before and after the window."""

        def __init__(self, config):
            super().__init__(config)
            self.syncs = []

        def launches(self):
            self.syncs.append(sum(profiling.sync_counts().values()))
            return super().launches()

    dev = torch.device("cuda", 0)
    spec = bench_cells.load_spec()
    real = bench_trace.from_profiler
    out = {}
    for name in cells or [w["name"] for w in spec["workloads"]]:
        cell = bench_cells.find_cell(spec, name)
        got = {}

        def keep(prof, got=got):
            got["spans"], got["launches"] = _port_events(prof)
            got["trace"] = real(prof)
            return got["trace"]

        port = Port(cell.config)
        bench_trace.from_profiler = keep
        try:
            done = harness.run(cell, seed, seconds, True, dev,
                               time.perf_counter(), port=port)
        finally:
            bench_trace.from_profiler = real
        res, tr, spans = done.result, got["trace"], got["spans"]
        window_ns = tr.window.end - tr.window.start
        by_span = idle_by_span(tr.gaps(), spans)
        main_entry = (port.compress_name if cell.traffic["pipeline"] == "write"
                      else "decompress_safe_batch")
        batches = sum(1 for s, e, n in spans if n == main_entry
                      and tr.window.start <= s <= tr.window.end)
        wrapped = {port.compress_name, "frame_body_packed",
                   "decompress_safe_batch"}
        bench_idle = sum(v for k, v in res["breakdown"]["idle_gaps"]
                         if k in wrapped)
        out[name] = {
            "result": res, "notes": done.notes,
            "idle_by_span_s": {str(k): v / 1e9 for k, v in by_span.items()},
            **idle_shares(by_span, window_ns),
            "idle_pct": 100.0 * tr.idle_share(),
            "bench_call_idle_pct": 100.0 * bench_idle / tr.window_s,
            "host_syncs_per_batch": (port.syncs[1] - port.syncs[0]) / batches,
            "batches": batches,
            "launches_in_entry_spans": launches_in_entries(got["launches"],
                                                           spans)}
        log(f"idle split {name}: " + json.dumps(out[name]))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--pack-parse"]:
        phase_card()
        pack_parse_only(torch.device("cuda"))
        return 0
    if sys.argv[1:2] == ["--idle-split"]:
        p = argparse.ArgumentParser(prog="chip_smoke.py --idle-split")
        p.add_argument("cells", nargs="*")
        p.add_argument("--seed", type=int, default=SEED)
        p.add_argument("--seconds", type=float, default=20.0)
        args = p.parse_args(sys.argv[2:])
        log(phase_card())
        idle_split(args.cells, args.seed, args.seconds)
        return 0
    if sys.argv[1:] == ["--host-split"]:
        log(phase_card())
        build.build_all()
        log("host split: " + json.dumps(host_split(torch.device("cuda"))))
        return 0
    if sys.argv[1:] == ["--parallel-stream"]:
        log(phase_card())
        build.build_all()
        dev = torch.device("cuda")
        raw = sharded.make_blocks(N_BLOCKS, BLOCK_LEN, SEED).tobytes()[
            :CLI_BYTES]
        src, lens = sharded.upload_blocks(np.frombuffer(raw, np.uint8).reshape(
            -1, BLOCK_LEN).copy(), dev)
        out, out_lens = parallel_compress.compress_parallel_batch(
            src, lens, max_compressed_length(BLOCK_LEN))
        log("parallel stream: " + json.dumps(_parallel_stream(
            dev, raw, layout.from_device_layout(out, out_lens))))
        return 0
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    card = phase_card()
    secs = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        secs[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("build", phase_build)
    timed("edge cases", phase_edge_cases, dev)
    rows, main_out = timed("main path", phase_main_path, dev)
    rows += timed("lz4block", phase_lz4block, dev)
    rows += timed("tier", phase_tier, dev, main_out)
    rows += timed("stream", phase_stream, dev, main_out)
    rows += timed("hc", phase_hc, dev, main_out)
    timed("host split", host_split, dev, main_out)
    del main_out
    one_row = timed("frame", phase_frame, dev)
    fmt_rows, fmt = timed("formats", phase_formats, dev, card)
    rows += fmt_rows
    dist_launches = timed("dist", phase_dist, dev, card)
    rows += timed("parallel", phase_parallel, dev)
    for r in rows:
        r.update(one_row.get(r["name"], {}))
        r["dist_launches"] = dist_launches.get(r["name"], 0)
        r["formats_launches"] = fmt["total"].get(r["name"], 0)
    log(f"total {time.perf_counter() - t_start:.1f} s; by phase, s: {secs}")
    log(card)
    log("kernels: " + json.dumps({r["name"]: r["launches"] for r in rows}))
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
