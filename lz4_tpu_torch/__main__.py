"""Command line of the port: ``python -m lz4_tpu_torch``.

LZ4 frame compress and decompress, compatible with the ``lz4`` CLI, file
hashes and a report of the ``cuda`` tier, as ``python -m lz4_tpu`` has
them (``lz4_tpu/__main__.py``), with the port's engines (``fastest``,
``cuda``, ``segment``, ``sharded``; ``sharded`` splits a batch over the
ranks of a process group, and is one rank here, as no command starts a
group). It runs on the card, HC (``-l 1..17``) included. ``-D FILE``
compresses against a dictionary (a dictionary frame, ``--dict-id`` its
DictID field; the fast scan only) and decodes dictionary frames;
``--allow-dependent`` reads linked-block frames (``lz4 -BD``), which are
refused by default like lz4-java. ``--turbo`` (the JAX package's native
host tier) is not ported.

Examples:
  python -m lz4_tpu_torch compress   input.bin out.lz4 --engine cuda -B 64KB
  python -m lz4_tpu_torch compress   input.bin out.lz4 -l 9
  python -m lz4_tpu_torch compress   input.bin out.lz4 -D dict.bin --dict-id 7
  python -m lz4_tpu_torch decompress out.lz4 restored.bin --engine segment
  python -m lz4_tpu_torch decompress out.lz4 restored.bin -D dict.bin
  python -m lz4_tpu_torch decompress linked.lz4 restored.bin --allow-dependent
  python -m lz4_tpu_torch xxh32 input.bin
  python -m lz4_tpu_torch info
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .api.factory import Lz4Factory, XXHashFactory
from .core.errors import Lz4Error
from .formats.frame import (
    DEFAULT_FEATURES, BlockSize, FrameFlag, Lz4FrameOutputStream)
from .streams.pipeline import (
    ENGINES, compress_stream, decode_frames, decompress_stream)

_BLOCK_SIZES = {"64KB": BlockSize.SIZE_64KB, "256KB": BlockSize.SIZE_256KB,
                "1MB": BlockSize.SIZE_1MB, "4MB": BlockSize.SIZE_4MB}
_CHUNK = 1 << 20


def _block_size(name: str) -> BlockSize:
    if name not in _BLOCK_SIZES:
        raise argparse.ArgumentTypeError(
            f"block size must be one of {list(_BLOCK_SIZES)}")
    return _BLOCK_SIZES[name]


def cmd_compress(args, device) -> None:
    if args.dict_id is not None and not args.dict:
        raise SystemExit("--dict-id requires -D/--dict")
    t0 = time.perf_counter()
    if args.dict:
        # a dictionary frame: the frame writer, each batch of blocks one
        # launch of K2 with the dictionary
        if args.level != 0:
            raise SystemExit("-D supports the default fast level only")
        with open(args.dict, "rb") as f:
            dictionary = f.read()
        feats = DEFAULT_FEATURES if args.no_frame_crc else (
            FrameFlag.BLOCK_INDEPENDENCE, FrameFlag.CONTENT_CHECKSUM)
        with open(args.input, "rb") as src, open(args.output, "wb") as dst:
            w = Lz4FrameOutputStream(dst, block_size=args.block_size,
                                     features=feats, dictionary=dictionary,
                                     dict_id=args.dict_id, device=device)
            while chunk := src.read(_CHUNK):
                w.write(chunk)
            w.close_keep_underlying()
            n = dst.tell()
    else:
        with open(args.input, "rb") as src, open(args.output, "wb") as dst:
            n = compress_stream(src, dst, block_size=args.block_size,
                                engine=args.engine,
                                content_checksum=not args.no_frame_crc,
                                level=args.level, device=device)
    dt = time.perf_counter() - t0
    in_size = os.path.getsize(args.input)
    print(f"{args.input}: {in_size} -> {n} bytes "
          f"({n / max(1, in_size) * 100:.2f}%), "
          f"{in_size / max(dt, 1e-9) / 1e6:.1f} MB/s [{args.engine}]")


def cmd_decompress(args, device) -> None:
    t0 = time.perf_counter()
    dictionary = None
    if args.dict:
        with open(args.dict, "rb") as f:
            dictionary = f.read()
    with open(args.input, "rb") as src, open(args.output, "wb") as dst:
        if dictionary is None:
            n = decompress_stream(src, dst, engine=args.engine,
                                  allow_dependent=args.allow_dependent,
                                  device=device)
        else:
            n = decode_frames(src, dst, engine=args.engine, device=device,
                              allow_dependent=args.allow_dependent,
                              dictionary=dictionary)
    dt = time.perf_counter() - t0
    print(f"{args.input}: -> {n} bytes, "
          f"{n / max(dt, 1e-9) / 1e6:.1f} MB/s [{args.engine}]")


def _hash_file(path: str, stream) -> int:
    with open(path, "rb") as fh:
        while stream.update_from(fh, _CHUNK):
            pass
    return stream.get_value()


def cmd_xxh32(args, device) -> None:
    s = XXHashFactory.cuda_instance(device).new_streaming_hash32(args.seed)
    print(f"{_hash_file(args.input, s) & 0xFFFFFFFF:08x}  {args.input}")


def cmd_xxh64(args, device) -> None:
    s = XXHashFactory.cuda_instance(device).new_streaming_hash64(args.seed)
    print(f"{_hash_file(args.input, s) & 0xFFFFFFFFFFFFFFFF:016x}  "
          f"{args.input}")


def cmd_info(args, device) -> None:
    print("lz4_tpu_torch:")
    print(f"  torch        : {torch.__version__} (CUDA {torch.version.cuda})")
    if device.type == "cuda":
        print(f"  device       : {torch.cuda.get_device_name(device)} x "
              f"{torch.cuda.device_count()}")
    else:
        print(f"  device       : {device}")
    print(f"  lz4 tier     : {Lz4Factory.cuda_instance(device)!r}")
    print(f"  hash tier    : {XXHashFactory.cuda_instance(device)!r}")
    print(f"  engines      : {', '.join(ENGINES)}")
    print("  compressors  : fast scan (K2), HC levels 1-17 (K6)")


def main(argv=None, device: str | torch.device = "cuda") -> int:
    """Run the command line; ``device`` is for the tests (``"cpu"`` runs
    the kernels' plain versions)."""
    p = argparse.ArgumentParser(
        prog="lz4_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("compress", help="compress a file into an LZ4 frame")
    c.add_argument("input")
    c.add_argument("output")
    c.add_argument("-B", "--block-size", type=_block_size, default="64KB")
    c.add_argument("--engine", default="fastest", choices=ENGINES)
    c.add_argument("-l", "--level", type=int, default=0,
                   help="0 = fast scan (default); 1-17 = HC at that "
                   "level, on the card")
    c.add_argument("-D", "--dict", metavar="FILE",
                   help="compress against a dictionary (writes a "
                   "dictionary frame; lz4 CLI -D)")
    c.add_argument("--dict-id", type=lambda v: int(v, 0), default=None,
                   help="record this DictID in the frame header "
                   "(requires -D)")
    c.add_argument("--no-frame-crc", action="store_true",
                   help="omit the content checksum")
    c.set_defaults(fn=cmd_compress)

    d = sub.add_parser("decompress", help="decode LZ4 frame(s)")
    d.add_argument("input")
    d.add_argument("output")
    d.add_argument("--allow-dependent", action="store_true",
                   help="also read linked-block frames (lz4 CLI -BD); "
                   "refused by default, as lz4-java refuses them")
    d.add_argument("-D", "--dict", metavar="FILE",
                   help="dictionary file for dictionary frames "
                   "(lz4 CLI -D); accepts the DictID header field")
    d.add_argument("--engine", default="fastest", choices=ENGINES)
    d.set_defaults(fn=cmd_decompress)

    for name, fn in (("xxh32", cmd_xxh32), ("xxh64", cmd_xxh64)):
        h = sub.add_parser(name, help=f"{name} checksum of a file")
        h.add_argument("input")
        h.add_argument("--seed", type=lambda v: int(v, 0), default=0)
        h.set_defaults(fn=fn)

    i = sub.add_parser("info", help="show the tier and the device")
    i.set_defaults(fn=cmd_info)

    args = p.parse_args(argv)
    try:
        args.fn(args, torch.device(device))
    except BrokenPipeError:
        # a reader downstream (`| head`) closed the pipe: not an error
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
    except (OSError, Lz4Error) as e:
        print(f"lz4_tpu_torch: error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
