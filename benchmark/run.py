"""Run one cell of ``BENCHMARK.json`` once on the card and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: ``correct``,
``attempted`` and ``failed`` (blocks), ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the check
compared, with its limit. The numbers compared are also the last lines of
standard error. The run exits with another code than 0, and prints no
result, where no card (or too few) is found, where the program cannot be
imported, or where a module of JAX or of the JAX package was loaded.

The top of this module imports only the standard library: the reference's
worker processes import it again when they start.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent


def cache_dirs(root: pathlib.Path = CHECKOUT) -> dict[str, str]:
    """The program's build and kernel caches, at fixed paths inside the
    checkout, so that only a cell's first run there builds."""
    build = root / "build"
    return {"LZ4_TPU_TORCH_BUILD_DIR": str(build / "lz4_tpu_torch"),
            "TORCH_EXTENSIONS_DIR": str(build / "torch_extensions"),
            "TRITON_CACHE_DIR": str(build / "triton")}


def bytecode_cache(root: pathlib.Path = CHECKOUT) -> None:
    """Python's compiled modules, torch's among them, written to and read
    from a fixed directory inside the checkout. Where the environment turns
    the writing of bytecode off (``PYTHONDONTWRITEBYTECODE``) and the
    installation holds none, every run would compile torch's sources
    again: some 3 s of its 8 s import on the card's machine."""
    sys.pycache_prefix = str(root / "build" / "pycache")
    sys.dont_write_bytecode = False


def parse(argv: list[str] | None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.run",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv: list[str] | None = None) -> int:
    args = parse(argv)
    os.environ.update(cache_dirs())
    bytecode_cache()
    from . import cells

    cell = cells.find_cell(cells.load_spec(), args.workload)
    import torch

    marks = [("torch", time.perf_counter())]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} card(s); "
              f"torch.cuda finds "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.init()
    torch.zeros(1, device=device)       # the context
    marks.append(("context", time.perf_counter()))
    from . import harness

    out = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                      device, T_START, marks=marks)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"benchmark: modules that must not be loaded were: "
              f"{', '.join(loaded)}", file=sys.stderr)
        return 3
    for line in out.notes:
        print(line, file=sys.stderr)
    for name, c in out.result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out.result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
