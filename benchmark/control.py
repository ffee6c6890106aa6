"""The check's control: a cell run with one guarantee of its configuration
broken in the program, which the check has to find.

    python3 -m benchmark.control --workload <cell> --seeds <a,b,c> \\
        --seconds <s>

The configuration's ``control`` entry names what is broken: ``codec``
``lz4_parallel`` (the port's parallel compressor, K7, whose LZ4 is valid
but not the fast scan's bytes, in place of K2) or ``level`` 8 (HC one
level below the stated 9, the step a faster HC would tempt). Each seed
prints one JSON line: the seed, ``correct`` and the numbers compared. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds, one run each")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    from .run import cache_dirs

    os.environ.update(cache_dirs())
    import torch

    from . import cells, harness

    if not torch.cuda.is_available():
        print("benchmark.control: no card", file=sys.stderr)
        return 2
    cell = cells.find_cell(cells.load_spec(), args.workload)
    overrides = cell.config["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        out = harness.run(cell, seed, args.seconds, False,
                          torch.device("cuda", 0), time.perf_counter(),
                          overrides=overrides)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "control": overrides,
                          "correct": out.result["correct"],
                          "failed": out.result["failed"],
                          "attempted": out.result["attempted"],
                          "compared": out.result["compared"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
