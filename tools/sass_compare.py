"""Compare the SASS of the port's kernels built from two ``csrc`` trees,
function by function.

    python tools/sass_compare.py OTHER_CSRC [SOURCE ...]

Builds ``csrc/<SOURCE>.cu`` (by default ``lz4_decode``, ``block_stream``
and ``segment_decode``) from this checkout and from ``OTHER_CSRC`` (say,
the parent commit's, unpacked with ``git archive``) with the port's
``nvcc`` flags, dumps each library with ``cuobjdump -sass``, and prints one
JSON line a source: for every kernel in both builds, whether its SASS is
the same (instructions and encodings; addresses, and the translation
unit's hash in the anonymous namespace's name, left out) and its lines on
each side; then the kernels only one side has. Needs ``nvcc`` and
``cuobjdump``.
"""

from __future__ import annotations

import json
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from lz4_tpu_torch.kernels import build  # noqa: E402

SOURCES = ("lz4_decode", "block_stream", "segment_decode")
_INTERNAL = re.compile(r"_GLOBAL__N__[0-9a-f]+_")
_ADDRESS = re.compile(r"/\*[0-9a-f]{4,}\*/")


def functions(sass: str) -> dict[str, list[str]]:
    """Kernel name (internal hash left out) -> its instruction lines."""
    out: dict[str, list[str]] = {}
    cur = None
    for line in sass.splitlines():
        if "Function : " in line:
            cur = _INTERNAL.sub("_GLOBAL__N__", line.split("Function : ")[1]
                                .strip())
            out[cur] = []
        elif cur is not None and "/*" in line:
            out[cur].append(" ".join(_ADDRESS.sub("", line).split()))
    return out


def sass_of(csrc: pathlib.Path, source: str, work: pathlib.Path) -> str:
    so = work / f"lib{source}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
                    str(so), str(csrc / f"{source}.cu")], check=True,
                   capture_output=True, text=True)
    cuobjdump = shutil.which("cuobjdump") or str(
        pathlib.Path(build._nvcc()).parent / "cuobjdump")
    return subprocess.run([cuobjdump, "-sass", str(so)], check=True,
                          capture_output=True, text=True).stdout


def compare(other: pathlib.Path, source: str) -> dict:
    with tempfile.TemporaryDirectory() as td:
        mine = functions(sass_of(build.CSRC, source, pathlib.Path(td)))
        theirs = functions(sass_of(other, source, pathlib.Path(td)))
    both = sorted(set(mine) & set(theirs))
    return {"source": source,
            "kernels": {k: {"same": mine[k] == theirs[k],
                            "lines": [len(mine[k]), len(theirs[k])]}
                        for k in both},
            "only_here": sorted(set(mine) - set(theirs)),
            "only_there": sorted(set(theirs) - set(mine))}


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    other = pathlib.Path(argv[0]).resolve()
    for source in argv[1:] or SOURCES:
        print(json.dumps(compare(other, source)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
