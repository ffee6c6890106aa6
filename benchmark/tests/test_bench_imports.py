"""Nothing the benchmark runs loads JAX or the JAX package, and the
yardstick loads nothing of the program. Top-level module names are
compared whole: ``lz4_tpu_torch`` begins with ``lz4_tpu`` and is not it."""

import ast
import json
import subprocess
import sys

from benchmark import cells, harness

CHECKOUT = cells.HERE.parent
YARDSTICK = ["reference", "reference_hc", "check", "data", "roofline",
             "trace", "layers", "cells", "codecs.lz4_fast", "codecs.lz4_hc",
             "codecs.lz4_parallel"]


def _loaded(code: str) -> set[str]:
    p = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                        "print(json.dumps(sorted({m.split('.')[0] for m in "
                        "sys.modules})))"],
                       cwd=CHECKOUT, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    return set(json.loads(p.stdout.splitlines()[-1]))


def test_a_run_loads_no_jax_and_no_jax_package():
    loaded = _loaded(
        "import copy, time, torch\n"
        "from benchmark import cells, harness, run\n"
        "cell = cells.find_cell(cells.load_spec(), 'block64k_fast.read')\n"
        "cell.config = copy.deepcopy(cell.config)\n"
        "cell.config.update(block_bytes=2048, batch_blocks={'read': 4},\n"
        "                   check={'rows': {'read': 4}})\n"
        "out = harness.run(cell, 3, 2.0, True, torch.device('cpu'),\n"
        "                  time.perf_counter(), n_workers=2)\n"
        "assert out.result['correct'], out.result\n"
        "assert not harness.forbidden_modules()\n")
    assert "lz4_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "lz4_tpu"}


def test_the_check_compares_whole_names():
    assert harness.forbidden_modules(
        ["lz4_tpu_torch", "lz4_tpu_torch.kernels.codec", "jaxtyping",
         "benchmark.run"]) == []
    assert harness.forbidden_modules(
        ["lz4_tpu.core.constants", "jax.numpy", "jaxlib", "flax"]) == [
        "flax", "jax", "jaxlib", "lz4_tpu"]


def test_the_yardstick_loads_nothing_of_the_program():
    loaded = _loaded("".join(f"import benchmark.{m}\n" for m in YARDSTICK))
    assert not loaded & {"lz4_tpu_torch", "lz4_tpu", "jax"}
    # the reference and the check run in workers that start without torch
    loaded = _loaded(
        "import benchmark.check as c\n"
        "assert c.compressed_as_stated('lz4_fast', {}, b'ab' * 99,\n"
        "                              b'\\x00', 198, False) is False\n"
        "assert c.compressed_as_stated('lz4_hc', {'level': 9}, b'ab' * 99,\n"
        "                              b'\\x00', 198, False) is False\n")
    assert not loaded & {"torch", "lz4_tpu_torch"}


def test_only_the_system_and_codec_modules_name_the_program():
    for path in sorted(cells.HERE.rglob("*.py")):
        if "tests" in path.parts:
            continue
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.add(node.module.split(".")[0])
        assert not names & {"jax", "jaxlib", "flax", "lz4_tpu"}, path
        if path.name != "system.py" and path.parent.name != "codecs":
            assert "lz4_tpu_torch" not in names, path
