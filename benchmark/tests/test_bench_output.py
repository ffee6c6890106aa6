"""The result's line: its keys, in order, and what a run prints where it
cannot run."""

import json
import shutil
import subprocess
import sys
import time

import torch

from benchmark import cells, harness, run

CHECKOUT = cells.HERE.parent


def test_the_last_lines_keys(tiny_cell):
    for traced in (False, True):
        out = harness.run(tiny_cell("block64k_fast.write"), 5, 2.0, traced,
                          torch.device("cpu"), time.perf_counter(),
                          n_workers=1)
        r = json.loads(json.dumps(out.result))
        keys = list(r)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "compared"
        assert set(r["device"]) >= {"platform", "kind", "count",
                                    "memory_peak_bytes"}
        for name, c in r["compared"].items():
            assert set(c) == {"value", "limit"}, name
        for name, m in r["metrics"].items():
            assert set(m) == {"value", "unit"}, name
        if not traced:
            assert set(r["metrics"]) == {"compress_GBps", "batch_p95_ms",
                                         "setup_s"}
            assert all(m["value"] > 0 for m in r["metrics"].values())


def _main_in(cwd, *argv):
    return subprocess.run(
        [sys.executable, "-m", "benchmark.run", *argv], cwd=cwd,
        capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "HOME": str(cwd),
             "CUDA_VISIBLE_DEVICES": ""})


def test_no_card_no_result():
    p = _main_in(CHECKOUT, "--workload", "block64k_fast.write", "--seed",
                 str(2 ** 31 + 5), "--seconds", "1", "--trace", "0")
    assert p.returncode != 0
    assert p.stdout == ""
    assert "card" in p.stderr


def test_a_checkout_of_only_the_benchmark_prints_nothing(tmp_path):
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(cells.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _main_in(tmp_path, "--workload", "block64k_fast.read", "--seed", "1",
                 "--seconds", "1", "--trace", "1")
    assert p.returncode != 0
    assert p.stdout == ""


def test_caches_sit_at_fixed_paths_inside_the_checkout(tmp_path):
    dirs = run.cache_dirs(tmp_path)
    assert dirs == run.cache_dirs(tmp_path)
    for path in dirs.values():
        assert path.startswith(str(tmp_path / "build"))
    import sys
    saved = sys.pycache_prefix, sys.dont_write_bytecode
    try:
        run.bytecode_cache(tmp_path)
        assert sys.pycache_prefix == str(tmp_path / "build" / "pycache")
        assert not sys.dont_write_bytecode
    finally:
        sys.pycache_prefix, sys.dont_write_bytecode = saved
