"""Cells are found from files by name, and BENCHMARK.json keeps to the
benchmark's contract."""

import json
import re
import shutil

import pytest

from benchmark import cells

SPEC = cells.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_every_cell_resolves_to_its_files():
    found = cells.list_cells(SPEC)
    assert [c.name for c in found] == [w["name"] for w in SPEC["workloads"]]
    for c in found:
        assert c.config["name"] == next(
            w["config"] for w in SPEC["workloads"] if w["name"] == c.name)
        assert hasattr(cells.pipeline(c), "judge")
        assert c.per_layer, c.name
        for m in c.per_layer:
            assert callable(cells.metric_reader(m["name"]))


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path, tiny_cell):
    root = tmp_path / "benchmark"
    for sub in ("configs", "traffic", "metrics", "pipelines"):
        shutil.copytree(cells.HERE / sub, root / sub)
    config = json.loads((root / "configs" / "block64k_fast.json").read_text())
    config.update(name="dummy_cfg", block_bytes=2048,
                  batch_blocks={"write": 4, "dummy_pipe": 4},
                  check={"rows": {"write": 12}, "decoded_batches": 1})
    (root / "configs" / "dummy_cfg.json").write_text(json.dumps(config))
    # a pipeline of its own, here a copy of the write pipeline
    shutil.copy(root / "pipelines" / "write.py",
                root / "pipelines" / "dummy_pipe.py")
    traffic = json.loads((root / "traffic" / "write.json").read_text())
    traffic.update(name="dummy_mix", pipeline="dummy_pipe", in_flight=1,
                   held_batches=1)
    (root / "traffic" / "dummy_mix.json").write_text(json.dumps(traffic))
    (root / "metrics" / "dummy_metric.py").write_text(
        "def read(ctx):\n    return float(len(ctx.slots))\n")
    spec = json.loads(json.dumps(SPEC))
    spec["configs"].append({"name": "dummy_cfg", "source": "x",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix",
                              "config": "dummy_cfg", "traffic": "dummy_mix",
                              "chips": 1, "why": "a test"})
    spec["end_to_end"][0]["workloads"].append("dummy_cfg.dummy_mix")
    spec["per_layer"].append({"name": "dummy_metric", "unit": "batches",
                              "better": "higher", "source": "program_counter",
                              "layer": "test", "moves": "compress_GBps",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    listed = {c.name: c for c in cells.list_cells(spec, root)}
    cell = listed["dummy_cfg.dummy_mix"]
    assert cell.config["block_bytes"] == 2048
    assert cell.traffic["name"] == "dummy_mix"
    assert cells.pipeline(cell).__module__.endswith("dummy_pipe")
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert {m["name"] for m in cell.end_to_end} == {
        "compress_GBps", "batch_p95_ms", "setup_s"}

    import time

    import torch

    from benchmark import harness
    out = harness.run(cell, 77, 2.0, True, torch.device("cpu"),
                      time.perf_counter(), n_workers=1)
    assert out.result["correct"]
    assert out.result["metrics"]["dummy_metric"]["value"] >= 1


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
    names = []
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (cells.HERE.parent / c["file"]).is_file()
        names.append(c["name"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert w["config"] in names
        names += [w["name"], w["traffic"]]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert m["better"] in ("lower", "higher")
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["source"] in SOURCES
        names.append(m["name"])
    for name in names:
        assert NAME.match(name), name
    assert len({m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}) \
        == len(SPEC["end_to_end"]) + len(SPEC["per_layer"])
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics_keep_to_the_contract():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cell_names = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert w in cell_names
            assert w in e2e[m["moves"]].get("workloads", [w])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        assert (cells.HERE / "metrics" / f"{m['name']}.py").is_file()
    for c in cells.list_cells(SPEC):
        reported = {m["name"] for m in c.end_to_end}
        assert "setup_s" in reported and len(reported) >= 2
        assert c.traffic["rate_metric"] in reported
        assert (cells.HERE / "codecs" / f"{c.config['codec']}.py").is_file()
        control = {**c.config, **c.config["control"]}
        assert (cells.HERE / "codecs" / f"{control['codec']}.py").is_file()


@pytest.mark.parametrize("path", sorted(
    p.relative_to(cells.HERE.parent).as_posix()
    for p in cells.HERE.rglob("*") if p.is_file()
    and "__pycache__" not in p.parts))
def test_file_names_use_the_names_characters(path):
    assert re.match(r"^[A-Za-z0-9_./-]+$", path), path
