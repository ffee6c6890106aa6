"""Finding a cell's parts by name: ``BENCHMARK.json`` names each cell's
configuration and traffic mix, and each per-layer metric; each is a file of
its own under this directory.

- configuration ``<c>``: ``configs/<c>.json``, which names its codec
  ``<k>``: ``codecs/<k>.py`` (see ``codecs/__init__.py``)
- traffic mix ``<t>``: ``traffic/<t>.json``, which names its pipeline
  ``<p>``: ``pipelines/<p>.py``, whose ``Pipeline`` drives and judges a
  batch
- per-layer metric ``<m>``: ``metrics/<m>.py``, whose ``read(ctx)`` returns
  the value, or None where it finds nothing to read

A cell, a configuration, a codec, a traffic mix, a pipeline or a metric is
added by adding its files and its entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import pathlib
from typing import Callable

HERE = pathlib.Path(__file__).resolve().parent
SPEC = HERE.parent / "BENCHMARK.json"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]      # the entries of the metrics the cell reports
    per_layer: list[dict]
    root: pathlib.Path = HERE   # where its files were found


def load_spec(path: pathlib.Path = SPEC) -> dict:
    with open(path) as f:
        return json.load(f)


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(spec: dict, name: str, root: pathlib.Path = HERE) -> Cell:
    """The cell ``name`` of ``spec`` with its configuration and traffic
    files read from under ``root``."""
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")
    config = _load_json(root / "configs" / f"{entry['config']}.json")
    traffic = _load_json(root / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name, entry["chips"], config, traffic, e2e, per_layer, root)


def list_cells(spec: dict, root: pathlib.Path = HERE) -> list[Cell]:
    return [find_cell(spec, w["name"], root) for w in spec["workloads"]]


def _load(kind: str, name: str, root: pathlib.Path):
    path = root / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: pathlib.Path = HERE) -> Callable:
    """``read`` of ``metrics/<name>.py``."""
    return _load("metrics", name, root).read


def pipeline(cell: Cell) -> type:
    """``Pipeline`` of ``pipelines/<p>.py``, ``<p>`` the cell's traffic's
    ``pipeline``."""
    return _load("pipelines", cell.traffic["pipeline"], cell.root).Pipeline
