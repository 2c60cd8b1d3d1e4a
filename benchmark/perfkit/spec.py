"""Where a cell's pieces live, found by the names in ``BENCHMARK.json``.

* a configuration: ``benchmark/configs/<config>.json``;
* a traffic mix: ``benchmark/traffic/<traffic>.json``, read by the one
  generator in :mod:`perfkit.traffic`;
* the limits that decide ``correct``: ``benchmark/limits/<cell>.json``;
* a metric: ``benchmark/metrics/<metric>.py``, a module with
  ``read(run) -> float | None``; a quantity split by the end-to-end
  metric it moves (``idle_share.train``, ``idle_share.serve``) may share
  one reader, ``benchmark/metrics/<quantity>.py``;
* a span the traced run puts around a call into the port:
  ``benchmark/spans/<span>.json``;
* a driver: :mod:`perfkit.drivers.<name>`, named by the mix's
  ``"driver"``.

Adding a cell, a mix, a metric or a span adds files and entries and
edits none.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(SPEC_FILE)


def by_name(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in {SPEC_FILE.name}")


@dataclasses.dataclass
class Cell:
    """Everything one cell needs, read from its files."""
    name: str
    chips: int
    config: dict          # the configuration file
    mix: dict             # the traffic mix file
    limits: dict          # the limits that decide ``correct``
    end_to_end: list      # the cell's end-to-end metric entries
    per_layer: list       # the cell's per-layer metric entries


def _metric_in_cell(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, spec: dict | None = None) -> Cell:
    spec = load_spec() if spec is None else spec
    w = by_name(spec["workloads"], name, "workload")
    c = by_name(spec["configs"], w["config"], "config")
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(ROOT / c["file"]),
        mix=load_json(BENCH / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(BENCH / "limits" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"]
                    if _metric_in_cell(m, name)],
        per_layer=[m for m in spec["per_layer"] if _metric_in_cell(m, name)])


def _load_path(path: Path, modname: str):
    specobj = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(specobj)
    specobj.loader.exec_module(mod)
    return mod


def metric_path(name: str) -> Path:
    """The reader of metric ``name``: ``metrics/<name>.py``, or else that
    of the name with its last dotted parts taken off, the longest that
    has a file."""
    parts = name.split(".")
    for n in range(len(parts), 0, -1):
        path = BENCH / "metrics" / (".".join(parts[:n]) + ".py")
        if path.exists():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{BENCH / 'metrics'}")


def metric_reader(name: str):
    """The module that reads metric ``name`` (:func:`metric_path`)."""
    return _load_path(metric_path(name), "bench_metric_" + name.replace(
        ".", "_").replace("-", "_"))


def span_entries() -> list[dict]:
    """Every span file, each ``{"name", "module", "attr"}``."""
    out = []
    for p in sorted((BENCH / "spans").glob("*.json")):
        e = load_json(p)
        e["name"] = p.stem
        out.append(e)
    return out


def driver(name: str):
    return importlib.import_module(f"perfkit.drivers.{name}")
