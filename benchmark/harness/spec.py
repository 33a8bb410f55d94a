"""The benchmark's data: ``BENCHMARK.json`` at the root of the checkout, and,
found by name under ``benchmark/``, each configuration
(``configs/<config>.json``), the reference's network it runs
(``reference/networks/<MODEL["BACKBONE"]>.py``), each traffic mix
(``traffic/<traffic>.json``), the limits of a cell's correctness check
(``limits/<cell>.json``), a traffic mix's driver (``drivers/<driver>.py``)
and each metric's reader (``metrics/<name>.py``, else ``metrics/<name less
its last dotted part>.py``). Adding a cell, configuration, network, mix or
metric adds files and entries; no file here names one."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

from reference import nets

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    conf: dict  # the configuration file
    traffic: dict  # the traffic mix file
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict  # {number: limit} of the correctness check
    bench_dir: Path


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_bench(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in bench['workloads']]}")
    conf_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    bench_dir = root / "benchmark"
    limits_path = bench_dir / "limits" / f"{name}.json"
    conf = _json(root / conf_entry["file"])
    nets.network(conf["MODEL"])  # a network that is not there stops the cell here
    return Cell(
        name=name, chips=entry["chips"], conf=conf,
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in bench["per_layer"] if _reports(m, name)],
        limits=_json(limits_path) if limits_path.exists() else {},
        bench_dir=bench_dir)


def load_module(path: Path, tag: str):
    spec = importlib.util.spec_from_file_location(f"_bench_{tag}_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver_class(cell: Cell):
    return load_module(cell.bench_dir / "drivers" / f"{cell.traffic['driver']}.py", "driver").Driver


def reader(bench_dir: Path, name: str):
    """The ``read(run)`` function of metric ``name``: ``metrics/<name>.py``,
    else the file named by ``name`` less its last dotted part (one reader
    for ``step.mfu.batch`` and ``step.mfu.detect``)."""
    base = bench_dir / "metrics"
    for stem in (name, name.rsplit(".", 1)[0]):
        path = base / f"{stem}.py"
        if path.exists():
            return load_module(path, "metric").read
    raise FileNotFoundError(f"no reader for metric {name!r} under {base}")
