"""BENCHMARK.json and the files it names: every cell, configuration, traffic
mix, limit file and metric reader loads; names and units keep to the
contract's characters; a new cell is added by adding files only."""

import hashlib
import json
import shutil

import pytest

from conftest import BENCH
from harness import spec
from reference import nets

ROOT = BENCH.parent
BENCH_JSON = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH_JSON["workloads"]]
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def all_names():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH_JSON[section]:
            yield entry["name"]
    for w in BENCH_JSON["workloads"]:
        yield w["config"]
        yield w["traffic"]


def test_top_level_keys_and_paths():
    assert set(BENCH_JSON) == KEYS
    assert BENCH_JSON["paths"] == ["benchmark"]
    assert BENCH_JSON["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH_JSON["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units_use_allowed_characters():
    names = list(all_names())
    assert all(spec.NAME_RE.match(n) for n in names), [n for n in names if not spec.NAME_RE.match(n)]
    for section in ("end_to_end", "per_layer"):
        for m in BENCH_JSON[section]:
            assert spec.UNIT_RE.match(m["unit"]), m
            assert m["better"] in ("lower", "higher")
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        got = [e["name"] for e in BENCH_JSON[section]]
        assert len(got) == len(set(got)), section


def test_metric_entries():
    e2e = {m["name"]: m for m in BENCH_JSON["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH_JSON["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        if m["name"].endswith("_roofline") or "_roofline." in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
        # Every cell that reports it reports the metric it moves.
        for cell in m.get("workloads", CELLS):
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads(name):
    cell = spec.load_cell(name)
    assert cell.chips == 1
    assert {"setup_s"} < {m["name"] for m in cell.end_to_end}
    assert cell.per_layer and cell.limits
    spec.driver_class(cell)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(cell.bench_dir, m["name"]))


@pytest.mark.parametrize("entry", BENCH_JSON["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"] and conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"] == []
    # Every setting the reference reads is stated in the file itself.
    for key in ("BACKBONE", "WIDTH", "FEAT_STRIDE", "POOL_SIZE", "NUM_TEMPLATES", "NUM_CLASSES",
                "FC_DIM", "FC7_DIM", "COMPUTE_DTYPE"):
        assert key in conf["MODEL"]
    assert len(conf["SEAR"]) == 11
    nets.param_specs(conf["MODEL"], "az")
    nets.param_specs(conf["MODEL"], "frcnn")


def _tree_digest(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_new_cell_is_added_by_files_only(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = _tree_digest(tmp_path / "benchmark")
    bench = json.loads(json.dumps(BENCH_JSON))
    traffic = json.loads((BENCH / "traffic" / "propose_b4.json").read_text())
    traffic["batch"] = 8
    (tmp_path / "benchmark" / "traffic" / "propose_b8.json").write_text(json.dumps(traffic))
    (tmp_path / "benchmark" / "limits" / "vgg16.propose_b8.json").write_text(
        (BENCH / "limits" / "resnet50_1080p.propose_b4.json").read_text())
    bench["workloads"].append({"name": "vgg16.propose_b8", "config": "vgg16",
                               "traffic": "propose_b8", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "resnet50_1080p.propose_b4" in m.get("workloads", []):
            m["workloads"].append("vgg16.propose_b8")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("vgg16.propose_b8", root=tmp_path)
    assert cell.traffic["batch"] == 8 and cell.conf["name"] == "vgg16"
    assert {m["name"] for m in cell.end_to_end} == {"propose_img_per_s", "setup_s"}
    assert spec.driver_class(cell).__module__.startswith("_bench_driver")
    after = _tree_digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
