"""Whole runs at a CPU test's size: the result line's keys, a run without a
card, the no-JAX rule, the lower-precision control and the faults the check
has to catch (an answer altered where it is produced; half of a batch left
out; the search's division returning its regions unchanged; its top-k
reversed). The program on the card: the ``cuda`` tests."""

import ast
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conftest import BENCH, TINY_SEAR, tiny_cell
from harness import runner, spec, trace as tr
from harness.system import PortSystem, ReferenceSystem, reverse_frontier_top_k

ROOT = BENCH.parent
CELLS = [w["name"] for w in spec.load_bench()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# The faults a traffic mix's driver can have: half of a batch needs a batch
# of two or more, and the search's faults a search.
FAULTS = {"propose_batch": ("altered", "half_batch", "reversed_top_k", "unchanged_state"),
          "detect_batch": ("altered", "half_batch"),
          "im_propose": ("altered", "reversed_top_k", "unchanged_state")}


def run(name, system=PortSystem, seconds=0.0, traced=False, seed=2 ** 31 + 5):
    cell = tiny_cell(name)
    cell.traffic["check_images"] = 8  # every image of the run
    return runner.run_cell(cell, seed, seconds, traced, torch.device("cpu"),
                           time.perf_counter(), system_cls=system)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct_and_the_line_has_its_keys(name):
    r = run(name, seconds=0.5)
    assert list(r) == KEYS + ["checks"]
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) == {m["name"] for m in spec.load_cell(name).end_to_end}
    assert len(r["metrics"]) == 2 and "setup_s" in r["metrics"]
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())


class _NoProfile:
    def __init__(self):
        self.events = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class _NoSpans:
    def __init__(self, modules, sync_out=()):
        self.calls = {name: [] for name in modules}

    def remove(self):
        pass

    def device_ms(self, name):
        return []

    def host(self, name):
        return []


def test_traced_line_has_a_breakdown(monkeypatch):
    monkeypatch.setattr(tr, "Profile", _NoProfile)
    monkeypatch.setattr(tr, "Spans", _NoSpans)
    r = run("resnet50_1080p.propose_b4", traced=True)
    assert list(r) == KEYS + ["breakdown", "checks"]
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(r["device"])


def test_no_card_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "resnet50_1080p.propose_b4",
                        "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                       capture_output=True, text=True, env={"CUDA_VISIBLE_DEVICES": "",
                                                            "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0
    assert not any(line.startswith("{") for line in p.stdout.splitlines())
    assert "CUDA device" in p.stderr


def test_no_jax_after_a_run():
    code = ("import sys, time, torch; sys.path[:0] = ['benchmark/tests', 'benchmark', '.']\n"
            "from conftest import tiny_cell\nfrom harness import runner\n"
            "c = tiny_cell('resnet50_1080p.propose_b4')\n"
            "runner.run_cell(c, 3, 0.0, False, torch.device('cpu'), time.perf_counter())\n"
            "print(runner.jax_modules(), 'aznet_tpu_torch' in sys.modules)")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split()[-2:] == ["[]", "True"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_imports_of_the_harness_and_the_reference():
    banned = {"jax", "jaxlib", "flax", "aznet_tpu", "tools", "tools_torch", "bench", "bench_nms"}
    for path in BENCH.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & banned, (path, tops & banned)
        if "reference" in path.relative_to(BENCH).parts:
            assert "aznet_tpu_torch" not in tops, path
            assert not {"harness", "drivers"} & tops, path
    # The program is imported in one place only.
    users = [p.relative_to(BENCH) for p in BENCH.rglob("*.py")
             if "aznet_tpu_torch" in set(_imports(p)) and "tests" not in p.parts]
    assert [str(p) for p in users] == ["harness/system.py"]
    assert runner.BANNED == ("jax", "jaxlib", "flax", "aznet_tpu")


@pytest.mark.parametrize("name", CELLS)
def test_lower_precision_control_is_not_correct(name):
    r = run(name, system=ReferenceSystem)
    assert not r["correct"], r["checks"]


def _fault_system(kind, monkeypatch=None):
    """The port with one fault planted in what its entries hand back, or
    inside its search."""
    if kind in ("reversed_top_k", "unchanged_state"):
        from aznet_tpu_torch.search import propose

        if kind == "reversed_top_k":
            for name in ("top_k", "level_cuda"):  # undone after the test
                monkeypatch.setattr(propose, name, getattr(propose, name))
            reverse_frontier_top_k(TINY_SEAR["CAND_BUF"])
        else:
            monkeypatch.setattr(propose, "_apply_normalized",
                                lambda regions, table, offset: regions[:, None, :].expand(
                                    -1, table.shape[0], 4))
        return PortSystem

    class Faulty(PortSystem):
        def propose_batch(self, canvas):
            fn = super().propose_batch(canvas)
            if kind == "half_batch":
                def half(images):
                    out = fn(images[: images.shape[0] // 2])
                    return tuple(torch.cat([t, t]) for t in out)
                return half

            def altered(images):
                boxes, scores, valid = fn(images)
                return boxes + torch.tensor([3.0, 0, 0, 0]), scores, valid
            return altered

        def detect_batch(self, canvas):
            fn = super().detect_batch(canvas)
            if kind == "half_batch":
                def half(images, boxes):
                    out = fn(images[: images.shape[0] // 2], boxes[: boxes.shape[0] // 2])
                    return tuple(torch.cat([t, t]) for t in out)
                return half

            def altered(images, boxes):
                scores, pred = fn(images, boxes)
                return scores.roll(1, -1), pred
            return altered

        def im_propose(self, im):
            out = super().im_propose(im).copy()
            out[0, 4] = np.float32(0.5) * out[0, 4]
            return out

    return Faulty


@pytest.mark.parametrize("name,fault", [
    (name, fault) for name in CELLS for fault in FAULTS[spec.load_cell(name).traffic["driver"]]])
def test_a_planted_fault_is_not_correct(name, fault, monkeypatch):
    r = run(name, system=_fault_system(fault, monkeypatch))
    assert not r["correct"], r["checks"]


def test_the_planted_top_k_fault_reaches_the_cards_path():
    """On the card a level is one kernel that sorts the frontier itself: the
    fault puts the level's plain version, which calls ``top_k``, in its
    place, and takes both out again."""
    from aznet_tpu_torch.search import propose

    top_k, level_cuda = propose.top_k, propose.level_cuda
    undo = reverse_frontier_top_k(256)
    try:
        assert propose.level_cuda is propose.level_plain
        assert propose.top_k is not top_k
    finally:
        undo()
    assert propose.top_k is top_k and propose.level_cuda is level_cuda


@pytest.mark.parametrize("planted", [True, False], ids=["planted", "not_planted"])
def test_calibrate_refuses_a_fault_that_reads_correct(planted, monkeypatch, capsys):
    sys.path.insert(0, str(BENCH / "tools"))
    import calibrate
    from harness import system

    cell = tiny_cell("vgg16.im_propose_b1")
    if not planted:  # a fault planted where the program does not run
        monkeypatch.setattr(system, "reverse_frontier_top_k", lambda cand_buf: (lambda: None))
    args = calibrate.parse(["--workload", cell.name, "--fault-seeds", str(2 ** 31 + 9),
                            "--seconds", "0"])
    rc = calibrate.calibrate(cell, args, torch.device("cpu"))
    out, err = capsys.readouterr()
    lines = [json.loads(line) for line in out.splitlines()]
    assert [r["side"] for r in lines] == ["reversed_top_k"]
    assert lines[0]["correct"] is not planted
    assert rc == (0 if planted else 1)
    assert ("reads correct on seed 2147483657" in err) is not planted


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_cell_on_the_card(name, cuda_device):
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed", "97",
                        "--seconds", "2", "--trace", "1"], cwd=ROOT, capture_output=True,
                       text=True)
    assert p.returncode == 0, p.stderr[-3000:]
    r = json.loads(p.stdout.splitlines()[-1])
    assert r["correct"] and r["device"]["platform"] == "gpu", r["checks"]
    assert r["device"]["busy_s"] > 0 and "breakdown" in r
