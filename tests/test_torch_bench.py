"""Port parity, the measurement tools (``tools_torch/bench*.py``, the
counterparts of ``bench.py``, ``bench_nms.py`` and ``tools/bench_*.py``):

- ``tools_torch/_timing.py::event_time`` against the five cases of
  ``tests/test_bench_timing.py`` (``bench.scan_diff_time``'s contract), with
  a scripted fake timer: no real timing;
- ``tools_torch.bench`` with ``--cpu`` at the smoke preset: its JSON line's
  ``metric`` and ``unit`` equal the reference's (run in a fresh process on
  one CPU device, started with the module so that it runs beside the other
  tests), and the NMS secondary is absent off the card;
- every tool through ``main([..., "--cpu"])`` at a small size;
- each tool's options against the reference tool's ``--help``: the
  reference's options all there, ``--cpu`` the only one added.

Times here are host-clock times on the CPU and are checked only for being
finite and positive.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from aznet_tpu_torch import api
from aznet_tpu_torch.utils.checkpoint import Checkpointer
from tools_torch import (bench, bench_coco_eval, bench_fused_detect, bench_nms,
                         bench_nms_variants, bench_roi, bench_train, bench_trunk)
from tools_torch._common import load_config
from tools_torch._timing import event_time

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_CFG = "experiments/cfgs/az_smallnet_synthetic.yml"


def _timer(per_trial):
    """A fake ``timer(run, reps)``: the scripted per-call seconds of each
    trial in order, times ``reps``."""
    it = iter(per_trial)
    return lambda run, reps: next(it) * reps


def _noop():
    pass


# The five cases of tests/test_bench_timing.py, as per-call seconds of each
# trial (the reference's (hi - lo) / steps estimates).
@pytest.mark.parametrize("trials,want,contended", [
    ([0.010] * 3, 0.010, False),                                 # clean: the median, no retry
    ([0.010, 0.260, 0.010] + [0.010] * 3, 0.010, True),         # one stall, then clean
    ([0.010, 0.040, 0.040] * 3, 0.010, True),                   # persistent: the minimum
    ([-0.1025] * 9, float("nan"), True),                        # no positive estimate: nan
    ([-0.0275, 0.010, 0.010] * 3, 0.010, True),                 # a negative one is rejected
])
def test_event_time_contract(trials, want, contended):
    t = event_time(_noop, reps=4, trials=3, retries=2, timer=_timer(trials))
    assert t.contended is contended
    if np.isnan(want):
        assert np.isnan(t.seconds)
    else:
        assert t.seconds > 0
        np.testing.assert_allclose(t.seconds, want, rtol=1e-9)
    assert len(t.trials) == 3


def test_event_time_warms_up_twice():
    calls = []
    event_time(lambda: calls.append(1), reps=5, timer=_timer([0.01] * 3))
    assert len(calls) == 2  # the fake timer makes no calls of its own


def _last_json(text):
    return json.loads([line for line in text.splitlines() if line.startswith("{")][-1])


@pytest.fixture(scope="module", autouse=True)
def reference_smoke(tmp_path_factory):
    """The reference's ``bench.py`` at the smoke preset in a fresh process on
    one CPU device: started with the module, read by
    :func:`test_bench_smoke_line_matches_reference` (the module's last
    test)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", AZNET_BENCH_PRESET="smoke")
    env.pop("AZNET_BENCH_BATCH", None)
    env["XLA_FLAGS"] = " ".join(f for f in env.get("XLA_FLAGS", "").split()
                                if "xla_force_host_platform_device_count" not in f)
    code = "import jax\njax.config.update('jax_platforms', 'cpu')\nimport bench\nbench.main()\n"
    logs = tmp_path_factory.mktemp("reference_smoke")
    with open(logs / "out", "w+") as out, open(logs / "err", "w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=out,
                                stderr=err, text=True)
        yield proc, out, err
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def test_bench_presets_match_reference():
    """The presets' configurations and shapes are ``bench.py::_build``'s."""
    import bench as jbench

    src = open(jbench.__file__).read()
    for preset, raw_hw, canvas in (("smoke", (96, 128), (64, 128)),
                                   ("coco_deep", (480, 640), (608, 800)),
                                   ("resnet50_1080p", (1080, 1920), (1088, 1920)),
                                   ("full", (375, 500), (608, 800))):
        cfg, got_raw, got_canvas = bench.preset_config(preset)
        assert (got_raw, got_canvas) == (raw_hw, canvas)
        assert f"raw_hw = {raw_hw}" in src and f"canvas = {canvas}" in src
    sear = bench.preset_config("coco_deep")[0].SEAR
    assert (sear.MAX_LEVELS, sear.MIN_SIZE, sear.FRONTIER_CAP, sear.CAND_BUF,
            sear.NUM_PROPOSALS) == (8, 8.0, 128, 4096, 1000)
    cfg = bench.preset_config("resnet50_1080p")[0]
    assert cfg.MODEL.BACKBONE == "resnet50" and cfg.TEST.SCALES == (1080,)
    assert bench.default_batches("full", 1) == [16, 32]
    assert bench.default_batches("resnet50_1080p", 2) == [8]
    with pytest.raises(ValueError, match="unknown"):
        bench.preset_config("tiny")


def test_bench_nms_cpu_tiers(capsys):
    assert bench_nms.main(["--cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["metric"] == "nms_mboxes_per_sec" and out["unit"] == "Mboxes/s"
    assert set(out["detail"]) == {"plain_fixpoint_n4096", "cpp_host_n8192"}  # no card tier
    assert all(np.isfinite(v) and v > 0 for v in out["detail"].values())
    assert out["value"] == max(out["detail"].values())


@pytest.mark.parametrize("tool,argv,key", [
    (bench_trunk, ["--batch", "1", "--hw", "32", "32", "--reps", "1", "2", "--trials", "1",
                   "--variants", "bf16,chain,chain_ext,strip,xla_int8"], "results"),
    (bench_roi, ["--b", "2", "--r", "8", "--hw", "10", "12", "--c", "16", "--reps", "1", "2",
                 "--trials", "1"], "results"),
    (bench_nms_variants, ["--batch", "2", "--n", "200", "--reps", "1", "2", "--trials", "1"],
     "results"),
    (bench_train, ["--smoke", "--steps", "1", "2"], "value"),
    (bench_train, ["--smoke", "--net", "frcnn", "--steps", "1", "2"], "value"),
])
def test_tool_runs_on_cpu(tool, argv, key, capsys):
    assert tool.main(argv + ["--cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["device"] == "cpu"
    vals = ([r["trials_ms"][0] for r in out[key].values()] if key == "results" else [out[key]])
    assert all(np.isfinite(v) and v > 0 for v in vals)
    if tool is bench_trunk:
        assert set(out["results"]) == {"bf16", "chain", "chain_ext", "strip", "xla_int8"}
    if tool is bench_train:
        assert "mfu_vs_bf16_peak" not in out and out["step_tflops"] > 0  # no MFU off the card


def test_bench_coco_eval_tiers_agree(capsys):
    assert bench_coco_eval.main(["--images", "40", "--cpu"]) == 0
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert [d["tier"] for d in lines] == ["native", "numpy"]
    assert {k: v for k, v in lines[0].items() if k not in ("tier", "wall_s", "dets_per_s")} == \
        {k: v for k, v in lines[1].items() if k not in ("tier", "wall_s", "dets_per_s")}


def test_bench_fused_detect_on_seeded_snapshots(tmp_path, capsys):
    cfg = load_config(SMALL_CFG)
    for kind, build, seed in (("az", api.build_az_net, None), ("frcnn", api.build_frcnn_net, 1)):
        Checkpointer(str(tmp_path / kind)).save(0, {"params": build(cfg, device="cpu",
                                                                    seed=seed).params})
    assert bench_fused_detect.main([
        "--imdb", "synthetic_test", "--cfg", os.path.join(REPO, SMALL_CFG),
        "--ckpt", str(tmp_path / "az"), "--frcnn-ckpt", str(tmp_path / "frcnn"),
        "--batch-size", "2", "--max-images", "4", "--cpu"]) == 0
    out = _last_json(capsys.readouterr().out)
    assert out["identical"] is True and out["map_fused"] == out["map_unfused"]
    assert out["unmatched"] == 0.0
    assert out["trunks_value_equal"] is False and "map_note" in out
    assert out["fused_img_per_sec"] > 0 and out["unfused_img_per_sec"] > 0


def test_unmatched_share():
    """Rows within 1e-2 in score and 1 px match; a row moved 2 px, or whose
    score moved 0.02, has no counterpart, on either side."""
    a = np.array([[0, 0, 10, 10, 0.9], [5, 5, 20, 20, 0.5]], np.float32)
    near = a + np.array([1.0, -1.0, 0.5, 0, 0.01], np.float32)
    moved, rescored = a.copy(), a.copy()
    moved[1, 2] += 2.0
    rescored[0, 4] -= 0.02
    empty = np.zeros((0, 5), np.float32)
    for b, want in ((near, 0.0), (moved, 2 / 4), (rescored, 2 / 4)):
        assert bench_fused_detect.unmatched_share([[empty], [a]], [[empty], [b]]) == want
    assert bench_fused_detect.unmatched_share([[empty], [a], [a]], [[empty], [a], [empty]]) == 2 / 6


def _options(help_text):
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", help_text)) - {"--help"}


@pytest.mark.parametrize("name,tool", [
    ("bench_trunk", bench_trunk), ("bench_roi", bench_roi),
    ("bench_nms_variants", bench_nms_variants), ("bench_fused_detect", bench_fused_detect),
    ("bench_train", bench_train), ("bench_coco_eval", bench_coco_eval),
    ("bench", bench), ("bench_nms", bench_nms),
])
def test_options_match_reference(name, tool, capsys):
    ref = os.path.join(REPO, f"{name}.py" if name in ("bench", "bench_nms") else f"tools/{name}.py")
    if name == "bench":
        want = set()  # bench.py takes no options: its knobs are environment variables
    elif name == "bench_nms":
        want = {"--cpu"} if '"--cpu" in sys.argv' in open(ref).read() else set()
    else:
        proc = subprocess.run([sys.executable, ref, "--help"], cwd=REPO, capture_output=True,
                              text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        want = _options(proc.stdout)
    with pytest.raises(SystemExit) as exc:
        tool.main(["--help"])
    assert exc.value.code == 0
    got = _options(capsys.readouterr().out)
    assert want <= got, f"{name}: missing {sorted(want - got)}"
    assert got - want <= {"--cpu"}, f"{name}: added {sorted(got - want - {'--cpu'})}"


def test_bench_smoke_line_matches_reference(reference_smoke, monkeypatch, capsys):
    monkeypatch.setenv("AZNET_BENCH_PRESET", "smoke")
    monkeypatch.delenv("AZNET_BENCH_BATCH", raising=False)
    assert bench.main(["--cpu"]) == 0
    got = _last_json(capsys.readouterr().out)
    proc, out, err = reference_smoke
    proc.wait(timeout=600)
    out.seek(0)
    err.seek(0)
    assert proc.returncode == 0, err.read()[-2000:]
    want = _last_json(out.read())
    assert (got["metric"], got["unit"]) == (want["metric"], want["unit"])
    assert got["metric"] == "propose_images_per_sec_smoke"
    assert np.isfinite(got["value"]) and got["value"] > 0
    assert got["device"] == "cpu" and list(got["batches"]) == ["2"]
    assert "nms_mboxes_per_sec" not in got and "nms_mboxes_per_sec" not in want
    assert "vs_baseline" not in got
