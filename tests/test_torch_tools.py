"""The port's command-line tools (``tools_torch/``) on the CPU: the cases of
``tests/test_tools.py`` run through each tool's ``main(argv)`` with
``--cpu`` and the same ``SMALL_SET``, the option surface held against the
reference tools' ``--help``, and the options that differ (``--mesh``,
``--debug-nans``, ``--resume``, ``convert_caffe --cpu``); a tool without
``--cpu`` raises where there is no card.
"""

import importlib
import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tools_torch import (convert_caffe, demo, ingest_data, propose_net, test_net, time_net,
                         train_net)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL_SET = [
    "--set", "MODEL.BACKBONE", "smallnet", "MODEL.FC_DIM", "32",
    "MODEL.NUM_TEMPLATES", "5", "MODEL.NUM_CLASSES", "4",
    "MODEL.COMPUTE_DTYPE", "float32",
    "SEAR.FRONTIER_CAP", "16", "SEAR.CAND_BUF", "128",
    "SEAR.MAX_LEVELS", "2", "SEAR.NUM_PROPOSALS", "20",
    "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
    "TRAIN.SCALES", "(64,)", "TRAIN.MAX_SIZE", "96",
    "TRAIN.REGIONS_PER_IMAGE", "16", "TRAIN.USE_FLIPPED", "False",
    "TRAIN.SNAPSHOT_ITERS", "10",
]
# VGG-16 at WIDTH 0.125 (conv channels 8 .. 64): a Caffe-lineage trunk for
# the converter.
VGG_SET = [
    "--set", "MODEL.WIDTH", "0.125", "MODEL.FC_DIM", "32", "MODEL.NUM_TEMPLATES", "5",
    "MODEL.NUM_CLASSES", "4", "MODEL.COMPUTE_DTYPE", "float32",
    "SEAR.FRONTIER_CAP", "16", "SEAR.CAND_BUF", "128", "SEAR.MAX_LEVELS", "2",
    "SEAR.NUM_PROPOSALS", "20", "TEST.SCALES", "(64,)", "TEST.MAX_SIZE", "96",
]
TOOLS = ("train_net", "propose_net", "test_net", "demo", "time_net", "convert_caffe",
         "ingest_data")
# Options of a port tool that its reference counterpart lacks.
ADDED = {"convert_caffe": {"--cpu"}}


def _run(mod, argv, capsys):
    assert mod.main(argv) in (0, None)
    return capsys.readouterr().out


def _options(help_text):
    """The option strings of an argparse ``--help`` screen (its invocation
    lines, indented by two spaces)."""
    opts = set()
    for line in help_text.splitlines():
        if line.startswith("  -"):
            head = re.split(r"\s{2,}", line.strip())[0]
            opts.update(part.split()[0] for part in head.split(", "))
    return opts


def _port_help(name, argv, capsys):
    mod = importlib.import_module(f"tools_torch.{name}")
    with pytest.raises(SystemExit) as e:
        mod.main(argv + ["--help"])
    assert e.value.code == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("name", TOOLS + ("orbax_to_torch",))
def test_help_screens(name, capsys):
    assert "usage" in _port_help(name, [], capsys).lower()


@pytest.mark.parametrize("name,sub", [(t, None) for t in TOOLS] + [
    ("ingest_data", s) for s in ("voc", "coco", "weights", "status")])
def test_option_surface_matches_reference(name, sub, capsys):
    argv = [sub] if sub else []
    ref = subprocess.run([sys.executable, os.path.join(REPO, "tools", f"{name}.py")] + argv
                         + ["--help"], cwd=REPO, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert ref.returncode == 0, ref.stderr[-500:]
    want = _options(ref.stdout)
    got = _options(_port_help(name, argv, capsys))
    assert len(want) > 1 and got == want | ADDED.get(name, set()), (got ^ want)


def test_train_then_recall_chain(tmp_path, capsys):
    out = str(tmp_path / "az")
    text = _run(train_net, ["--cpu", "--net", "az", "--imdb", "synthetic_val", "--iters", "10",
                            "--output", out] + SMALL_SET, capsys)
    assert "done; checkpoints in" in text and "devices: [cpu]" in text
    text = _run(test_net, ["--cpu", "--mode", "recall", "--imdb", "synthetic_val", "--ckpt", out,
                           "--max-images", "2"] + SMALL_SET, capsys)
    assert f"restored step 10 from {out}/deploy" in text
    table = json.loads(text[text.index("{"):])
    assert "300" in table and "AR" in table["300"]


@pytest.mark.parametrize("batched", [False, True])
def test_propose_net_writes_the_reference_pickle(tmp_path, capsys, batched):
    path = str(tmp_path / "props.pkl")
    text = _run(propose_net, ["--cpu", "--imdb", "synthetic_val", "--max-images", "3", "--out",
                              path] + (["--batched", "--batch-size", "2"] if batched else [])
                + SMALL_SET, capsys)
    assert f"wrote 3 proposal arrays to {path}" in text
    with open(path, "rb") as f:
        props = pickle.load(f)
    assert isinstance(props, list) and len(props) == 3
    assert all(p.dtype == np.float32 and p.ndim == 2 and p.shape[1] == 5 for p in props)


def test_demo_runs(tmp_path, capsys):
    text = _run(demo, ["--cpu", "--out", str(tmp_path / "demo.png")] + SMALL_SET, capsys)
    assert "im_propose:" in text and "im_detect:" in text
    assert "planted boxes" in text


def test_time_net_prints_each_stage(capsys):
    text = _run(time_net, ["--cpu", "--batch", "2", "--reps", "1", "--raw-hw", "60", "80",
                           "--canvas", "64", "96"] + SMALL_SET, capsys)
    assert "# device: cpu" in text
    for stage in ("preprocess", "trunk", "search", "end-to-end"):
        assert re.search(rf"^{stage}\s*:\s+[0-9.]+ ms/img\s+\(\s*[0-9.]+ img/s\)$", text,
                         re.M), stage


def test_ingest_data_status_and_voc(tmp_path, capsys, monkeypatch):
    text = _run(ingest_data, ["status"], capsys)
    assert "synthetic_*" in text and "voc_2007" in text
    # Fabricated VOC layout: link + validate + roidb cache.
    src = tmp_path / "VOCdevkit"
    main = src / "VOC2007" / "ImageSets" / "Main"
    for d in (main, src / "VOC2007" / "Annotations", src / "VOC2007" / "JPEGImages"):
        d.mkdir(parents=True)
    (main / "trainval.txt").write_text("")  # empty split: layout-only check
    monkeypatch.setenv("AZNET_DATA_DIR", str(tmp_path / "root"))
    text = _run(ingest_data, ["voc", "--src", str(src), "--year", "2007", "--splits",
                              "trainval"], capsys)
    assert "linked:" in text and "0 images" in text
    bad = tmp_path / "bad"
    bad.mkdir()
    assert ingest_data.main(["coco", "--src", str(bad)]) == 1
    assert "INVALID layout" in capsys.readouterr().out


def test_frcnn_init_trunk_from_stays_shared(tmp_path, capsys):
    """--init-trunk-from: Fast R-CNN trains with the AZ trunk frozen; after
    training the two trunks are byte-identical, so share_trunk loses
    nothing and the fused detect program applies."""
    from aznet_tpu_torch.api import build_az_net, build_frcnn_net, share_trunk, trunks_shared
    from tools_torch import _common

    az_out, fr_out = str(tmp_path / "az"), str(tmp_path / "frcnn")
    _run(train_net, ["--cpu", "--net", "az", "--imdb", "synthetic_val", "--iters", "4",
                     "--output", az_out] + SMALL_SET, capsys)
    text = _run(train_net, ["--cpu", "--net", "frcnn", "--imdb", "synthetic_val", "--iters", "4",
                            "--output", fr_out, "--init-trunk-from", az_out] + SMALL_SET, capsys)
    assert "trunk frozen" in text
    cfg = _common.load_config(None, SMALL_SET[1:])
    az = _common.load_net(build_az_net, cfg, az_out, "cpu")
    fr = _common.load_net(build_frcnn_net, cfg, fr_out, "cpu")
    trunk = [k for k in az.params if k.startswith("trunk.")]
    assert trunk and all(torch.equal(az.params[k], fr.params[k]) for k in trunk)
    head = [k for k in fr.params if k.startswith("head.")]
    start = build_frcnn_net(cfg, device="cpu").params  # the same seeded init
    assert any(not torch.equal(fr.params[k], start[k]) for k in head)
    share_trunk(fr, az)
    assert trunks_shared(az, fr)


def _caffe_arrays(cfg, net="az", seed=0):
    """Random Caffe arrays ``{layer: (W, b)}`` of ``cfg``'s net: a Caffe conv
    ``(out, in, kh, kw)`` and Dense ``(out, in)`` have the port's shapes."""
    from aznet_tpu_torch.api import build_az_net, build_frcnn_net

    params = (build_az_net if net == "az" else build_frcnn_net)(cfg, device="cpu").params
    rng = np.random.RandomState(seed)
    out = {}
    for key, v in params.items():
        if key.endswith(".weight"):
            name = key.split(".")[-2]
            fan_in = int(np.prod(v.shape[1:]))
            w = (rng.standard_normal(tuple(v.shape)) * np.sqrt(2.0 / fan_in)).astype(np.float32)
            b = (rng.standard_normal(v.shape[0]) * 0.01).astype(np.float32)
            out[name] = (w, b)
    return out


def _save_npz(path, caffe):
    np.savez(path, **{f"{k}_W": w for k, (w, _) in caffe.items()},
             **{f"{k}_b": b for k, (_, b) in caffe.items()})


def test_convert_caffe_random_npz(tmp_path, capsys):
    from tools_torch import _common

    cfg = _common.load_config(None, VGG_SET[1:])
    caffe = _caffe_arrays(cfg)
    npz, out = str(tmp_path / "w.npz"), str(tmp_path / "converted")
    _save_npz(npz, caffe)
    text = _run(convert_caffe, ["--npz", npz, "--net", "az", "--out", out, "--cpu"] + VGG_SET,
                capsys)
    assert f"wrote converted az checkpoint to {out}" in text
    params, step, _ = _common.restore_params(out, cfg)
    assert step == 0
    np.testing.assert_array_equal(params["trunk.conv3_2.weight"].numpy(), caffe["conv3_2"][0])
    text = _run(test_net, ["--cpu", "--mode", "recall", "--imdb", "synthetic_val", "--ckpt", out,
                           "--max-images", "2"] + VGG_SET, capsys)
    assert f"restored step 0 from {out}" in text
    # A shape that differs from the net's, then a layer left out, raise.
    bad = dict(caffe, fc7=(caffe["fc7"][0][:, :-1], caffe["fc7"][1]))
    _save_npz(npz, bad)
    with pytest.raises(ValueError, match="head.fc.fc7.weight"):
        convert_caffe.main(["--npz", npz, "--out", out + "2", "--cpu"] + VGG_SET)
    _save_npz(npz, {k: v for k, v in caffe.items() if k != "conv5_3"})
    with pytest.raises(KeyError, match="conv5_3"):
        convert_caffe.main(["--npz", npz, "--out", out + "2", "--cpu"] + VGG_SET)
    _save_npz(npz, {k: v for k, v in caffe.items() if k != "adj_bbox"})
    with pytest.raises(KeyError, match="adj_bbox"):
        convert_caffe.main(["--npz", npz, "--out", out + "2", "--cpu"] + VGG_SET)


def test_ingest_weights_writes_a_trunk_snapshot(tmp_path, capsys):
    from aznet_tpu_torch.utils.checkpoint import Checkpointer
    from tools_torch import _common

    caffe = _caffe_arrays(_common.load_config(None, VGG_SET[1:]))
    npz, out = str(tmp_path / "w.npz"), str(tmp_path / "trunk")
    _save_npz(npz, caffe)
    text = _run(ingest_data, ["weights", "--src", npz, "--arch", "vgg16", "--out", out], capsys)
    assert f"converted {npz} -> {out}" in text
    params = Checkpointer(out).restore({"params": 0})[0]["params"]
    assert len(params) == 26 and all(k.startswith("trunk.") for k in params)


def test_mesh_and_resume_are_rejected(tmp_path):
    # One process is a world of one rank: a mesh of 8 needs a launcher.
    with pytest.raises(ValueError, match="requested 8 devices, have 1"):
        train_net.main(["--cpu", "--mesh", "4x2"] + SMALL_SET)
    with pytest.raises(SystemExit, match="--resume"):
        train_net.main(["--cpu", "--resume", str(tmp_path / "a"), "--output",
                        str(tmp_path / "b")] + SMALL_SET)
    with pytest.raises(SystemExit, match="--frcnn-ckpt"):
        test_net.main(["--cpu", "--mode", "recall", "--refine"] + SMALL_SET)


def test_resume_is_the_output_dir(tmp_path, capsys):
    out = str(tmp_path / "az")
    _run(train_net, ["--cpu", "--iters", "2", "--imdb", "synthetic_val", "--resume", out]
         + SMALL_SET, capsys)
    text = _run(train_net, ["--cpu", "--iters", "3", "--imdb", "synthetic_val", "--resume", out]
                + SMALL_SET, capsys)
    assert "[az] resumed from step 2" in text and f"done; checkpoints in {out}" in text


def test_debug_nans_turns_on_anomaly_detection(monkeypatch, capsys):
    import aznet_tpu_torch.train.loop as loop

    seen = []

    def fake(cfg, imdb, **kw):
        seen.append((torch.is_anomaly_enabled(), torch.is_anomaly_check_nan_enabled()))
        return None, None, "out"

    monkeypatch.setattr(loop, "train_az_net", fake)
    was = torch.is_anomaly_enabled()
    _run(train_net, ["--cpu", "--debug-nans"] + SMALL_SET, capsys)
    _run(train_net, ["--cpu"] + SMALL_SET, capsys)
    assert seen == [(True, True), (was, torch.is_anomaly_check_nan_enabled())]
    assert torch.is_anomaly_enabled() == was


@pytest.mark.parametrize("mod,argv", [
    (train_net, ["--iters", "1"]),
    (propose_net, ["--max-images", "1"]),
    (test_net, ["--max-images", "1"]),
    (demo, []),
    (time_net, ["--batch", "1", "--reps", "1"]),
    (convert_caffe, ["--npz", "NPZ", "--out", "OUT"] + VGG_SET),
])
def test_without_cpu_raises_without_a_card(mod, argv, monkeypatch, tmp_path):
    """No ``--cpu`` and no card: the API raises; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if mod is convert_caffe:
        from tools_torch import _common

        npz = str(tmp_path / "w.npz")
        _save_npz(npz, _caffe_arrays(_common.load_config(None, VGG_SET[1:])))
        argv = [npz if a == "NPZ" else str(tmp_path / "out") if a == "OUT" else a for a in argv]
    else:
        argv = argv + SMALL_SET
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
