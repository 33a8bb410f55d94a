"""Port parity, the tools' chain: the port's tools (``tools_torch/``)
against the JAX package's (``tools/``) from one state, on
``experiments/cfgs/az_smallnet_synthetic.yml`` (the config of
``experiments/scripts/synthetic_end_to_end.sh``) with ``MODEL.DROPOUT 0``
(dropout masks cannot match across the packages) and
``TRAIN.LEARNING_RATE 0.001``.

1. The reference's ``train_net --net az --iters 2``, and
   ``tools_torch/orbax_to_torch.py`` copies its step-2 snapshot
   (parameters, momentum, update count) into the port's output directory.
2. Both ``train_net``s resume to step ``STEPS``. Both prefetch threads
   restart their ``RandomState`` from the seed on resume, so both draw the
   same batches.
3. Both ``propose_net``s; both Fast R-CNN legs start from the reference's
   step-2 snapshot (copied the same way) and train to ``STEPS`` on the
   reference's proposals pickle.
4. Both ``test_net``s: recall, then detection, on the first 4 images.

The reference tools run in this process (``main()`` under a patched
``sys.argv``), the port's through ``main(argv)`` with ``--cpu``. Float32 on
both sides. The bounds leave room for the divergence that float32 rounding
in another reduction order grows over tens of SGD steps: at the config's own
learning rate, 0.005, the port against itself at 1 and 7 threads drifted 8%
apart in loss by step 40 (a chaotic stretch of training), so the chain runs
at 0.001, where the port's Fast R-CNN parameters drift 2e-3 of their update
against themselves across thread counts and 9e-3 against the reference.

- losses and accuracy at the last logged step: relative 1e-3; the gradient
  norm: relative 1e-2;
- each parameter tensor of the ``deploy/`` copies: max |port - reference|
  within 5e-2 of the largest change the reference made to it from step 2;
- the recall table: each cell within one gt match (1 / number of gt boxes);
- mAP and mAP@0.7 within 0.05, each class's AP within 0.1 (a detection
  that crosses a score or NMS threshold moves one class's AP by up to one
  gt's share of it).
"""

import contextlib
import importlib.util
import io
import json
import os
import pickle
import sys

import numpy as np
import pytest
import torch

import jax

from tools_torch import orbax_to_torch, propose_net, test_net, train_net

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = os.path.join(REPO, "experiments", "cfgs", "az_smallnet_synthetic.yml")
SET = ["MODEL.DROPOUT", "0", "TRAIN.SNAPSHOT_ITERS", "20", "TRAIN.LEARNING_RATE", "0.001"]
IMDB, START, STEPS, TEST_IMAGES = "synthetic_val", 2, 40, 4
LOSS_TOL, NORM_TOL, PARAM_TOL, MAP_TOL, AP_TOL = 1e-3, 1e-2, 5e-2, 0.05, 0.1


def _ref(tool, argv):
    """``tools/<tool>.py``'s ``main()`` in this process; its standard output."""
    path = os.path.join(REPO, "tools", f"{tool}.py")
    spec = importlib.util.spec_from_file_location(f"_reference_{tool}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    buf = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(buf):
        mp.setattr(sys, "argv", [path] + argv)
        mod.main()
    return buf.getvalue()


def _port(mod, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    return buf.getvalue()


def _json(text):
    lines = text.splitlines()
    return json.loads("\n".join(lines[max(i for i, x in enumerate(lines) if x == "{"):]))


def _last_log(out_dir, name):
    with open(os.path.join(out_dir, f"{name}_metrics.jsonl")) as f:
        rows = [json.loads(x) for x in f]
    row = rows[-1]
    assert row["step"] == STEPS
    return {k: v for k, v in row.items() if k not in ("step", "t")}


def _flax_params(out_dir, net, step=None):
    """The reference's parameters of its ``deploy/`` copy at ``step`` (default:
    the latest), port-named. (The deploy copy holds the parameters alone;
    both packages bake the bbox normalization into it the same way.)"""
    from aznet_tpu.api import build_az_net, build_frcnn_net
    from aznet_tpu.config import Config, cfg_from_list
    from aznet_tpu.utils.checkpoint import Checkpointer
    from aznet_tpu_torch.utils.convert import params_from_flax

    from aznet_tpu.config import cfg_from_file

    cfg = cfg_from_list(cfg_from_file(Config(), CFG), SET)
    jnet = (build_az_net if net == "az" else build_frcnn_net)(cfg)
    restored, step = Checkpointer(os.path.join(out_dir, "deploy")).restore(
        {"params": jax.device_get(jnet.params)}, step=step)
    return params_from_flax(jax.device_get(restored["params"])), step


def _port_params(out_dir):
    from aznet_tpu_torch.utils.checkpoint import Checkpointer

    restored, step = Checkpointer(os.path.join(out_dir, "deploy")).restore({"params": 0})
    return restored["params"], step


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_chain")
    d = {k: str(root / k) for k in ("ref_az", "port_az", "ref_fr", "port_fr", "ref_eval",
                                    "port_eval")}
    s = ["--cfg", CFG, "--set"] + SET
    out = {}
    # 1-2: AZ-Net, two reference steps, copied, then both to STEPS.
    _ref("train_net", ["--cpu", "--net", "az", "--imdb", IMDB, "--iters", str(START),
                       "--output", d["ref_az"]] + s)
    _port(orbax_to_torch, ["--src", d["ref_az"], "--out", d["port_az"], "--net", "az"] + s)
    _ref("train_net", ["--cpu", "--net", "az", "--imdb", IMDB, "--iters", str(STEPS),
                       "--output", d["ref_az"]] + s)
    out["port_az_log"] = _port(train_net, ["--cpu", "--net", "az", "--imdb", IMDB, "--iters",
                                           str(STEPS), "--output", d["port_az"]] + s)
    # 3: proposals, then Fast R-CNN from two reference steps on the reference's.
    ref_props, port_props = str(root / "ref_props.pkl"), str(root / "port_props.pkl")
    _ref("propose_net", ["--cpu", "--imdb", IMDB, "--ckpt", d["ref_az"], "--out", ref_props]
         + s)
    _port(propose_net, ["--cpu", "--imdb", IMDB, "--ckpt", d["port_az"], "--out", port_props]
          + s)
    out["props"] = []
    for path in (ref_props, port_props):
        with open(path, "rb") as f:
            out["props"].append(pickle.load(f))
    fr = ["--cpu", "--net", "frcnn", "--imdb", IMDB, "--proposals", ref_props]
    _ref("train_net", fr + ["--iters", str(START), "--output", d["ref_fr"]] + s)
    _port(orbax_to_torch, ["--src", d["ref_fr"], "--out", d["port_fr"], "--net", "frcnn"] + s)
    _ref("train_net", fr + ["--iters", str(STEPS), "--output", d["ref_fr"]] + s)
    out["port_fr_log"] = _port(train_net, fr + ["--iters", str(STEPS), "--output",
                                                d["port_fr"]] + s)
    # 4: evaluation.
    ev = ["--cpu", "--imdb", IMDB, "--max-images", str(TEST_IMAGES), "--ckpt"]
    out["recall"] = (_json(_ref("test_net", ["--mode", "recall"] + ev + [d["ref_az"]] + s)),
                     _json(_port(test_net, ["--mode", "recall"] + ev + [d["port_az"]] + s)))
    out["aps"] = (
        _json(_ref("test_net", ["--mode", "detect"] + ev + [d["ref_az"], "--frcnn-ckpt",
                                                             d["ref_fr"], "--output",
                                                             d["ref_eval"]] + s)),
        _json(_port(test_net, ["--mode", "detect"] + ev + [d["port_az"], "--frcnn-ckpt",
                                                            d["port_fr"], "--output",
                                                            d["port_eval"]] + s)))
    out["dirs"] = d
    return out


@pytest.mark.parametrize("net,name", [("az", "az"), ("fr", "frcnn")])
def test_chain_logged_losses(chain, net, name):
    ref = _last_log(chain["dirs"][f"ref_{net}"], name)
    port = _last_log(chain["dirs"][f"port_{net}"], name)
    assert set(ref) == set(port)
    for k, v in ref.items():
        tol = NORM_TOL if k == "grad_norm" else LOSS_TOL
        assert abs(port[k] - v) <= tol * abs(v), (k, port[k], v)


@pytest.mark.parametrize("net,kind", [("az", "az"), ("fr", "frcnn")])
def test_chain_final_params(chain, net, kind):
    ref, step = _flax_params(chain["dirs"][f"ref_{net}"], kind)
    port, port_step = _port_params(chain["dirs"][f"port_{net}"])
    assert step == port_step == STEPS and set(ref) == set(port)
    start = _flax_params(chain["dirs"][f"ref_{net}"], kind, step=START)[0]
    for k, v in ref.items():
        moved = float((v - start[k]).abs().max())
        diff = float((port[k] - v).abs().max())
        assert moved > 0 and diff <= PARAM_TOL * moved, (k, diff, moved)


def test_chain_proposals_format(chain):
    ref, port = chain["props"]
    assert len(ref) == len(port) == 16
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype == np.float32 and a.ndim == b.ndim == 2
        assert a.shape[1] == b.shape[1] == 5 and 0 < b.shape[0] <= 100


def test_chain_recall_table(chain):
    from aznet_tpu_torch.data.imdb import get_imdb

    roidb = get_imdb(IMDB).roidb[:TEST_IMAGES]
    n_gt = sum(int((~e["difficult"]).sum()) for e in roidb)
    ref, port = chain["recall"]
    assert set(ref) == set(port) == {"100", "300", "1000"}
    for k, row in ref.items():
        assert set(row) == set(port[k])
        for t, v in row.items():
            assert abs(port[k][t] - v) <= 1.0 / n_gt + 1e-4, (k, t, port[k][t], v)


def test_chain_detection_map(chain):
    ref, port = chain["aps"]
    assert set(ref) == set(port)
    for k, v in ref.items():
        tol = MAP_TOL if k.startswith("mAP") else AP_TOL
        assert abs(port[k] - v) <= tol, (k, port[k], v)
