"""Port parity, the entry points (``aznet_tpu_torch/entry.py``, the
counterpart of ``__graft_entry__.py``): the flagship config, the forward
against the reference's on the same converted weights, and the multi-device
dry run over gloo ranks on the CPU, in this process and in a fresh process
with no card. The fresh process starts with the module and runs beside
the other tests; the reference net's init is jitted (the same function,
compiled: run eagerly it takes most of the module's time on the CPU).

Tolerances of the forward (VGG-16 at WIDTH 0.125, float32, on the CPU):
scores 1e-5 (sigmoid probabilities), boxes 1e-3 pixels on the 224x224
image; which proposals are live, exactly.
"""

import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

import __graft_entry__
from aznet_tpu.config import cfg_from_dict as jcfg_from_dict
from aznet_tpu.models import AZNet
from aznet_tpu_torch import entry as tentry
from aznet_tpu_torch.config import cfg_from_dict
from aznet_tpu_torch.utils.convert import params_from_flax

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"MODEL": {"WIDTH": 0.125, "FC_DIM": 64, "COMPUTE_DTYPE": "float32"}}


@pytest.fixture(scope="module", autouse=True)
def fresh_dryrun(tmp_path_factory):
    """A fresh process with no card visible calling ``dryrun_multichip(4)``,
    which launches four gloo ranks on the CPU: started with the module, read
    by :func:`test_dryrun_multichip_in_a_fresh_process`."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    code = ("import torch\nassert not torch.cuda.is_available()\n"
            "from aznet_tpu_torch.entry import dryrun_multichip\ndryrun_multichip(4)\n")
    logs = tmp_path_factory.mktemp("fresh_dryrun")
    with open(logs / "out", "w+") as out, open(logs / "err", "w+") as err:
        proc = subprocess.Popen([sys.executable, "-c", code], cwd=REPO, env=env, stdout=out,
                                stderr=err, text=True)
        yield proc, out, err
        if proc.poll() is None:
            proc.kill()
        proc.wait()


def test_flagship_cfg_equals_reference():
    assert dataclasses.asdict(tentry.flagship_cfg()) == dataclasses.asdict(
        __graft_entry__._flagship_cfg())


def test_entry_forward_matches_reference(monkeypatch):
    """The reference's ``entry()`` at WIDTH 0.125 (its config patched), jitted
    on the CPU, against the port's ``build_entry`` on its converted weights."""
    jcfg = jcfg_from_dict(__graft_entry__._flagship_cfg(), SMALL)
    monkeypatch.setattr(__graft_entry__, "_flagship_cfg", lambda: jcfg)
    init = AZNet.init
    monkeypatch.setattr(AZNet, "init", lambda self, *a: jax.jit(functools.partial(init, self))(*a))
    jfn, (params, images) = __graft_entry__.entry()
    want = [np.asarray(a) for a in jax.jit(jfn)(params, images)]

    cfg = cfg_from_dict(tentry.flagship_cfg(), SMALL)
    fn, (timages,) = tentry.build_entry(
        cfg, "cpu", state_dict=params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    np.testing.assert_array_equal(timages.numpy(), np.asarray(images))
    boxes, scores, valid = (t.numpy() for t in fn(timages))
    assert boxes.shape == (1, 300, 4) and scores.shape == (1, 300) and valid.shape == (1, 300)
    np.testing.assert_array_equal(valid, want[2])
    assert valid.sum() > 0 and np.isfinite(boxes).all()
    np.testing.assert_allclose(scores[valid], want[1][valid], atol=1e-5, rtol=0)
    np.testing.assert_allclose(boxes[valid], want[0][valid], atol=1e-3, rtol=0)


def test_entry_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tentry.entry()


def test_dryrun_multichip_2_over_gloo(capsys):
    tentry.dryrun_multichip(2)
    out = capsys.readouterr().out
    for tag in ("dryrun_multichip(2): mesh={'data': 1, 'model': 2} backend=gloo",
                "dryrun_serving sharded_propose(DP=1)", "dryrun_serving latency_propose",
                "dryrun_serving sharded_detect(DP=1)", "dryrun_multihost: processes=2 devices=4"):
        assert tag in out, out


def test_dryrun_multichip_in_a_fresh_process(fresh_dryrun):
    """A fresh process with no card visible calls ``dryrun_multichip(4)``,
    which launches four gloo ranks on the CPU."""
    proc, out, err = fresh_dryrun
    proc.wait(timeout=900)
    out.seek(0)
    err.seek(0)
    stdout = out.read()
    assert proc.returncode == 0, f"stdout:\n{stdout}\nstderr:\n{err.read()}"
    assert "dryrun_multichip(4): mesh={'data': 2, 'model': 2} backend=gloo" in stdout
    assert "latency_propose(regions over 4 devices)" in stdout
    assert "dryrun_multihost: processes=2 devices=4" in stdout and "OK" in stdout
