"""Each configuration's network is a module of its own,
``reference/networks/<network>.py``, found by name. A network with a head of
convolutions and no fc6 is added by files and entries alone; a network that
is not there stops the cell at load; and what the benchmark reads of today's
cells (the seeded weights, the reference's and the control's outputs, the
FLOPs, the kernels' bounds, the compared numbers) is what it read before the
networks were moved into modules (``pinned_readings.json``)."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import BENCH
from harness import roofline, spec
from reference import nets

ROOT = BENCH.parent
PINS = json.loads((BENCH / "tests" / "pinned_readings.json").read_text())
CELLS = [w["name"] for w in spec.load_bench()["workloads"]]


def _tree_digest(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    """A copy of the checkout's benchmark: ``BENCHMARK.json`` and
    ``benchmark/``."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


# -- a new network, by files and entries ----------------------------------------

# A stand-in for a C4 detector (ResNet's conv5_x on each roi): a stride-16
# trunk of four 3x3/2 convs, then on each 14x14 pool a 3x3/2 conv and a 1x1
# conv with frozen BatchNorm, a global average pool and the output layers.
TINY_C4 = '''
"""A tiny C4 detector: a stride-16 trunk of four 3x3/2 convs with frozen
BatchNorm; on each 14x14 ROI-align pool a 3x3/2 conv and a 1x1 conv with
frozen BatchNorm, a global average pool and the output layers; no fc6."""

import torch.nn.functional as F

from reference import nets

TRUNK = (8, 16, 16, 32)
HEAD = (16, 32)
TINY = {}


def _specs(prefix, name, c_in, c_out, k):
    return [(f"{prefix}.{name}.weight", (c_out, c_in, k, k), "fan_in"),
            *nets.bn_specs(f"{prefix}.{name}_bn", c_out)]


def param_specs(model, kind):
    out, c = [], 3
    for i, ch in enumerate(TRUNK):
        out += _specs("trunk", f"conv{i}", c, ch, 3)
        c = ch
    out += _specs("head.c5", "conv1", c, HEAD[0], 3) + _specs("head.c5", "conv2", HEAD[0], HEAD[1], 1)
    return out + nets.output_specs(kind, model, HEAD[1])


def _block(p, prefix, x, q, k):
    if k == 3:
        x = nets.conv(nets.pad_same(x, 3, 2), p[f"{prefix}.weight"], q=q, stride=2)
    else:
        x = nets.conv(x, p[f"{prefix}.weight"], q=q)
    return F.relu(nets.frozen_bn(p, f"{prefix}_bn", x))


def trunk(model, p, x, q):
    x = x.permute(0, 3, 1, 2)
    for i in range(len(TRUNK)):
        x = _block(p, f"trunk.conv{i}", x, q, 3)
    return x.permute(0, 2, 3, 1)


def head(model, kind, p, pooled, q):
    x = _block(p, "head.c5.conv1", pooled.permute(0, 3, 1, 2), q, 3)
    x = _block(p, "head.c5.conv2", x, q, 1)
    return nets.output_dot(model, kind, p, x.mean((2, 3)), q)


def head_outputs(kind, model):
    return nets.output_layers(kind, model)


def head_input_weights(model, kind):
    return ["head.c5.conv1.weight"]


def trunk_flops(model, canvas):
    (h, w), c, flops = canvas, 3, 0.0
    for ch in TRUNK:
        h, w = -(-h // 2), -(-w // 2)
        flops += 2.0 * h * w * 9 * c * ch
        c = ch
    return flops


def head_flops(model, kind, rows):
    side = -(-model["POOL_SIZE"] // 2)
    conv = 2.0 * side * side * (9 * TRUNK[-1] * HEAD[0] + HEAD[0] * HEAD[1])
    return rows * conv + nets.dense_flops(nets.output_specs(kind, model, HEAD[1]), rows)
'''

# Run inside the copy, on its own harness and reference: the weights of both
# kinds, the reference's heads and search, and step.mfu's FLOPs against
# PyTorch's FLOP counter.
PROBE = textwrap.dedent('''
    import json, sys, types
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    sys.path[:0] = ["benchmark/tests", "benchmark", "."]
    from conftest import tiny_cell
    from harness import check, inputs, roofline, spec
    from reference import nets, search as rs

    def counted(fn):
        with FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops()

    got = {}
    for name, metric in (("tiny_c4.propose_b4", "step.mfu.batch"),
                         ("tiny_c4.detect_given_b8", "step.mfu.detect")):
        cell = tiny_cell(name)
        conf, model = cell.conf, cell.conf["MODEL"]
        kind = spec.driver_class(cell).kind
        p = inputs.make_weights(model, kind, 2 ** 31 + 7, "cpu")
        ref = check.Reference(conf, kind, p, "cpu")
        image = inputs.device_images(5, 1, cell.traffic["image_hw"], "cpu")[0]
        canvas = tuple(conf["canvas"])
        feat, im_scale, vh, vw = ref.features(image, canvas)
        x = torch.zeros(1, *canvas, 3)
        pooled = torch.zeros(5, model["POOL_SIZE"], model["POOL_SIZE"], feat.shape[-1])
        r = {"network": nets.network(model).__file__, "weights": sorted(p),
             "trunk": [counted(lambda: nets.trunk(model, p, x)),
                       roofline.trunk_flops(model, canvas)],
             "head": [counted(lambda: nets.head(model, kind, p, pooled)),
                      roofline.head_flops(model, kind, 5)]}
        if kind == "az":
            found = rs.search(ref.roi_forward, feat, vh, vw, conf["SEAR"], conf["BOX_OFFSET"],
                              cell.limits[check.BAND_KEY])
            r["proposals"] = int(found.valid.sum())
            rows = roofline.propose_rows(conf["SEAR"])
        else:
            rois = torch.from_numpy(inputs.given_boxes(5, 1, 7, cell.traffic["image_hw"], 16,
                                                       (0.5, 2.0))[0])
            out = ref.roi_forward(feat, rois * im_scale)
            r["outputs"] = {k: list(v.shape) for k, v in out.items()}
            rows = cell.traffic["rois"]
        call = types.SimpleNamespace(images=2, ok=True)
        run = types.SimpleNamespace(cell=cell, calls=[call, call], trace={"window": (0, 10 ** 9)},
                                    driver=types.SimpleNamespace(kind=kind, canvas=canvas))
        r["mfu"] = spec.reader(cell.bench_dir, metric)(run)
        r["flops"] = [roofline.trunk_flops(model, canvas), roofline.head_flops(model, kind, rows),
                      roofline.PEAK_OPS["bf16"]]
        got[name] = r
    print(json.dumps(got))
''')


def test_a_network_with_a_conv_head_is_added_by_files_only(tmp_path):
    bench = _copy(tmp_path)
    before = _tree_digest(tmp_path / "benchmark")
    conf = json.loads((BENCH / "configs" / "resnet50_1080p.json").read_text())
    conf.update(name="tiny_c4", canvas=[64, 96])
    conf["MODEL"].update(BACKBONE="tiny_c4", POOL_SIZE=14)
    (tmp_path / "benchmark" / "configs" / "tiny_c4.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark" / "reference" / "networks" / "tiny_c4.py").write_text(TINY_C4)
    bench["configs"].append({"name": "tiny_c4", "source": "https://arxiv.org/abs/1512.03385",
                             "file": "benchmark/configs/tiny_c4.json", "reduced": [],
                             "why": "a test network"})
    for cell, traffic, metric in (("tiny_c4.propose_b4", "propose_b4", "step.mfu.batch"),
                                  ("tiny_c4.detect_given_b8", "detect_given_b8", "step.mfu.detect")):
        bench["workloads"].append({"name": cell, "config": "tiny_c4", "traffic": traffic,
                                   "chips": 1, "why": "a test cell"})
        limits = "resnet50_1080p.propose_b4" if traffic == "propose_b4" else "vgg16.detect_given_b8"
        shutil.copy(BENCH / "limits" / f"{limits}.json",
                    tmp_path / "benchmark" / "limits" / f"{cell}.json")
        for m in bench["per_layer"]:
            if m["name"] == metric:
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    p = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, capture_output=True,
                       text=True, env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert p.returncode == 0, p.stderr[-3000:]
    got = json.loads(p.stdout.splitlines()[-1])
    for name, r in got.items():
        assert r["network"] == str(tmp_path / "benchmark" / "reference" / "networks" / "tiny_c4.py")
        assert not [w for w in r["weights"] if w.startswith("head.fc.")]  # no fc6, no fc7
        assert "head.c5.conv1.weight" in r["weights"]
        for part in ("trunk", "head"):  # PyTorch's count, the network's
            counted, reckoned = r[part]
            assert counted == reckoned > 0, (name, part)
        trunk_f, head_f, peak = r["flops"]
        # step.mfu: the FLOPs an image, 4 images over a window of 1 s.
        assert r["mfu"] == pytest.approx(100.0 * (trunk_f + head_f) * 4 / peak, rel=1e-12)
    assert got["tiny_c4.propose_b4"]["proposals"] > 0
    assert got["tiny_c4.detect_given_b8"]["outputs"] == {"cls_score": [7, 21],
                                                         "bbox_pred": [7, 84]}
    after = _tree_digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_an_unknown_network_stops_the_cell_at_load(tmp_path):
    bench = _copy(tmp_path)
    conf = json.loads((BENCH / "configs" / "vgg16.json").read_text())
    conf["name"] = "nowhere"
    conf["MODEL"]["BACKBONE"] = "no_such_network"
    (tmp_path / "benchmark" / "configs" / "nowhere.json").write_text(json.dumps(conf))
    bench["configs"].append({"name": "nowhere", "source": "https://arxiv.org/abs/1409.1556",
                             "file": "benchmark/configs/nowhere.json", "reduced": [],
                             "why": "a test network"})
    bench["workloads"].append({"name": "nowhere.detect_given_b8", "config": "nowhere",
                               "traffic": "detect_given_b8", "chips": 1, "why": "a test cell"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(FileNotFoundError, match=r"networks/no_such_network\.py"):
        spec.load_cell("nowhere.detect_given_b8", root=tmp_path)
    spec.load_cell("vgg16.detect_given_b8", root=tmp_path)  # the others still load


def test_a_configurations_network_is_its_backbone():
    for name in CELLS:
        model = spec.load_cell(name).conf["MODEL"]
        assert nets.network(model).__file__.endswith(f"networks/{model['BACKBONE']}.py")


# -- what today's cells read has not moved ------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_full_size_flops_and_bounds_are_pinned(name):
    cell, want = spec.load_cell(name), PINS["full"][name]
    model, kind = cell.conf["MODEL"], spec.driver_class(cell).kind
    canvas = tuple(want["canvas"])
    assert roofline.trunk_flops(model, canvas) == want["trunk_flops"]
    assert roofline.head_flops(model, kind, want["rows"]) == want["head_flops"]
    assert roofline.nms_bound_s(roofline.candidates(cell.conf["SEAR"], model["NUM_TEMPLATES"])) \
        == want["nms_bound_s"]
    assert roofline.conv1_bound_s(cell.traffic["batch"], *canvas) == want["conv1_bound_s"]


@pytest.fixture(scope="module")
def tiny_readings():
    """``tools/fingerprint.py --tiny --gaps`` on this checkout at one CPU
    thread, as the pins were read: ``{(cell, seed): readings}``."""
    code = ("import sys, torch; torch.set_num_threads(1); sys.path.insert(0, 'benchmark/tools')\n"
            "import fingerprint; fingerprint.main(sys.argv[1:])")
    seeds = ",".join(str(s) for s in PINS["seeds"])
    p = subprocess.run([sys.executable, "-c", code, "--tiny", "--gaps", "--seeds", seeds],
                       cwd=ROOT, capture_output=True, text=True,
                       env={**os.environ, "OMP_NUM_THREADS": "1", "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode == 0, p.stderr[-3000:]
    return {(r["workload"], r["seed"]): r for r in map(json.loads, p.stdout.splitlines())}


# The tiny readings are float32 outputs compared bit for bit: another build of
# PyTorch, or another CPU's float kernels, may round a convolution otherwise.
PLATFORM = {"torch": PINS["torch"], "cpu_capability": PINS["cpu_capability"]}


def _platform():
    import torch

    return {"torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability()}


@pytest.mark.parametrize("pin", PINS["tiny"], ids=lambda r: f"{r['workload']}-{r['seed']}")
def test_tiny_readings_are_pinned(pin, request):
    """Bit for bit, on the PyTorch build and CPU the pins were read on."""
    if _platform() != PLATFORM:
        pytest.skip(f"the pins were read on {PLATFORM}, this is {_platform()}")
    got = request.getfixturevalue("tiny_readings")[(pin["workload"], pin["seed"])]
    assert got == pin
