"""Each configuration's network is a module of its own,
``reference/networks/<network>.py``, found by name. A network with a head of
convolutions and no fc6, and two cells of it, are added by files and entries
alone, and pass the benchmark's own tests; a network that is not there stops
the cell at load; and what the benchmark reads of each cell (the seeded
weights, the reference's and the control's outputs, the FLOPs, the kernels'
bounds, the compared numbers) is what its pin file,
``tests/pins/<cell>.json``, holds."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from conftest import BENCH, PINS_DIR, pin_path
from harness import roofline, spec
from reference import nets

ROOT = BENCH.parent
CELLS = [w["name"] for w in spec.load_bench()["workloads"]]
PIN_COMMAND = "python3 benchmark/tools/fingerprint.py --workload {} --pin --seeds 5,2147483659"


def _tree_digest(path):
    return {p.relative_to(path): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in path.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    """A copy of the checkout's benchmark: ``BENCHMARK.json`` and
    ``benchmark/``."""
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def _pin(name: str) -> dict:
    path = pin_path(name)
    if not path.exists():
        pytest.fail(f"cell {name} has no pin file {path.relative_to(ROOT)}; write it with "
                    f"`{PIN_COMMAND.format(name)}`", pytrace=False)
    return json.loads(path.read_text())


# -- a new network and its cells, by files and entries -------------------------

# A stand-in for a C4 detector (ResNet's conv5_x on each roi): a stride-16
# trunk of four 3x3/2 convs, then on each 14x14 pool a 3x3/2 conv and a 1x1
# conv with frozen BatchNorm, a global average pool and the output layers.
# The head's convs sit where the port keeps fc6 and fc7 (``head.fc``), and
# its 32 output channels are the configuration's FC_DIM, the width of the
# port's output layers.
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
    out += _specs("head.fc", "conv1", c, HEAD[0], 3) + _specs("head.fc", "conv2", HEAD[0], HEAD[1], 1)
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
    x = _block(p, "head.fc.conv1", pooled.permute(0, 3, 1, 2), q, 3)
    x = _block(p, "head.fc.conv2", x, q, 1)
    return nets.output_dot(model, kind, p, x.mean((2, 3)), q)


def head_outputs(kind, model):
    return nets.output_layers(kind, model)


def head_input_weights(model, kind):
    return ["head.fc.conv1.weight"]


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

# The program's side of the same network, as a change that adds it to
# aznet_tpu_torch would bring it: its trunk under ``BACKBONES["tiny_c4"]``,
# and its head's convs in place of the fc6/fc7 stack, in the compute dtype,
# under the reference's parameter names. The copy's runs load it at
# interpreter start (``sitecustomize``).
PROGRAM_C4 = '''
import torch.nn.functional as F
from torch import nn

from aznet_tpu_torch.models import backbones, heads
from aznet_tpu_torch.models.resnet import FrozenBN
from aznet_tpu_torch.models.small import pad_same

TRUNK, HEAD = (8, 16, 16, 32), (16, 32)


def _layer(module, name, c_in, c_out, k):
    setattr(module, name, nn.Conv2d(c_in, c_out, k, stride=2 if k == 3 else 1, bias=False))
    setattr(module, f"{name}_bn", FrozenBN(c_out))


def _block(module, name, x):
    conv = getattr(module, name)
    if conv.kernel_size[0] == 3:
        x = pad_same(x, 3, 2)
    x = F.conv2d(x, conv.weight.to(x.dtype), stride=conv.stride)
    return F.relu(getattr(module, f"{name}_bn")(x))


class Trunk(nn.Module):
    feat_stride, out_channels = 16, TRUNK[-1]

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        for i, (c_in, c_out) in enumerate(zip((3,) + TRUNK, TRUNK)):
            _layer(self, f"conv{i}", c_in, c_out, 3)

    def forward(self, x):
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for i in range(len(TRUNK)):
            x = _block(self, f"conv{i}", x)
        return x.permute(0, 2, 3, 1)


class C5(nn.Module):
    int8_scales = ()

    def __init__(self, in_dim, fc_dim, fc7_dim=0, int8_scales=(), dropout=0.0, dtype=None):
        super().__init__()
        self.dtype = dtype
        _layer(self, "conv1", TRUNK[-1], HEAD[0], 3)
        _layer(self, "conv2", HEAD[0], HEAD[1], 1)

    def forward(self, pooled, train=False, generator=None):
        x = pooled.to(self.dtype).permute(0, 3, 1, 2)
        return _block(self, "conv2", _block(self, "conv1", x)).mean((2, 3))


backbones.BACKBONES["tiny_c4"] = Trunk
heads.FCStack = C5
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

# The new cells, each with the cell of BENCHMARK.json whose traffic, limits
# file and metrics it takes.
NEW_CELLS = {"tiny_c4.propose_b4": "resnet50_1080p.propose_b4",
             "tiny_c4.detect_given_b8": "vgg16.detect_given_b8"}


def _add_tiny_c4(tmp_path, bench):
    """Add the network, its configuration and its two cells to the copy:
    new files, and entries in ``BENCHMARK.json``."""
    conf = json.loads((BENCH / "configs" / "resnet50_1080p.json").read_text())
    conf.update(name="tiny_c4", canvas=[64, 96])
    conf["MODEL"].update(BACKBONE="tiny_c4", POOL_SIZE=14, FC_DIM=32, FC7_DIM=0)
    (tmp_path / "benchmark" / "configs" / "tiny_c4.json").write_text(json.dumps(conf))
    (tmp_path / "benchmark" / "reference" / "networks" / "tiny_c4.py").write_text(TINY_C4)
    bench["configs"].append({"name": "tiny_c4", "source": "https://arxiv.org/abs/1512.03385",
                             "file": "benchmark/configs/tiny_c4.json", "reduced": [],
                             "why": "a test network"})
    for cell, like in NEW_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny_c4",
                                   "traffic": like.split(".", 1)[1], "chips": 1,
                                   "why": "a test cell"})
        shutil.copy(BENCH / "limits" / f"{like}.json",
                    tmp_path / "benchmark" / "limits" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


# The detect cell's limits at the CPU tests' size, where its limits file
# (VGG-16's) does not separate the fp8 control: cls_gap between the sound
# runs' 0.0033-0.0172 and the control's 0.0406-0.1433 (20 seeds each).
TINY_C4_DETECT_LIMITS = {"cls_gap": 0.027, "box_gap": 0.05}


def test_a_network_and_its_cells_pass_the_benchmarks_tests_by_files_only(tmp_path):
    bench = _copy(tmp_path)
    before = _tree_digest(tmp_path / "benchmark")
    _add_tiny_c4(tmp_path, bench)
    program = tmp_path / "program"
    program.mkdir()
    (program / "sitecustomize.py").write_text(PROGRAM_C4)
    env = {**os.environ, "PYTHONPATH": os.pathsep.join([str(program), str(ROOT)]),
           "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "2"}

    def start(args):
        return subprocess.Popen([sys.executable, *args], cwd=tmp_path, env=env, text=True,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)

    def finish(p):
        out, err = p.communicate(timeout=600)
        return p.returncode, out, err

    # Before their pin files are written, the new cells fail their tests,
    # which name each file and the command that writes it. Beside it, the
    # probe of the copy's reference.
    pytest_args = ["-m", "pytest", "-q", "-rA", "-p", "no:cacheprovider", "-p", "no:randomly",
                   "benchmark/tests", "-k"]
    unpinned, probe = start(pytest_args + ["tiny_c4 and pinned"]), start(["-c", PROBE])
    rc, out, err = finish(unpinned)
    assert rc != 0
    for cell in NEW_CELLS:
        assert f"benchmark/tests/pins/{cell}.json" in out, out[-3000:]
        assert PIN_COMMAND.format(cell) in out, out[-3000:]
    rc, out, err = finish(probe)
    assert rc == 0, err[-3000:]
    got = json.loads(out.splitlines()[-1])
    for name, r in got.items():
        assert r["network"] == str(tmp_path / "benchmark" / "reference" / "networks" / "tiny_c4.py")
        assert not [w for w in r["weights"] if ".fc6." in w or ".fc7." in w]
        assert "head.fc.conv1.weight" in r["weights"]
        for part in ("trunk", "head"):  # PyTorch's count, the network's
            counted, reckoned = r[part]
            assert counted == reckoned > 0, (name, part)
        trunk_f, head_f, peak = r["flops"]
        # step.mfu: the FLOPs an image, 4 images over a window of 1 s.
        assert r["mfu"] == pytest.approx(100.0 * (trunk_f + head_f) * 4 / peak, rel=1e-12)
    assert got["tiny_c4.propose_b4"]["proposals"] > 0
    assert got["tiny_c4.detect_given_b8"]["outputs"] == {"cls_score": [7, 21],
                                                         "bbox_pred": [7, 84]}

    # The pin files, written by the command; the detect cell states its
    # limits at the tests' size in its pin file first, and the command keeps
    # them.
    detect_pin = tmp_path / "benchmark" / "tests" / "pins" / "tiny_c4.detect_given_b8.json"
    detect_pin.write_text(json.dumps({"tiny_limits": TINY_C4_DETECT_LIMITS}))
    for rc, out, err in [finish(start(PIN_COMMAND.format(cell).split()[1:])) for cell in NEW_CELLS]:
        assert rc == 0, err[-3000:]
    assert json.loads(detect_pin.read_text())["tiny_limits"] == TINY_C4_DETECT_LIMITS

    # The copy's own tests of the new cells.
    rc, out, err = finish(start(pytest_args + ["tiny_c4"]))
    assert rc == 0, (out + err)[-6000:]
    passed = {line.split("::", 1)[1] for line in out.splitlines() if line.startswith("PASSED ")}
    for cell in NEW_CELLS:
        assert f"test_full_size_flops_and_bounds_are_pinned[{cell}]" in passed
        for seed in (5, 2147483659):
            assert f"test_tiny_readings_are_pinned[{cell}-{seed}]" in passed
        assert f"test_program_is_correct_and_the_line_has_its_keys[{cell}]" in passed
        assert f"test_lower_precision_control_is_not_correct[{cell}]" in passed
        assert f"test_traced_line_of_a_tiny_cell_reads_the_program_spans[{cell}]" in passed

    after = _tree_digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_pin_files_tiny_limits_are_its_tiny_cells_limits(tmp_path, monkeypatch):
    import conftest

    for name, default in (("vgg16.detect_given_b8", spec.load_cell("vgg16.detect_given_b8").limits),
                          ("vgg16.im_propose_b1", conftest.TINY_PROPOSE_LIMITS)):
        assert conftest.tiny_cell(name).limits == default
        monkeypatch.setattr(conftest, "PINS_DIR", tmp_path)
        pin_path(name).write_text(json.dumps({"tiny_limits": {"cls_gap": 0.5, "zoom_band": 0.3}}))
        assert conftest.tiny_cell(name).limits == {"cls_gap": 0.5, "zoom_band": 0.3}
        monkeypatch.undo()


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


# -- what each cell reads is its pin file's ------------------------------------

def test_every_pin_file_names_a_cell():
    names = {p.stem for p in PINS_DIR.glob("*.json")}
    assert names <= set(CELLS), f"pin files of no cell of BENCHMARK.json: {sorted(names - set(CELLS))}"


@pytest.mark.parametrize("name", CELLS)
def test_full_size_flops_and_bounds_are_pinned(name):
    cell, want = spec.load_cell(name), _pin(name)["full"]
    model, kind = cell.conf["MODEL"], spec.driver_class(cell).kind
    canvas = tuple(want["canvas"])
    assert roofline.trunk_flops(model, canvas) == want["trunk_flops"]
    assert roofline.head_flops(model, kind, want["rows"]) == want["head_flops"]
    assert roofline.nms_bound_s(roofline.candidates(cell.conf["SEAR"], model["NUM_TEMPLATES"])) \
        == want["nms_bound_s"]
    assert roofline.conv1_bound_s(cell.traffic["batch"], *canvas) == want["conv1_bound_s"]


@pytest.fixture(scope="module")
def tiny_readings(request):
    """``tools/fingerprint.py --tiny --gaps`` of a cell on its pin file's
    seeds, on this checkout at one CPU thread, as the pins were read:
    ``read(cell) -> {seed: readings}``. One process a cell whose pins the
    session runs, all started at the first read."""
    code = ("import sys, torch; torch.set_num_threads(1); sys.path.insert(0, 'benchmark/tools')\n"
            "import fingerprint; fingerprint.main(sys.argv[1:])")
    runs = {}

    def start(name):
        seeds = ",".join(str(s) for s in _pin(name)["seeds"])
        return subprocess.Popen([sys.executable, "-c", code, "--workload", name, "--tiny", "--gaps",
                                 "--seeds", seeds], cwd=ROOT, text=True, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, env={**os.environ, "OMP_NUM_THREADS": "1",
                                                             "CUDA_VISIBLE_DEVICES": ""})

    def read(name):
        if not runs:
            runs.update((cell, start(cell)) for cell in dict.fromkeys(
                item.callspec.params["pin"]["workload"] for item in request.session.items
                if item.originalname == "test_tiny_readings_are_pinned"))
        p = runs[name]
        if not isinstance(p, dict):
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-3000:]
            p = runs[name] = {r["seed"]: r for r in map(json.loads, out.splitlines())}
        return p
    return read


def _platform():
    import torch

    return {"torch": torch.__version__, "cpu_capability": torch.backends.cpu.get_cpu_capability()}


def _tiny_pins():
    for name in CELLS:
        if pin_path(name).exists():
            yield from json.loads(pin_path(name).read_text())["tiny"]


@pytest.mark.parametrize("pin", _tiny_pins(), ids=lambda r: f"{r['workload']}-{r['seed']}")
def test_tiny_readings_are_pinned(pin, tiny_readings):
    """Bit for bit, on the PyTorch build and CPU the pins were read on: the
    tiny readings are float32 outputs, and another build of PyTorch, or
    another CPU's float kernels, may round a convolution otherwise."""
    pinned = _pin(pin["workload"])
    platform = {"torch": pinned["torch"], "cpu_capability": pinned["cpu_capability"]}
    if _platform() != platform:
        pytest.skip(f"the pins were read on {platform}, this is {_platform()}")
    assert tiny_readings(pin["workload"])[pin["seed"]] == pin
