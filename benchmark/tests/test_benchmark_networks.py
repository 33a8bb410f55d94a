"""Each configuration's network is a module of its own,
``reference/networks/<network>.py``, found by name. A network with a head of
convolutions and no fc6, and two cells of it, and a network whose features
are a pyramid, which pools each box from its own level, and a cell of it,
are added by files and entries alone, and pass the benchmark's own tests; a
network that is not there stops the cell at load; and what the benchmark
reads of each cell (the seeded weights, the reference's and the control's
outputs, the FLOPs, the kernels' bounds, the compared numbers) is what its
pin file, ``tests/pins/<cell>.json``, holds."""

import hashlib
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

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
# marked as the port marks ResNet-101's (``conv5_head``), so that its heads
# take the head's convs, in the compute dtype, in the place of the port's
# conv5_x stack, under the reference's parameter names. The copy's runs
# load it at interpreter start (``sitecustomize``).
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
    conv5_head = True

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
    out_dim = HEAD[-1]

    def __init__(self, in_channels, dtype=None):
        super().__init__()
        self.dtype = dtype
        _layer(self, "conv1", TRUNK[-1], HEAD[0], 3)
        _layer(self, "conv2", HEAD[0], HEAD[1], 1)

    def forward(self, pooled, train=False, generator=None):
        x = pooled.to(self.dtype).permute(0, 3, 1, 2)
        return _block(self, "conv2", _block(self, "conv1", x)).mean((2, 3))


backbones.BACKBONES["tiny_c4"] = Trunk
heads.Conv5Stack = C5
'''

# A stand-in for an FPN detector (Lin et al., arXiv:1612.03144), whose
# features are a pyramid of three levels: a bottom-up trunk of five 3x3/2
# convs, 1x1 laterals, the top-down pathway and 3x3 output convs; each box
# pooled from one level by FPN's eq. 1; fc6, fc7 and the output layers.
TINY_FPN = '''
"""A tiny FPN detector (Lin et al., arXiv:1612.03144): a bottom-up trunk of
five 3x3/2 convs with frozen BatchNorm, whose last three outputs are C3 to
C5 (strides 8, 16, 32); 1x1 lateral convs to 16 channels, the top-down
pathway (a nearest-neighbour upsample to the finer level and an add) and a
3x3 output conv on each level: the pyramid P3, P4, P5, finest first. Each
box pools from the level of FPN's eq. 1, k = floor(4 + log2(sqrt(wh) /
CANONICAL)) clamped to 3..5, with the canonical 224 px at an 800 px short
side scaled to the tests' 64; the head is fc6, fc7 and the output layers
(``nets.fc_head``)."""

import torch
import torch.nn.functional as F

from reference import nets

TRUNK = (8, 16, 16, 32, 32)  # strides 2 to 32
LEVELS = (3, 4, 5)  # P3 to P5: the last three trunk outputs, at 2 ** k
WIDTH = 16
CANONICAL = 224.0 * 64 / 800
TINY = {}


def _c(k):
    return TRUNK[len(TRUNK) - len(LEVELS) + k - LEVELS[0]]


def param_specs(model, kind):
    out, c = [], 3
    for i, ch in enumerate(TRUNK):
        out += [(f"trunk.conv{i}.weight", (ch, c, 3, 3), "fan_in"),
                *nets.bn_specs(f"trunk.conv{i}_bn", ch)]
        c = ch
    for k in LEVELS:
        out += [(f"trunk.fpn_lateral{k}.weight", (WIDTH, _c(k), 1, 1), "fan_in"),
                (f"trunk.fpn_lateral{k}.bias", (WIDTH,), "bias"),
                (f"trunk.fpn_output{k}.weight", (WIDTH, WIDTH, 3, 3), "fan_in"),
                (f"trunk.fpn_output{k}.bias", (WIDTH,), "bias")]
    return out + nets.fc_head_specs(model, kind, WIDTH)


def trunk(model, p, x, q):
    x, outs = x.permute(0, 3, 1, 2), []
    for i in range(len(TRUNK)):
        x = nets.conv(nets.pad_same(x, 3, 2), p[f"trunk.conv{i}.weight"], q=q, stride=2)
        x = F.relu(nets.frozen_bn(p, f"trunk.conv{i}_bn", x))
        outs.append(x)
    top, pyramid = None, []
    for k, c in zip(reversed(LEVELS), reversed(outs)):
        lat = nets.conv(c, p[f"trunk.fpn_lateral{k}.weight"], p[f"trunk.fpn_lateral{k}.bias"], q)
        top = lat if top is None else lat + F.interpolate(top, size=lat.shape[-2:], mode="nearest")
        pyramid.insert(0, nets.conv(top, p[f"trunk.fpn_output{k}.weight"],
                                    p[f"trunk.fpn_output{k}.bias"], q, padding=1))
    return tuple(y.permute(0, 2, 3, 1) for y in pyramid)


def box_levels(rois):
    """Each box's level index (0 for P3), by FPN's eq. 1."""
    side = ((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])).clamp(min=0.0).sqrt()
    k = torch.floor(4 + torch.log2(side / CANONICAL + 1e-8)).clamp(LEVELS[0], LEVELS[-1])
    return (k - LEVELS[0]).long()


def pool(model, feat, rois, q):
    """Every box pooled at every level, each kept at its own."""
    pooled = torch.stack([nets.roi_align(level, rois, 2 ** k, model["POOL_SIZE"])
                          for level, k in zip(nets.each_level(q, feat), LEVELS)])
    return pooled[box_levels(rois), torch.arange(rois.shape[0], device=rois.device)]


head = nets.fc_head


def head_outputs(kind, model):
    return nets.output_layers(kind, model)


def head_input_weights(model, kind):
    return nets.FC_HEAD_INPUT


def trunk_flops(model, canvas):
    (h, w), c, flops, sizes = canvas, 3, 0.0, []
    for ch in TRUNK:
        h, w = -(-h // 2), -(-w // 2)
        flops += 2.0 * h * w * 9 * c * ch
        sizes.append(h * w)
        c = ch
    for k in LEVELS:
        hw = sizes[len(TRUNK) - len(LEVELS) + k - LEVELS[0]]
        flops += 2.0 * hw * (_c(k) * WIDTH + 9 * WIDTH * WIDTH)
    return flops


def head_flops(model, kind, rows):
    return nets.dense_flops(param_specs(model, kind), rows)
'''

# The program's side of the FPN network, as a change that adds it to
# aznet_tpu_torch would bring it: its trunk under ``BACKBONES["tiny_fpn"]``,
# returning the levels ``[B, h, w, C]`` finest first; the detect entry's
# head loop handed each image's levels; the port's ``roi_pool`` on each
# level, each box kept at its level, where ``roi_pool_only`` gets levels.
PROGRAM_FPN = '''
import torch
import torch.nn.functional as F
from torch import nn

from aznet_tpu_torch import api
from aznet_tpu_torch.models import aznet, backbones
from aznet_tpu_torch.models.resnet import FrozenBN
from aznet_tpu_torch.models.small import pad_same
from aznet_tpu_torch.ops.roi_pool import roi_pool

TRUNK, LEVELS, WIDTH = (8, 16, 16, 32, 32), (3, 4, 5), 16
CANONICAL = 224.0 * 64 / 800


class Trunk(nn.Module):
    feat_stride, out_channels = 16, WIDTH

    def __init__(self, dtype=None):
        super().__init__()
        self.dtype = dtype
        for i, (c_in, c_out) in enumerate(zip((3,) + TRUNK, TRUNK)):
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c_out, 3, stride=2, bias=False))
            setattr(self, f"conv{i}_bn", FrozenBN(c_out))
        for k, c in zip(LEVELS, TRUNK[-len(LEVELS):]):
            setattr(self, f"fpn_lateral{k}", nn.Conv2d(c, WIDTH, 1))
            setattr(self, f"fpn_output{k}", nn.Conv2d(WIDTH, WIDTH, 3, padding=1))

    def _conv(self, name, x, **kw):
        conv = getattr(self, name)
        return F.conv2d(x, conv.weight.to(x.dtype), conv.bias.to(x.dtype), **kw)

    def forward(self, x):
        x, outs = x.to(self.dtype).permute(0, 3, 1, 2), []
        for i in range(len(TRUNK)):
            x = F.conv2d(pad_same(x, 3, 2), getattr(self, f"conv{i}").weight.to(x.dtype), stride=2)
            x = F.relu(getattr(self, f"conv{i}_bn")(x))
            outs.append(x)
        top, pyramid = None, []
        for k, c in zip(reversed(LEVELS), reversed(outs)):
            lat = self._conv(f"fpn_lateral{k}", c)
            top = lat if top is None else lat + F.interpolate(top, size=lat.shape[-2:],
                                                              mode="nearest")
            pyramid.insert(0, self._conv(f"fpn_output{k}", top, padding=1))
        return tuple(y.permute(0, 2, 3, 1) for y in pyramid)


_roi_pool_only = aznet.RoiNet.roi_pool_only


def roi_pool_only(self, feat, rois):
    if isinstance(feat, torch.Tensor):
        return _roi_pool_only(self, feat, rois)
    mc = self.model_cfg
    side = ((rois[:, 2] - rois[:, 0]) * (rois[:, 3] - rois[:, 1])).clamp(min=0.0).sqrt()
    k = torch.floor(4 + torch.log2(side / CANONICAL + 1e-8)).clamp(LEVELS[0], LEVELS[-1])
    pooled = torch.stack([roi_pool(level, rois, 1.0 / 2 ** j, mc.POOL_SIZE, mode=mc.POOLING_MODE)
                          for level, j in zip(feat, LEVELS)])
    return pooled[(k - LEVELS[0]).long(), torch.arange(rois.shape[0], device=rois.device)]


_detect_heads = api._detect_heads


def detect_heads(model, cfg, feats, *args):
    if not isinstance(feats, torch.Tensor):
        feats = [tuple(level[i] for level in feats) for i in range(feats[0].shape[0])]
    return _detect_heads(model, cfg, feats, *args)


backbones.BACKBONES["tiny_fpn"] = Trunk
aznet.RoiNet.roi_pool_only = roi_pool_only
api._detect_heads = detect_heads
'''

# Run inside the copy, on its own harness and reference, for each cell named
# on the command line: the weights of its kind, the reference's features,
# heads and search, and step.mfu's FLOPs against PyTorch's FLOP counter.
PROBE = textwrap.dedent("""
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
    for name in sys.argv[1:]:
        cell = tiny_cell(name)
        conf, model = cell.conf, cell.conf["MODEL"]
        kind = spec.driver_class(cell).kind
        p = inputs.make_weights(model, kind, 2 ** 31 + 7, "cpu")
        ref = check.Reference(conf, kind, p, "cpu")
        image = inputs.device_images(5, 1, cell.traffic["image_hw"], "cpu")[0]
        canvas = tuple(conf["canvas"])
        feat, im_scale, vh, vw = ref.features(image, canvas)
        x = torch.zeros(1, *canvas, 3)
        pooled = torch.zeros(5, model["POOL_SIZE"], model["POOL_SIZE"], nets.channels(feat))
        r = {"network": nets.network(model).__file__, "weights": sorted(p),
             "levels": [list(level.shape) for level in nets.levels(feat)],
             "trunk": [counted(lambda: nets.trunk(model, p, x)),
                       roofline.trunk_flops(model, canvas)],
             "head": [counted(lambda: nets.head(model, kind, p, pooled)),
                      roofline.head_flops(model, kind, 5)]}
        if kind == "az":
            found = rs.search(ref.roi_forward, feat, vh, vw, conf["SEAR"], conf["BOX_OFFSET"],
                              cell.limits[check.BAND_KEY])
            r["proposals"] = int(found.valid.sum())
            rows, metric = roofline.propose_rows(conf["SEAR"]), "step.mfu.batch"
        else:
            rois = torch.from_numpy(inputs.given_boxes(5, 1, 7, cell.traffic["image_hw"], 16,
                                                       (0.5, 2.0))[0])
            out = ref.roi_forward(feat, rois * im_scale)
            r["outputs"] = {k: list(v.shape) for k, v in out.items()}
            rows, metric = cell.traffic["rois"], "step.mfu.detect"
        call = types.SimpleNamespace(images=2, ok=True)
        run = types.SimpleNamespace(cell=cell, calls=[call, call], trace={"window": (0, 10 ** 9)},
                                    driver=types.SimpleNamespace(kind=kind, canvas=canvas))
        r["mfu"] = spec.reader(cell.bench_dir, metric)(run)
        r["flops"] = [roofline.trunk_flops(model, canvas), roofline.head_flops(model, kind, rows),
                      roofline.PEAK_OPS["bf16"]]
        got[name] = r
    print(json.dumps(got))
""")

# The new networks: the reference's module, the program's side, the
# configuration of BENCHMARK.json whose file each one's starts from, the
# MODEL settings it changes there, its source.
NEW_NETWORKS = {
    "tiny_c4": (TINY_C4, PROGRAM_C4, "resnet50_1080p", {"POOL_SIZE": 14},
                "https://arxiv.org/abs/1512.03385"),
    "tiny_fpn": (TINY_FPN, PROGRAM_FPN, "vgg16", {"POOL_SIZE": 7},
                 "https://arxiv.org/abs/1612.03144"),
}
# The new cells, each with the cell of BENCHMARK.json whose traffic, limits
# file and metrics it takes.
NEW_CELLS = {"tiny_c4.propose_b4": "resnet50_1080p.propose_b4",
             "tiny_c4.detect_given_b8": "vgg16.detect_given_b8",
             "tiny_fpn.detect_given_b8": "vgg16.detect_given_b8"}


def _add_networks(tmp_path, bench):
    """Add the networks, their configurations and their cells to the copy:
    new files, and entries in ``BENCHMARK.json``."""
    for name, (reference, _, like, model, source) in NEW_NETWORKS.items():
        conf = json.loads((BENCH / "configs" / f"{like}.json").read_text())
        conf.update(name=name, source=source, canvas=[64, 96])
        conf["MODEL"].update(BACKBONE=name, FC_DIM=32, FC7_DIM=0, **model)
        (tmp_path / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(conf))
        (tmp_path / "benchmark" / "reference" / "networks" / f"{name}.py").write_text(reference)
        bench["configs"].append({"name": name, "source": source,
                                 "file": f"benchmark/configs/{name}.json", "reduced": [],
                                 "why": "a test network"})
    for cell, like in NEW_CELLS.items():
        bench["workloads"].append({"name": cell, "config": cell.split(".", 1)[0],
                                   "traffic": like.split(".", 1)[1], "chips": 1,
                                   "why": "a test cell"})
        shutil.copy(BENCH / "limits" / f"{like}.json",
                    tmp_path / "benchmark" / "limits" / f"{cell}.json")
        for m in bench["end_to_end"] + bench["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))


# The detect cells' limits at the CPU tests' size, where their limits file
# (VGG-16's) does not separate the fp8 control: cls_gap between the sound
# runs' 0.0033-0.0172 and the control's 0.0406-0.1433 for tiny_c4 (20 seeds
# each), 0.0052-0.0148 and 0.0614-0.1717 for tiny_fpn (24 seeds each).
TINY_DETECT_LIMITS = {"tiny_c4.detect_given_b8": {"cls_gap": 0.027, "box_gap": 0.05},
                      "tiny_fpn.detect_given_b8": {"cls_gap": 0.03, "box_gap": 0.05}}


def test_a_network_and_its_cells_pass_the_benchmarks_tests_by_files_only(tmp_path):
    bench = _copy(tmp_path)
    before = _tree_digest(tmp_path / "benchmark")
    _add_networks(tmp_path, bench)
    program = tmp_path / "program"
    program.mkdir()
    for name, (_, side, _, _, _) in NEW_NETWORKS.items():
        (program / f"program_{name}.py").write_text(side)
    (program / "sitecustomize.py").write_text(
        "".join(f"import program_{name}\n" for name in NEW_NETWORKS))
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
    networks = " or ".join(NEW_NETWORKS)
    unpinned = start(pytest_args + [f"({networks}) and pinned"])
    probe = start(["-c", PROBE, *NEW_CELLS])
    rc, out, err = finish(unpinned)
    assert rc != 0
    for cell in NEW_CELLS:
        assert f"benchmark/tests/pins/{cell}.json" in out, out[-3000:]
        assert PIN_COMMAND.format(cell) in out, out[-3000:]
    rc, out, err = finish(probe)
    assert rc == 0, err[-3000:]
    got = json.loads(out.splitlines()[-1])
    assert set(got) == set(NEW_CELLS)
    for name, r in got.items():
        network = name.split(".", 1)[0]
        assert r["network"] == str(tmp_path / "benchmark" / "reference" / "networks"
                                   / f"{network}.py")
        for part in ("trunk", "head"):  # PyTorch's count, the network's
            counted, reckoned = r[part]
            assert counted == reckoned > 0, (name, part)
        trunk_f, head_f, peak = r["flops"]
        # step.mfu: the FLOPs an image, 4 images over a window of 1 s.
        assert r["mfu"] == pytest.approx(100.0 * (trunk_f + head_f) * 4 / peak, rel=1e-12)
        if network == "tiny_c4":  # one map, and a head of convs with no fc6
            assert r["levels"] == [[4, 6, 32]]
            assert not [w for w in r["weights"] if ".fc6." in w or ".fc7." in w]
            assert "head.fc.conv1.weight" in r["weights"]
        else:  # a pyramid of three levels, finest first, and fc6 on each box's pool
            assert r["levels"] == [[8, 12, 16], [4, 6, 16], [2, 3, 16]]
            assert {"trunk.fpn_lateral3.weight", "head.fc.fc6.weight"} <= set(r["weights"])
    assert got["tiny_c4.propose_b4"]["proposals"] > 0
    for name in ("tiny_c4.detect_given_b8", "tiny_fpn.detect_given_b8"):
        assert got[name]["outputs"] == {"cls_score": [7, 21], "bbox_pred": [7, 84]}

    # The pin files, written by the command; a detect cell states its limits
    # at the tests' size in its pin file first, and the command keeps them.
    pins = tmp_path / "benchmark" / "tests" / "pins"
    for cell, limits in TINY_DETECT_LIMITS.items():
        (pins / f"{cell}.json").write_text(json.dumps({"tiny_limits": limits}))
    for rc, out, err in [finish(start(PIN_COMMAND.format(cell).split()[1:])) for cell in NEW_CELLS]:
        assert rc == 0, err[-3000:]
    for cell, limits in TINY_DETECT_LIMITS.items():
        assert json.loads((pins / f"{cell}.json").read_text())["tiny_limits"] == limits

    # The copy's own tests of the new cells, and of each network's
    # parameters against the program's.
    rc, out, err = finish(start(pytest_args + [networks]))
    assert rc == 0, (out + err)[-6000:]
    passed = {line.split("::", 1)[1] for line in out.splitlines() if line.startswith("PASSED ")}
    for cell in NEW_CELLS:
        assert f"test_full_size_flops_and_bounds_are_pinned[{cell}]" in passed
        for seed in (5, 2147483659):
            assert f"test_tiny_readings_are_pinned[{cell}-{seed}]" in passed
        assert f"test_program_is_correct_and_the_line_has_its_keys[{cell}]" in passed
        assert f"test_lower_precision_control_is_not_correct[{cell}]" in passed
        assert f"test_traced_line_of_a_tiny_cell_reads_the_program_spans[{cell}]" in passed
    for network, kind in (("tiny_c4", "az"), ("tiny_c4", "frcnn"), ("tiny_fpn", "frcnn")):
        assert f"test_reference_parameters_are_the_ports[{network}-{kind}]" in passed

    after = _tree_digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before

# -- a feature pyramid, in this process --------------------------------------

@pytest.fixture(scope="session")
def tiny_fpn_networks(tmp_path_factory):
    """A networks folder that holds ``tiny_fpn.py`` (loaded once a session:
    ``nets.network_module`` keeps what it loaded)."""
    path = tmp_path_factory.mktemp("networks")
    (path / "tiny_fpn.py").write_text(TINY_FPN)
    return path


@pytest.fixture
def tiny_fpn(tiny_fpn_networks, monkeypatch):
    """``{kind: tiny cell}`` of the ``tiny_fpn`` network (a detect cell and a
    propose cell of VGG-16's traffic on its configuration), its module found
    by name in a networks folder of its own."""
    import conftest

    monkeypatch.setattr(nets, "NETWORKS_DIR", tiny_fpn_networks)
    cells = {}
    for kind, like in (("frcnn", "vgg16.detect_given_b8"), ("az", "vgg16.im_propose_b1")):
        cell = conftest.tiny_cell(like)
        cell.conf["MODEL"].update(BACKBONE="tiny_fpn", FC_DIM=32, FC7_DIM=0)
        cells[kind] = cell
    assert nets.network(cells["frcnn"].conf["MODEL"]).__file__ == str(
        tiny_fpn_networks / "tiny_fpn.py")
    return cells


def test_the_feature_helpers_are_the_tensor_operations_on_one_map():
    t = torch.arange(2 * 3 * 4 * 5, dtype=torch.float32).reshape(2, 3, 4, 5)
    assert nets.image_features(t, 1) is not t and torch.equal(nets.image_features(t, 1), t[1])
    assert torch.equal(nets.each_level(lambda x: x * 2, t), t * 2)
    assert nets.elements(t) is t
    assert nets.levels(t) == (t,) and nets.channels(t) == 5 and not nets.is_pyramid(t)


def test_a_pyramid_networks_pool_is_the_one_roi_forward_calls(tiny_fpn, monkeypatch):
    from harness import inputs

    model = tiny_fpn["frcnn"].conf["MODEL"]
    mod = nets.network(model)
    p = inputs.make_weights(model, "frcnn", 2 ** 31 + 3, "cpu")
    feats = nets.trunk(model, p, torch.rand(2, 64, 96, 3) * 255.0 - 128.0)
    assert [tuple(f.shape) for f in feats] == [(2, 8, 12, 16), (2, 4, 6, 16), (2, 2, 3, 16)]
    feat = nets.image_features(feats, 1)
    assert all(torch.equal(a, b[1]) for a, b in zip(feat, feats))
    assert nets.channels(feat) == 16 and nets.is_pyramid(feat)
    assert torch.equal(nets.elements(feat), torch.cat([f.flatten() for f in feat]))
    rois = torch.from_numpy(inputs.given_boxes(5, 1, 40, (64, 96), 8, (0.5, 2.0))[0])
    level = mod.box_levels(rois)
    assert len(set(level.tolist())) == 3  # every level has boxes
    # Each box pooled from its own level, by eq. 1.
    pooled = mod.pool(model, feat, rois, lambda x: x)
    for i, k in enumerate(level.tolist()):
        assert torch.equal(pooled[i], nets.roi_align(feat[k], rois[i:i + 1], 8 * 2 ** k, 7)[0])
    # nets.roi_forward calls the network's pool, and its q rounds each level.
    seen, calls = [], []

    def q(x):
        seen.append(tuple(x.shape))
        return x.bfloat16().float()

    def pool(*args, own=mod.pool):
        calls.append(args)
        return own(*args)

    monkeypatch.setattr(mod, "pool", pool)
    got = nets.roi_forward(model, "frcnn", p, feat, rois, q)
    assert len(calls) == 1 and calls[0][1] is feat and calls[0][3] is q
    assert {tuple(f.shape) for f in feat} <= set(seen)
    rounded = nets.each_level(q, feat)
    assert all(torch.equal(r, f.bfloat16().float()) for r, f in zip(rounded, feat))
    want = nets.head(model, "frcnn", p, pool(model, rounded, rois, lambda x: x), q)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_the_reference_search_runs_to_the_end_over_a_pyramid(tiny_fpn):
    from harness import check, inputs
    from reference import search as rs

    cell = tiny_fpn["az"]
    conf = cell.conf
    p = inputs.make_weights(conf["MODEL"], "az", 2 ** 31 + 4, "cpu")
    ref = check.Reference(conf, "az", p, "cpu")
    image = inputs.device_images(6, 1, cell.traffic["image_hw"], "cpu")[0]
    feat, _, vh, vw = ref.features(image, nets.canvas_for(60, 80, 64, 128))
    assert len(feat) == 3
    found = rs.search(ref.roi_forward, feat, vh, vw, conf["SEAR"], conf["BOX_OFFSET"],
                      cell.limits[check.BAND_KEY])
    assert int(found.valid.sum()) > 0
    assert bool(torch.isfinite(found.boxes).all() & torch.isfinite(found.scores).all())


def test_a_pyramids_roi_log_is_what_the_single_map_readers_refuse(tiny_fpn):
    """``RoiLog`` of the reference's ``roi_forward`` on a three-level pyramid
    and on VGG-16's one map: ``roi_align_roofline`` and ``heads.mfu`` read
    the map's and nothing of the pyramid's."""
    import conftest
    from types import SimpleNamespace

    from harness import inputs, runner, trace as tr
    from harness.system import ReferenceSystem

    def logged(cell):
        model = cell.conf["MODEL"]
        p = inputs.make_weights(model, "frcnn", 2 ** 31 + 5, "cpu")
        system = ReferenceSystem(cell.conf, "frcnn", p, "cpu")
        feat = nets.image_features(nets.trunk(model, p, torch.zeros(1, 64, 96, 3)), 0)
        log = tr.RoiLog(system)
        system.roi_forward(feat, torch.tensor([[0.0, 0.0, 40.0, 30.0], [8.0, 8.0, 20.0, 28.0]]))
        log.remove()
        assert system.roi_forward.__func__ is ReferenceSystem.roi_forward
        return feat, log.calls

    def run(cell, rois_log):
        kernel = "void (anonymous namespace)::roi_align_kernel<float, true>(Params)"
        return SimpleNamespace(
            cell=cell, driver=SimpleNamespace(kind="frcnn"),
            calls=[runner.Call(0, 0, 10 ** 6, 1, True)],
            trace={"rois": rois_log, "spans": {"trunk": ([(0, 10)], [0.01])},
                   "events": [(kernel, 20, 1020), ("gemm", 2000, 3000)]})

    vgg = conftest.tiny_cell("vgg16.detect_given_b8")
    feat, calls = logged(tiny_fpn["frcnn"])
    (shape, size, rois), = calls
    assert len(shape) != 3 and tr.is_pyramid_shape(shape)
    assert shape == tr.pyramid_shape(tuple(f.shape) for f in feat) and size == 4
    assert rois.shape == (2, 4)
    one, one_calls = logged(vgg)
    assert one_calls[0][:2] == (tuple(one.shape), 4)
    for metric in ("roi_align_roofline.detect", "heads.mfu.detect"):
        read = spec.reader(BENCH, metric)
        assert read(run(vgg, one_calls)) > 0, metric
        assert read(run(tiny_fpn["frcnn"], calls)) is None, metric


def test_the_ports_launches_are_every_counter_of_its_table():
    from aznet_tpu_torch.ops.cuda import COUNTERS, launch_counts

    from harness.system import PortSystem

    got = PortSystem.launches()
    assert set(got) == set(COUNTERS) and got == launch_counts()


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
