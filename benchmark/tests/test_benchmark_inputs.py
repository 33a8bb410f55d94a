"""What the benchmark makes from ``--seed``: the same seed gives the same
weights, images and given boxes; another seed gives others; seeds past 32
bits work. The reference's parameter list is the port's, name for name, for
each network and kind that a cell of BENCHMARK.json runs."""

import numpy as np
import pytest
import torch

from conftest import network_cells, tiny_cell
from harness import inputs
from reference import nets, search as rs

BIG = 2 ** 31 + 12345


@pytest.mark.parametrize("seed", [0, 7, BIG, -3])
def test_images_and_boxes_repeat(seed):
    a = inputs.host_images(seed, 2, (6, 8))
    assert np.array_equal(a, inputs.host_images(seed, 2, (6, 8)))
    assert not np.array_equal(a, inputs.host_images(seed + 1, 2, (6, 8)))
    d = inputs.device_images(seed, 2, (6, 8), "cpu")
    assert torch.equal(d, inputs.device_images(seed, 2, (6, 8), "cpu"))
    b = inputs.given_boxes(seed, 3, 50, (375, 500), 16, (0.5, 2.0))
    assert np.array_equal(b, inputs.given_boxes(seed, 3, 50, (375, 500), 16, (0.5, 2.0)))


def test_given_boxes_lie_inside_the_image():
    b = inputs.given_boxes(11, 4, 300, (375, 500), 16, (0.5, 2.0))
    w, h = b[..., 2] - b[..., 0] + 1, b[..., 3] - b[..., 1] + 1
    assert (b[..., :2] >= 0).all() and (b[..., 2] <= 499 + 1e-3).all() and (b[..., 3] <= 374 + 1e-3).all()
    assert (w >= 16 - 1e-3).all() and (h >= 16 - 1e-3).all()


@pytest.mark.parametrize("kind", ["az", "frcnn"])
def test_weights_repeat_and_set_the_heads(kind):
    model = dict(tiny_cell("vgg16.im_propose_b1").conf["MODEL"])
    a = inputs.make_weights(model, kind, BIG, "cpu")
    b = inputs.make_weights(model, kind, BIG, "cpu")
    c = inputs.make_weights(model, kind, BIG + 1, "cpu")
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.conv1_1.weight"], c["trunk.conv1_1.weight"])
    for name in nets.head_outputs(kind, model):
        assert a[f"head.{name}.weight"].sum(1).abs().max() < 1e-4  # rows centred
    if kind == "az":  # the search head's outputs over the probe's regions
        probe = torch.rand((1, *inputs.PROBE_HW, 3), generator=inputs.generator(BIG, "probe", "cpu"))
        feat = nets.image_features(nets.trunk(model, a, probe * 255.0 - 128.0), 0)
        side = torch.tensor(float(inputs.PROBE_HW[0]))
        levels = {"SEED_LEVELS": inputs.PROBE_DEPTH, "DIV_OVERLAP": 0.0}
        regions = rs.init_frontier(side, side, levels, 1.0, rs.seed_count(inputs.PROBE_DEPTH))[0]
        depth = torch.cat([torch.full((5 ** d,), d) for d in range(inputs.PROBE_DEPTH + 1)])
        out = nets.roi_forward(model, kind, a, feat, regions)
        biases = {f"head.{name}.bias" for name in inputs.AZ_SPREADS}
        unbiased = nets.roi_forward(model, kind, {k: torch.zeros_like(v) if k in biases else v
                                                  for k, v in a.items()}, feat, regions)
        for (name, spread), key, mean in zip(inputs.AZ_SPREADS.items(),
                                             ("zoom", "adj_score", "adj_delta"),
                                             (inputs.ZOOM_BIAS, 0.0, 0.0)):
            assert abs(float(unbiased[key].std()) / spread - 1.0) < 0.01, name
            row_means = out[key].reshape(regions.shape[0], -1).mean(0)
            assert (row_means - mean).abs().max() < 0.006, name
        by_depth = [float(out["zoom"][depth == d].mean()) for d in range(inputs.PROBE_DEPTH + 1)]
        assert by_depth == sorted(by_depth, reverse=True)  # a larger region zooms more


NETWORKS = network_cells()


@pytest.mark.parametrize("backbone,kind", list(NETWORKS))
def test_reference_parameters_are_the_ports(backbone, kind):
    from aznet_tpu_torch import api
    from aznet_tpu_torch.config import Config, cfg_from_dict

    cell = tiny_cell(NETWORKS[backbone, kind])
    model = cell.conf["MODEL"]
    cfg = cfg_from_dict(Config(), {"MODEL": model})
    with torch.device("meta"):
        port = (api.AZNet if kind == "az" else api.FRCNN)(cfg.MODEL)
    want = {k: tuple(v.shape) for k, v in port.state_dict().items()}
    got = {name: shape for name, shape, _ in nets.param_specs(model, kind)}
    assert got == want
