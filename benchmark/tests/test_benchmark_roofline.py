"""The yardstick's counts against hand counts and against PyTorch's own FLOP
counter on the reference at small shapes."""

import math

import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import network_cells, tiny_cell
from harness import inputs, roofline
from reference import nets


def counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def test_vgg16_flops_by_hand():
    # conv1_1 alone at 2x2 is 2*2*2 * 9*3*64 FLOPs; the whole net at 32x32:
    h = w = 32
    want, c = 0, 3
    for _, ch in nets.network_module("vgg16").LAYOUT:
        if ch is None:
            h, w = h // 2, w // 2
        else:
            want += 2 * h * w * 9 * c * ch
            c = ch
    assert roofline.trunk_flops({"BACKBONE": "vgg16", "WIDTH": 1.0}, (32, 32)) == want


def test_trunk_and_head_flops_match_the_flop_counter():
    """On each network that a cell of BENCHMARK.json runs."""
    cells = {}
    for (network, _), name in network_cells().items():
        cells.setdefault(network, name)
    for name in cells.values():
        model = tiny_cell(name).conf["MODEL"]
        p = inputs.make_weights(model, "az", 1, "cpu")
        x = torch.zeros(1, 64, 96, 3)
        assert counted(lambda: nets.trunk(model, p, x)) == roofline.trunk_flops(model, (64, 96))
        channels = nets.channels(nets.trunk(model, p, x))
        pooled = torch.zeros(5, model["POOL_SIZE"], model["POOL_SIZE"], channels)
        assert counted(lambda: nets.head(model, "az", p, pooled)) == roofline.head_flops(model, "az", 5)


def test_search_counts():
    sear = tiny_cell("vgg16.im_propose_b1").conf["SEAR"]  # 3 levels, FRONTIER_CAP 16
    assert roofline.propose_rows(sear) == 8 + 16 + 16
    assert roofline.candidates(sear, 11) == 256  # 40 * 11 capped at CAND_BUF
    assert roofline.candidates({**sear, "CAND_BUF": 4096}, 11) == 40 * 11
    full = {**sear, "MAX_LEVELS": 6, "FRONTIER_CAP": 64, "CAND_BUF": 2048}
    assert roofline.propose_rows(full) == 8 + 32 + 4 * 64
    assert roofline.candidates(full, 11) == 2048


def test_nms_and_conv1_bounds_by_hand():
    n = 2048
    ops = n * (n - 1) // 2 * 15
    assert math.isclose(roofline.nms_bound_s(n), max(n * 22 / 3.35e12, ops / 67e12))
    b, h, w = 2, 608, 800
    nbytes = 2 * b * h * w * 64 + 2 * 9 * 64 * 64 + 4 * 64 + 2 * b * 304 * 400 * 64
    assert math.isclose(roofline.conv1_bound_s(b, h, w),
                        max(nbytes / 3.35e12, 2.0 * b * h * w * 9 * 64 * 64 / 989e12))


def test_roi_align_bound_by_hand():
    # One roi covering cells 0..1 of a 4x4x8 map on both axes, pool 1: its
    # two samples sit at 0.5 and 1.5 (scaled), so each axis has taps on
    # cells 0, 1 and 2 (three live of four slots); 9 cells touched.
    rois = torch.tensor([[0.0, 0.0, 32.0, 32.0]])
    cells, wts = roofline.fused_taps(torch.tensor([0.0]), torch.tensor([2.0]), 4, 1)
    assert cells.tolist() == [[[0, 1, 1, 2]]]
    live = int((wts != 0).sum())
    assert live == 3
    t = roofline.roi_align_bound_s((4, 4, 8), 2, rois, stride=16, pool=1)
    nbytes = 9 * 8 * 2 + 16 + 1 * 8 * 2
    ops = 2.0 * 8 * 3 * (3 + 1)
    assert math.isclose(t, max(nbytes / 3.35e12, ops / 67e12))
