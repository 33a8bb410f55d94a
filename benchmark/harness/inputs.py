"""What the benchmark makes from ``--seed``: the weights, on the card in one
draw, and the traffic's images and given boxes. The same seed gives the same
weights and inputs; each stream of numbers has its own generator."""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

from reference import nets, search as rs


def stream_seed(seed: int, stream: str) -> int:
    """A 62-bit seed of the named stream of ``seed`` (any integer)."""
    ss = np.random.SeedSequence([abs(int(seed)), int(seed < 0), zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0]) >> 2


def generator(seed: int, stream: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(stream_seed(seed, stream))
    return g


ZOOM_BIAS = 2.0  # sigmoid 0.88
# The search head's outputs' spreads over the probe's regions: zoom logits
# (the lowest stay above ZOOM_THRESH 0.2, a logit of -1.39, 4.5 spreads below
# the bias), adjacency logits and box deltas.
AZ_SPREADS = {"zoom_score": 0.75, "adj_score": 1.5, "adj_bbox": 0.2}
PROBE_HW = (224, 224)
PROBE_DEPTH = 3  # the probe's regions: four depths of divisions, 156 regions


def make_weights(model: dict, kind: str, seed: int, device) -> dict:
    """The float32 weights of the ``kind`` network (``nets.param_specs``),
    from one normal draw on ``device``, each parameter a view of it scaled
    to its init. Then three choices that fix the work and the scale of the
    outputs for every seed: the output layers' rows are centred (a zero sum,
    so that the ReLUs' common mode does not set the logits); the weights
    that take the pooled features (``nets.head_input_weights``: fc6 where
    the head has it) are scaled by the inverse of the trunk's output rms on
    a noise image, so that the heads see unit-scale input whatever the
    trunk's gain; and the search head's output layers are scaled so that
    their outputs, before the biases, spread by ``AZ_SPREADS`` over the
    noise image's regions (the spread of all of a layer's outputs
    together), and biased so that each output's mean there is 0, the zoom
    logits' ``ZOOM_BIAS``, once the zoom row is turned to fall with a
    region's depth (``_zoom_by_depth``). So every region divides, the search
    runs every level on every image and seed, and its width follows from the
    image's size alone, while the frontier's top-k by zoom has a real order
    to keep and the scores and boxes vary as a trained head's do. The scales
    are rounded to three digits and the biases to two decimals, so that
    rounding in the probe does not move them."""
    specs = nets.param_specs(model, kind)
    sizes = [math.prod(shape) for _, shape, _ in specs]
    flat = torch.randn(sum(sizes), generator=generator(seed, f"weights.{kind}", device),
                       device=device)
    out, off = {}, 0
    for (name, shape, init), n in zip(specs, sizes):
        std, mean = nets.init_std(shape, init)
        out[name] = flat[off:off + n].view(shape).mul_(std).add_(mean)
        off += n
    for name in nets.head_outputs(kind, model):
        w = out[f"head.{name}.weight"]
        w.sub_(w.mean(1, keepdim=True))
    probe = torch.rand((1, *PROBE_HW, 3), generator=generator(seed, "probe", device),
                       device=device) * 255.0 - 128.0
    feat = nets.trunk(model, out, probe)
    rms = float(feat.pow(2).mean().sqrt())
    for name in nets.head_input_weights(model, kind):
        out[name].mul_(float(f"{1.0 / rms:.3g}"))
    if kind == "az":
        for name in AZ_SPREADS:
            out[f"head.{name}.bias"].zero_()
        side = torch.tensor(float(PROBE_HW[0]), device=device)
        regions = rs.init_frontier(side, side, {"SEED_LEVELS": PROBE_DEPTH, "DIV_OVERLAP": 0.0},
                                   1.0, rs.seed_count(PROBE_DEPTH))[0]
        depth = torch.cat([torch.full((5 ** d,), d, device=device)
                           for d in range(PROBE_DEPTH + 1)])
        got = nets.roi_forward(model, kind, out, feat[0], regions)
        zoom = _zoom_by_depth(out, got, depth)
        for (name, spread), y in zip(AZ_SPREADS.items(), (zoom, got["adj_score"],
                                                         got["adj_delta"])):
            scale = float(f"{spread / float(y.std()):.3g}")
            out[f"head.{name}.weight"].mul_(scale)
            mean = (y * scale).reshape(y.shape[0], -1).mean(0)
            out[f"head.{name}.bias"].copy_(-mean.round(decimals=2))
        out["head.zoom_score.bias"].add_(ZOOM_BIAS)
    return out


def _zoom_by_depth(p: dict, got: dict, depth) -> torch.Tensor:
    """Add to the zoom row (in ``p``, in place) the combination of the other
    output rows that best predicts, over the probe's regions, how shallow a
    region lies (ridge regression of minus the depth on their outputs);
    return the new zoom logits there. A larger region then ranks above its
    children's generation, as a trained zoom indicator tends to, and the
    search runs its last level on every seed: with the zoom row as drawn,
    the seed's weights decided whether it ran, and so how much work a run
    did."""
    ys = torch.cat([got["adj_score"], got["adj_delta"].flatten(1)], 1)
    yc = ys - ys.mean(0)
    target = -(depth.float() - depth.float().mean())
    ridge = 1e-3 * float(yc.pow(2).sum()) / yc.shape[1]
    eye = torch.eye(yc.shape[1], device=yc.device)
    c = torch.linalg.solve(yc.T @ yc + ridge * eye, yc.T @ target)
    rows = torch.cat([p["head.adj_score.weight"], p["head.adj_bbox.weight"]])
    p["head.zoom_score.weight"].add_(c @ rows)
    return got["zoom"] + ys @ c


def device_images(seed: int, n: int, hw, device) -> torch.Tensor:
    """``n`` raw uint8 BGR images ``[n, H, W, 3]`` of uniform noise, drawn on
    ``device``."""
    return torch.randint(0, 256, (n, hw[0], hw[1], 3), dtype=torch.uint8,
                         generator=generator(seed, "images", device), device=device)


def host_images(seed: int, n: int, hw) -> np.ndarray:
    rng = np.random.default_rng(stream_seed(seed, "images"))
    return rng.integers(0, 256, (n, hw[0], hw[1], 3), dtype=np.uint8)


def given_boxes(seed: int, n_images: int, rois: int, hw, side_min: float, aspect) -> np.ndarray:
    """``[n_images, rois, 4]`` float32 boxes inside an ``hw`` image: the
    square root of the area log-uniform from ``side_min`` to the image's
    shorter side, the aspect (w / h) log-uniform in ``aspect``, each side
    capped by the image, the corner uniform where the box fits; ``+1``
    widths (``x2 = x1 + w - 1``)."""
    rng = np.random.default_rng(stream_seed(seed, "boxes"))
    h, w = hw
    shape = (n_images, rois)
    side = np.exp(rng.uniform(np.log(side_min), np.log(min(h, w)), shape))
    ar = np.exp(rng.uniform(np.log(aspect[0]), np.log(aspect[1]), shape))
    bw = np.clip(side * np.sqrt(ar), side_min, w)
    bh = np.clip(side / np.sqrt(ar), side_min, h)
    x1 = rng.uniform(0.0, 1.0, shape) * (w - bw)
    y1 = rng.uniform(0.0, 1.0, shape) * (h - bh)
    return np.stack([x1, y1, x1 + bw - 1.0, y1 + bh - 1.0], -1).astype(np.float32)
