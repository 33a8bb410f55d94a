#!/usr/bin/env python
"""Convert extracted Caffe weights (``.npz``) into a snapshot of the PyTorch
port (the counterpart of ``tools/convert_caffe.py``).

Extract the weights wherever pycaffe exists:

    import caffe, numpy as np
    net = caffe.Net(prototxt, caffemodel, caffe.TEST)
    np.savez("weights.npz", **{f"{k}_W": v[0].data for k, v in net.params.items()},
                            **{f"{k}_b": v[1].data for k, v in net.params.items()})

then:

    python tools_torch/convert_caffe.py --npz weights.npz --net az --out output/az_converted

The snapshot (``{"params": state_dict}`` at step 0) loads through ``--ckpt``
in ``test_net``, ``propose_net`` and ``demo``. Before it is written, every
converted parameter is checked against a freshly built net of the config
(on the card unless ``--cpu``): a name the net lacks, a shape that differs
or a parameter left out raises.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools_torch import _common  # noqa: E402


def check_against(params: dict, model_params: dict) -> None:
    """Raise unless ``params`` has exactly the names and shapes of
    ``model_params``."""
    for key, v in params.items():
        if key not in model_params:
            raise KeyError(f"converted param {key} not in model structure")
        if tuple(v.shape) != tuple(model_params[key].shape):
            raise ValueError(f"{key}: converted {tuple(v.shape)} != model "
                             f"{tuple(model_params[key].shape)}")
    missing = set(model_params) - set(params)
    if missing:
        raise KeyError(f"missing converted params: {sorted(missing)[:5]} ...")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Caffe .npz -> aznet_tpu_torch checkpoint")
    p.add_argument("--npz", required=True)
    p.add_argument("--net", choices=("az", "frcnn"), default="az")
    p.add_argument("--out", required=True, help="checkpoint dir to write")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--zoom-layer", default="zoom_score",
                   help="prototxt name of the zoom head layer")
    p.add_argument("--adj-score-layer", default="adj_score")
    p.add_argument("--adj-bbox-layer", default="adj_bbox")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from aznet_tpu_torch.api import build_az_net, build_frcnn_net
    from aznet_tpu_torch.utils.checkpoint import Checkpointer
    from aznet_tpu_torch.utils.convert_weights import (_TRUNK_LAYOUTS, convert_az_head,
                                                       convert_frcnn_head, convert_trunk,
                                                       load_npz)

    cfg = _common.load_config(args.cfg, args.set_cfgs)
    backbone = cfg.MODEL.BACKBONE
    if backbone not in _TRUNK_LAYOUTS:
        raise SystemExit(f"conversion targets the Caffe-lineage trunks "
                         f"{sorted(_TRUNK_LAYOUTS)}, not {backbone!r}")
    caffe = load_npz(args.npz)
    params = convert_trunk(caffe, backbone)
    last_conv = _TRUNK_LAYOUTS[backbone][0][-1]
    channels = params[f"trunk.{last_conv}.bias"].shape[0]
    if args.net == "az":
        params.update(convert_az_head(
            caffe, pool=cfg.MODEL.POOL_SIZE, channels=channels,
            name_map={"zoom_score": args.zoom_layer, "adj_score": args.adj_score_layer,
                      "adj_bbox": args.adj_bbox_layer}))
        make_net = build_az_net
    else:
        params.update(convert_frcnn_head(caffe, pool=cfg.MODEL.POOL_SIZE, channels=channels))
        make_net = build_frcnn_net
    check_against(params, make_net(cfg, device=_common.device(args)).params)
    Checkpointer(args.out).save(0, {"params": params})
    print(f"wrote converted {args.net} checkpoint to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
