#!/usr/bin/env python
"""The VGG-16 trunk's variants side by side with the PyTorch port: the
counterpart of ``tools/bench_trunk.py``, on the card unless ``--cpu``.

Variants (``--variants``, comma-separated):
  bf16       the float trunk in bf16 (cuDNN convs)
  chain      int8 from conv2_2, the chain entry of ``csrc/conv_int8.cu``
             with the pools fused (``INT8_BACKEND='pallas'``)
  chain_ext  int8 from conv1_2 (``INT8_CHAIN_FROM='conv1_2'``)
  strip      the strip entry with separate pools (``'pallas_strip'``)
  xla_int8   three dx-packed ``torch._int_mm`` GEMMs a layer (``'xla'``)
The reference's ``bf16_s2d`` and ``chain_s2d`` rewrite conv1_1 for the
TPU's layout, which the port does not carry. ``--trows`` set the TPU
kernel's strip height: it is warned and ignored.

Weights are seeded; the int8 scales are fixed (they steer the requantization
grids, not the time). Each variant runs ``HI - LO`` calls a trial (the
reference's scan-length difference, ``--reps LO HI``) under
``tools_torch/_timing.py::event_time``; the trials' spread is printed.

Usage: python tools_torch/bench_trunk.py [--batch 8] [--hw 608 800]
       [--variants bf16,chain,strip] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

SCALES = (30, 25, 20, 15, 12, 10, 8, 8, 6, 6, 5, 5)
VARIANTS = {  # name -> VGG16Trunk's int8 arguments (None: the bf16 trunk)
    "bf16": None,
    "chain": {},
    "chain_ext": {"int8_chain_from": "conv1_2"},
    "strip": {"int8_backend": "pallas_strip"},
    "xla_int8": {"int8_backend": "xla"},
}


def make_trunk(name: str, state_dict: dict, dev):
    """The trunk of variant ``name`` on ``dev``, from the float32
    ``state_dict``, ready for inference."""
    import torch

    from aznet_tpu_torch.models.vgg import VGG16Trunk

    kw = VARIANTS[name]
    if kw is None:
        trunk = VGG16Trunk(dtype=torch.bfloat16)
        trunk.load_state_dict(state_dict)
        trunk = trunk.to(dev, torch.bfloat16)
    else:
        trunk = VGG16Trunk(int8_mode=True, int8_scales=SCALES, **kw)
        trunk.load_state_dict(state_dict)
        trunk = trunk.to(dev)
        trunk.prepare_int8()
    return trunk.eval().requires_grad_(False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="aznet_tpu_torch trunk variants")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--hw", type=int, nargs=2, default=(608, 800))
    p.add_argument("--variants", default="bf16,chain,strip",
                   help="also available: chain_ext, xla_int8")
    p.add_argument("--reps", type=int, nargs=2, default=(2, 6))
    p.add_argument("--trials", type=int, default=3)
    p.add_argument("--trows", type=int, default=0,
                   help="the TPU kernel's strip height: ignored by the port")
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)
    if args.trows:
        warnings.warn("--trows sets the TPU kernel's strip height; the port ignores it",
                      stacklevel=2)

    import torch

    from aznet_tpu_torch.api import _device
    from aznet_tpu_torch.models.aznet import init_params
    from aznet_tpu_torch.models.vgg import VGG16Trunk
    from tools_torch import _common
    from tools_torch._timing import event_time, timer_for

    names = args.variants.split(",")
    unknown = [n for n in names if n not in VARIANTS]
    if unknown:
        raise ValueError(f"unknown variants {unknown}; the port has {sorted(VARIANTS)}")
    dev = _device(_common.device(args))
    print(f"# device: {_common.card_line(dev)}", flush=True)
    h, w = args.hw
    x = torch.from_numpy(np.random.RandomState(0).uniform(-120, 120, (args.batch, h, w, 3))
                         .astype(np.float32)).to(dev)
    base = VGG16Trunk()
    gen = torch.Generator().manual_seed(0)
    init_params(base, gen)
    state_dict = base.state_dict()
    reps = args.reps[1] - args.reps[0]
    results = {}
    with torch.inference_mode():
        for name in names:
            trunk = make_trunk(name, state_dict, dev)
            t = event_time(lambda: trunk(x), reps=reps, trials=args.trials, timer=timer_for(dev))
            ms = t.seconds * 1e3 / args.batch
            results[name] = {"ms_per_img": ms, "img_per_sec": args.batch / t.seconds,
                             "trials_ms": [d * 1e3 for d in t.trials]}
            print(f"{name:10s} {ms:7.3f} ms/img  ({args.batch / t.seconds:7.1f} img/s "
                  f"trunk-only; trials {', '.join(f'{d * 1e3:.3f}' for d in t.trials)} ms a call)",
                  flush=True)
            del trunk
    print(json.dumps({"tool": "bench_trunk", "device": _common.card_line(dev),
                      "batch": args.batch, "hw": [h, w], "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
