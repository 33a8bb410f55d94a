#!/usr/bin/env python
"""Generate and cache AZ-Net proposals for an imdb with the PyTorch port (the
counterpart of ``tools/propose_net.py``; it feeds Fast R-CNN training), on
the card unless ``--cpu``. The pickle is the reference's format, a list of
float32 ``(N, 5)`` NumPy arrays, so either package's ``train_net`` reads
the other's."""

from __future__ import annotations

import argparse
import os
import pickle
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tools_torch import _common  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Cache AZ-Net proposals for an imdb")
    p.add_argument("--imdb", default="synthetic_train")
    p.add_argument("--cfg", default=None)
    p.add_argument("--set", dest="set_cfgs", nargs="*", default=[])
    p.add_argument("--ckpt", default=None)
    p.add_argument("--out", default="output/proposals.pkl")
    p.add_argument("--max-images", type=int, default=None)
    p.add_argument("--batched", action="store_true",
                   help="batched propose (canvas-bucketed; faster)")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--cpu", action="store_true")
    args = p.parse_args(argv)

    from aznet_tpu_torch.api import build_az_net
    from aznet_tpu_torch.data.imdb import get_imdb
    from aznet_tpu_torch.eval.detection import propose_all, propose_all_batched

    cfg = _common.load_config(args.cfg, args.set_cfgs)
    net = _common.load_net(build_az_net, cfg, args.ckpt, _common.device(args))
    imdb = get_imdb(args.imdb)
    if args.batched:
        props = propose_all_batched(net, imdb, batch_size=args.batch_size,
                                    max_images=args.max_images, verbose=True)
    else:
        props = propose_all(net, imdb, max_images=args.max_images, verbose=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "wb") as f:
        pickle.dump(props, f)
    print(f"wrote {len(props)} proposal arrays to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
