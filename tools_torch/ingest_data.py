#!/usr/bin/env python
"""Dataset ingest for the PyTorch port (the counterpart of
``tools/ingest_data.py``, the reference's ``data/scripts/*.sh`` role). There
is no download: ingest links an existing copy into the expected layout,
validates it and warms the roidb cache:

  python tools_torch/ingest_data.py voc  --src /path/to/VOCdevkit --year 2007
  python tools_torch/ingest_data.py coco --src /path/to/coco
  python tools_torch/ingest_data.py weights --src vgg16_params.npz --arch vgg16
  python tools_torch/ingest_data.py status

``status`` reports which datasets the imdb factory sees. ``weights`` writes
a port snapshot of Caffe weights (``utils/convert_weights.py``). Nothing
here runs on a device.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _data_root():
    from aznet_tpu_torch.data.voc import _data_root as dr

    root = dr()
    os.makedirs(root, exist_ok=True)
    return root


def _link(src: str, dst: str):
    src = os.path.abspath(src)
    if os.path.islink(dst) or os.path.exists(dst):
        print(f"  exists: {dst}")
        return
    os.symlink(src, dst)
    print(f"  linked: {dst} -> {src}")


def ingest_voc(args):
    year = args.year
    dst = os.path.join(_data_root(), f"VOCdevkit{year}")
    _link(args.src, dst)
    vroot = os.path.join(dst, f"VOC{year}")
    missing = [d for d in ("ImageSets/Main", "Annotations", "JPEGImages")
               if not os.path.isdir(os.path.join(vroot, d))]
    if missing:
        print(f"  INVALID layout — missing under {vroot}: {missing}")
        return 1
    from aznet_tpu_torch.data.imdb import get_imdb

    for split in args.splits.split(","):
        imdb = get_imdb(f"voc_{year}_{split}")
        n = imdb.num_images
        imdb.roidb  # builds + writes data/cache/*.pkl
        print(f"  voc_{year}_{split}: {n} images, roidb cached")
    return 0


def ingest_coco(args):
    dst = os.path.join(_data_root(), "coco")
    _link(args.src, dst)
    ann = os.path.join(dst, "annotations")
    if not os.path.isdir(ann):
        print(f"  INVALID layout — no {ann}")
        return 1
    avail = sorted(f[len("instances_"):-len(".json")] for f in os.listdir(ann)
                   if f.startswith("instances_") and f.endswith(".json"))
    print(f"  splits with annotations: {avail}")
    return 0


def ingest_weights(args):
    """Caffe-exported .npz -> a params-only port snapshot."""
    from aznet_tpu_torch.utils.convert_weights import convert_npz_to_checkpoint

    out = args.out or os.path.join("output", "converted", args.arch)
    convert_npz_to_checkpoint(args.src, out, arch=args.arch)
    print(f"  converted {args.src} -> {out}")
    return 0


def status(args):
    from aznet_tpu_torch.data.coco import coco_data_available
    from aznet_tpu_torch.data.voc import voc_data_available

    print(f"data root: {_data_root()}")
    for year in ("2007", "2012"):
        print(f"  voc_{year}: {'OK' if voc_data_available(year) else 'absent'}")
    for split in ("train2014", "val2014", "train2017", "val2017"):
        print(f"  coco_{split}: {'OK' if coco_data_available(split) else 'absent'}")
    print("  synthetic_*: always available (generated)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    v = sub.add_parser("voc", help="link + validate + cache a VOCdevkit")
    v.add_argument("--src", required=True)
    v.add_argument("--year", default="2007")
    v.add_argument("--splits", default="trainval,test")
    v.set_defaults(fn=ingest_voc)
    c = sub.add_parser("coco", help="link + validate a COCO root")
    c.add_argument("--src", required=True)
    c.set_defaults(fn=ingest_coco)
    w = sub.add_parser("weights", help="convert Caffe-export .npz to ckpt")
    w.add_argument("--src", required=True)
    w.add_argument("--arch", default="vgg16")
    w.add_argument("--out", default=None)
    w.set_defaults(fn=ingest_weights)
    s = sub.add_parser("status", help="report visible datasets")
    s.set_defaults(fn=status)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
