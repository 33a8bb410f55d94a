"""PASCAL VOC dataset.

Counterpart of ``aznet_tpu/data/voc.py`` (the reference's
``lib/datasets/pascal_voc.py``): Annotations XML parsed into a cached gt
roidb, VOC-format results files, and AP evaluation (pure-Python voc_eval).
Expects the standard layout:

    <devkit>/VOC<year>/ImageSets/Main/<split>.txt
    <devkit>/VOC<year>/Annotations/<id>.xml
    <devkit>/VOC<year>/JPEGImages/<id>.jpg

Devkit root resolution: $AZNET_DATA_DIR/VOCdevkit<year> or
data/VOCdevkit<year> under the repo root. Gt boxes are stored 0-indexed
(the reference subtracts 1 from the 1-indexed VOC pixel coordinates).
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import List

import numpy as np

from aznet_tpu_torch.data.imdb import Imdb

VOC_CLASSES = (
    "__background__",
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def _data_root() -> str:
    return os.environ.get(
        "AZNET_DATA_DIR",
        os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(__file__))), "data"),
    )


def devkit_path(year: str) -> str:
    return os.path.join(_data_root(), f"VOCdevkit{year}")


def voc_data_available(year: str = "2007") -> bool:
    return os.path.isdir(os.path.join(devkit_path(year), f"VOC{year}"))


def parse_voc_xml(path: str, use_diff: bool = True):
    """One annotation file -> (boxes [G, 4] 0-indexed, classes [G], difficult [G]).

    Difficult objects are KEPT (flagged) by default: the eval protocol needs
    them present to IGNORE (not penalize) matching detections; training-time
    sampling excludes them via the flag.
    """
    tree = ET.parse(path)
    objs = tree.findall("object")

    def _is_difficult(o):
        d = o.find("difficult")
        return bool(int(d.text)) if d is not None and d.text else False

    if not use_diff:
        objs = [o for o in objs if not _is_difficult(o)]
    boxes = np.zeros((len(objs), 4), np.float32)
    classes = np.zeros((len(objs),), np.int32)
    difficult = np.zeros((len(objs),), bool)
    cls_index = {c: i for i, c in enumerate(VOC_CLASSES)}
    for i, obj in enumerate(objs):
        bb = obj.find("bndbox")
        # VOC is 1-indexed; the reference stores 0-indexed.
        boxes[i] = [
            float(bb.find("xmin").text) - 1,
            float(bb.find("ymin").text) - 1,
            float(bb.find("xmax").text) - 1,
            float(bb.find("ymax").text) - 1,
        ]
        classes[i] = cls_index[obj.find("name").text.strip().lower()]
        difficult[i] = _is_difficult(obj)
    size = tree.find("size")
    h = int(size.find("height").text)
    w = int(size.find("width").text)
    return boxes, classes, difficult, h, w


class PascalVOC(Imdb):
    def __init__(self, split: str, year: str = "2007", cache_dir: str | None = None):
        super().__init__(f"voc_{year}_{split}", list(VOC_CLASSES))
        self.split = split
        self.year = year
        self.devkit = devkit_path(year)
        self.root = os.path.join(self.devkit, f"VOC{year}")
        self.cache_dir = cache_dir or os.path.join(_data_root(), "cache")
        self._index: List[str] | None = None

    @property
    def image_index(self) -> List[str]:
        if self._index is None:
            path = os.path.join(self.root, "ImageSets", "Main", f"{self.split}.txt")
            with open(path) as f:
                self._index = [line.strip().split()[0] for line in f if line.strip()]
        return self._index

    @property
    def num_images(self) -> int:
        return len(self.image_index)

    def image_path(self, idx: str) -> str:
        return os.path.join(self.root, "JPEGImages", f"{idx}.jpg")

    def gt_roidb(self):
        def build():
            roidb = []
            for idx in self.image_index:
                boxes, classes, difficult, h, w = parse_voc_xml(
                    os.path.join(self.root, "Annotations", f"{idx}.xml")
                )
                roidb.append(
                    {
                        "image": self.image_path(idx),
                        "index": idx,
                        "height": h,
                        "width": w,
                        "boxes": boxes,
                        "gt_classes": classes,
                        "difficult": difficult,
                        "flipped": False,
                    }
                )
            return roidb

        return self.cached(self.cache_dir, build)

    # -- evaluation (reference pascal_voc._write_voc_results_file + eval) ----
    def results_file(self, output_dir: str, cls: str) -> str:
        os.makedirs(output_dir, exist_ok=True)
        return os.path.join(output_dir, f"det_{self.split}_{cls}.txt")

    def write_results(self, all_boxes, output_dir: str) -> None:
        """all_boxes[cls][img] = [N, 5] dets in ORIGINAL image coords.

        VOC format: ``<id> <score> <x1> <y1> <x2> <y2>`` 1-indexed.
        """
        for c, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            with open(self.results_file(output_dir, cls), "w") as f:
                for i, idx in enumerate(self.image_index):
                    dets = all_boxes[c][i]
                    for d in dets:
                        f.write(
                            f"{idx} {d[4]:.6f} {d[0] + 1:.1f} {d[1] + 1:.1f} "
                            f"{d[2] + 1:.1f} {d[3] + 1:.1f}\n"
                        )

    def evaluate_detections(self, all_boxes, output_dir: str):
        from aznet_tpu_torch.eval.voc_eval import voc_eval

        self.write_results(all_boxes, output_dir)
        use_07_metric = int(self.year) < 2010
        aps = {}
        for c, cls in enumerate(self.classes):
            if cls == "__background__":
                continue
            rec, prec, ap = voc_eval(
                self.results_file(output_dir, cls), self.roidb, self.image_index,
                cls_index=c, ovthresh=0.5, use_07_metric=use_07_metric,
            )
            aps[cls] = ap
        aps["mAP"] = float(np.mean(list(aps.values())))
        return aps
