"""MS COCO dataset.

Counterpart of ``aznet_tpu/data/coco.py``: the standard
``annotations/instances_<split>.json`` layout read with plain json (no
pycocotools; proposal recall and detection need only boxes).
"""

from __future__ import annotations

import json
import os
from typing import List

import numpy as np

from aznet_tpu_torch.data.imdb import Imdb
from aznet_tpu_torch.data.voc import _data_root


def coco_root() -> str:
    return os.path.join(_data_root(), "coco")


def coco_data_available(split: str) -> bool:
    return os.path.exists(
        os.path.join(coco_root(), "annotations", f"instances_{split}.json")
    )


class COCOImdb(Imdb):
    def __init__(self, split: str = "val2017"):
        self.split = split
        self._entries: List[dict] | None = None
        self._classes: List[str] | None = None
        super().__init__(f"coco_{split}", ["__background__"])

    def _load(self):
        if self._entries is not None:
            return
        path = os.path.join(coco_root(), "annotations", f"instances_{self.split}.json")
        with open(path) as f:
            data = json.load(f)
        cats = sorted(data["categories"], key=lambda c: c["id"])
        self.classes = ["__background__"] + [c["name"] for c in cats]
        self.num_classes = len(self.classes)
        cat_to_cls = {c["id"]: i + 1 for i, c in enumerate(cats)}
        anns_by_img: dict = {}
        for a in data["annotations"]:
            anns_by_img.setdefault(a["image_id"], []).append(a)
        entries = []
        for img in data["images"]:
            anns = anns_by_img.get(img["id"], [])
            boxes = np.zeros((len(anns), 4), np.float32)
            classes = np.zeros((len(anns),), np.int32)
            crowd = np.zeros((len(anns),), bool)
            for i, a in enumerate(anns):
                x, y, w, h = a["bbox"]  # COCO xywh, continuous coords
                boxes[i] = [x, y, x + max(w - 1, 0), y + max(h - 1, 0)]
                classes[i] = cat_to_cls[a["category_id"]]
                crowd[i] = bool(a.get("iscrowd"))
            entries.append(
                {
                    "image": os.path.join(coco_root(), self.split, img["file_name"]),
                    "index": img["id"],
                    "height": img["height"],
                    "width": img["width"],
                    "boxes": boxes,
                    "gt_classes": classes,
                    # COCO protocol: crowds are IGNORE regions — they absorb
                    # detections in eval (coco_eval) without TP/FP counting
                    # and are excluded from training labels / recall
                    # denominators, which the framework keys off "difficult".
                    "crowd": crowd,
                    "difficult": crowd.copy(),
                    "flipped": False,
                }
            )
        self._entries = entries

    @property
    def num_images(self) -> int:
        self._load()
        return len(self._entries)

    def gt_roidb(self):
        self._load()
        return self._entries

    def evaluate_detections(self, all_boxes, output_dir: str):
        """COCO-protocol AP@[.5:.95] / per-area AP / AR@K (eval/coco_eval.py),
        plus the VOC-style IoU-0.5 mAP for cross-dataset comparability."""
        from aznet_tpu_torch.eval.coco_eval import coco_eval
        from aznet_tpu_torch.eval.voc_eval import eval_detections_on_roidb

        self._load()
        out = coco_eval(all_boxes, self.roidb, self.num_classes)
        voc = eval_detections_on_roidb(all_boxes, self.roidb, self.num_classes)
        out["mAP@0.5_voc_protocol"] = voc["mAP"]
        return out
