"""Image database (imdb) abstraction + factory.

Counterpart of ``aznet_tpu/data/imdb.py`` (the reference's
``lib/datasets/imdb.py`` and ``factory.py``): name, classes, image count,
lazily built cached roidb, flipped augmentation, evaluation hooks, and
``get_imdb('voc_2007_trainval')`` lookup with the same registry names.
Images are NumPy HWC BGR uint8 on the host.
"""

from __future__ import annotations

import os
import pickle
from typing import Callable, Dict, List, Optional

import numpy as np


class Imdb:
    """Base class. Subclasses implement image/gt access.

    An roidb entry is a dict:
      image      str | np.ndarray  (path or in-memory HWC BGR uint8)
      height     int
      width      int
      boxes      [G, 4] float32 gt boxes (0-indexed inclusive corners)
      gt_classes [G]    int32 (0 = background, never used for gt)
      flipped    bool
    """

    def __init__(self, name: str, classes: List[str]):
        self.name = name
        self.classes = list(classes)
        self.num_classes = len(classes)
        self._roidb: Optional[List[dict]] = None

    # -- subclass API ------------------------------------------------------
    @property
    def num_images(self) -> int:
        raise NotImplementedError

    def gt_roidb(self) -> List[dict]:
        raise NotImplementedError

    def image_array(self, entry: dict) -> np.ndarray:
        """Materialize the HWC BGR uint8 image for an roidb entry."""
        im = entry["image"]
        if isinstance(im, np.ndarray):
            arr = im
        else:
            arr = _imread_bgr(im)
        if entry.get("flipped"):
            arr = arr[:, ::-1]
        return arr

    # -- shared machinery ---------------------------------------------------
    @property
    def roidb(self) -> List[dict]:
        if self._roidb is None:
            self._roidb = self.gt_roidb()
        return self._roidb

    def append_flipped_images(self) -> None:
        """Horizontal-flip augmentation: x1' = W - x2 - 1 (reference
        ``imdb.append_flipped_images``)."""
        base = list(self.roidb)
        flipped = []
        for entry in base:
            boxes = entry["boxes"].copy()
            w = entry["width"]
            x1 = w - entry["boxes"][:, 2] - 1.0
            x2 = w - entry["boxes"][:, 0] - 1.0
            boxes[:, 0], boxes[:, 2] = x1, x2
            new = dict(entry)
            new["boxes"] = boxes
            new["flipped"] = True
            flipped.append(new)
        self._roidb = base + flipped

    def evaluate_detections(self, all_boxes, output_dir: str):
        """Subclass hook (VOC writes result files + runs AP eval)."""
        raise NotImplementedError

    # -- caching ------------------------------------------------------------
    def cached(self, cache_dir: str, builder: Callable[[], List[dict]]) -> List[dict]:
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"{self.name}_gt_roidb.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                return pickle.load(f)
        roidb = builder()
        with open(path, "wb") as f:
            pickle.dump(roidb, f)
        return roidb


def _imread_bgr(path: str) -> np.ndarray:
    """Read an image as HWC BGR uint8 (cv2 order, as the reference)."""
    try:
        import cv2

        im = cv2.imread(path)
        if im is None:
            raise FileNotFoundError(path)
        return im
    except ImportError:
        from PIL import Image

        rgb = np.asarray(Image.open(path).convert("RGB"))
        return rgb[:, :, ::-1].copy()


# ---------------------------------------------------------------------------
# Factory (reference lib/datasets/factory.py)
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], Imdb]] = {}


def register_imdb(name: str, fn: Callable[[], Imdb]) -> None:
    _REGISTRY[name] = fn


def get_imdb(name: str) -> Imdb:
    _populate()
    if name not in _REGISTRY:
        raise KeyError(f"unknown imdb {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_imdbs() -> List[str]:
    _populate()
    return sorted(_REGISTRY)


_POPULATED = False


def _populate() -> None:
    global _POPULATED
    if _POPULATED:
        return
    _POPULATED = True
    from aznet_tpu_torch.data.synthetic import SyntheticImdb

    for split, seed, n in (("train", 0, 64), ("val", 1, 16), ("test", 2, 32)):
        def make(split=split, seed=seed, n=n):
            return SyntheticImdb(split=split, seed=seed, num_images=n)

        register_imdb(f"synthetic_{split}", make)

    # Hard variant: VOC-sized, >=512 train images,
    # small/overlapping objects + distractor hard negatives.
    for split, seed, n in (("train", 10, 512), ("val", 11, 64), ("test", 12, 128)):
        def make_hard(split=split, seed=seed, n=n):
            return SyntheticImdb(split=split, seed=seed, num_images=n,
                                 image_hw=(375, 500), hard=True)

        register_imdb(f"synthetic_hard_{split}", make_hard)

    from aznet_tpu_torch.data.voc import PascalVOC

    for year in ("2007", "2012"):
        for split in ("train", "val", "trainval", "test"):
            def make_voc(year=year, split=split):
                return PascalVOC(split, year)

            register_imdb(f"voc_{year}_{split}", make_voc)

    from aznet_tpu_torch.data.coco import COCOImdb

    for split in ("train2014", "val2014", "minival2014", "train2017", "val2017"):
        def make_coco(split=split):
            return COCOImdb(split)

        register_imdb(f"coco_{split}", make_coco)
