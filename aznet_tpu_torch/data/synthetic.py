"""Synthetic planted-boxes dataset.

Counterpart of ``aznet_tpu/data/synthetic.py``, giving the same bytes for
the same seed: recall and mAP pipelines run end to end with no dataset on
disk. Images are noise backgrounds with filled coloured rectangles; classes
are colour names. Deterministic per (split, seed).
"""

from __future__ import annotations

import numpy as np

from aznet_tpu_torch.data.imdb import Imdb

CLASSES = ("__background__", "red", "green", "blue")
_COLORS = {
    1: (40, 40, 200),   # BGR red-ish
    2: (60, 200, 60),   # green
    3: (220, 70, 40),   # blue
}


def make_image(rng: np.random.RandomState, h: int = 192, w: int = 256,
               max_objects: int = 4):
    """Returns (image HWC BGR uint8, boxes [G,4] f32, classes [G] int32)."""
    im = rng.randint(0, 80, (h, w, 3)).astype(np.uint8)
    n = rng.randint(1, max_objects + 1)
    boxes, classes = [], []
    for _ in range(n):
        bw = rng.randint(max(8, w // 16), w // 2)
        bh = rng.randint(max(8, h // 16), h // 2)
        x1 = rng.randint(0, w - bw)
        y1 = rng.randint(0, h - bh)
        cls = rng.randint(1, len(CLASSES))
        color = np.array(_COLORS[cls], np.uint8)
        jitter = rng.randint(-20, 20, 3)
        im[y1 : y1 + bh, x1 : x1 + bw] = np.clip(
            color.astype(int) + jitter, 0, 255
        ).astype(np.uint8)
        boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
        classes.append(cls)
    return im, np.asarray(boxes, np.float32), np.asarray(classes, np.int32)


def make_image_hard(rng: np.random.RandomState, h: int = 375, w: int = 500,
                    max_objects: int = 10):
    """VOC-sized hard variant: small/overlapping objects + distractors.

    Where :func:`make_image` plants 1-4 large flat boxes, this generator
    plants 2..max_objects textured class rectangles down to ~14 px (small at
    the 600-scale), allows gt-gt occlusion (later objects draw over earlier
    ones), and adds hard negatives the net must reject: non-class-colored
    solid rectangles and class-colored OUTLINES (right hue, wrong fill).

    Objects whose visible fraction drops below 0.5 (drawn over by later
    objects) are marked ``difficult`` — the VOC protocol for such gt:
    excluded from recall denominators and neither counted nor penalized in
    AP, and excluded from training labels. Expecting recall on
    mostly-invisible rectangles would measure the generator, not the model.

    Returns (image HWC BGR uint8, boxes [G,4] f32, classes [G] i32,
    difficult [G] bool).
    """
    im = rng.randint(0, 80, (h, w, 3)).astype(np.uint8)

    # Distractor layer first: 2-6 solid non-class rectangles + outlines.
    for _ in range(rng.randint(2, 7)):
        dw = rng.randint(12, w // 3)
        dh = rng.randint(12, h // 3)
        x1 = rng.randint(0, w - dw)
        y1 = rng.randint(0, h - dh)
        if rng.rand() < 0.5:
            color = rng.randint(90, 200, 3)  # grayish/non-class hue
            im[y1:y1 + dh, x1:x1 + dw] = color.astype(np.uint8)
        else:  # class-colored outline, hollow center (hard negative)
            cls = rng.randint(1, len(CLASSES))
            color = np.asarray(_COLORS[cls], int)
            t = max(2, min(dw, dh) // 10)
            im[y1:y1 + dh, x1:x1 + t] = color
            im[y1:y1 + dh, x1 + dw - t:x1 + dw] = color
            im[y1:y1 + t, x1:x1 + dw] = color
            im[y1 + dh - t:y1 + dh, x1:x1 + dw] = color

    n = rng.randint(2, max_objects + 1)
    boxes, classes = [], []
    owner = np.full((h, w), -1, np.int32)  # topmost painter per pixel
    for j in range(n):
        # Log-uniform sizes: half the objects land below ~40 px.
        lo, hi = np.log(14), np.log(min(h, w) // 2)
        bw = int(np.exp(rng.uniform(lo, hi)))
        bh = int(np.exp(rng.uniform(lo, hi)))
        x1 = rng.randint(0, w - bw)
        y1 = rng.randint(0, h - bh)
        cls = rng.randint(1, len(CLASSES))
        color = np.asarray(_COLORS[cls], int)
        patch = np.clip(
            color[None, None] + rng.randint(-30, 30, (bh, bw, 3)), 0, 255)
        im[y1:y1 + bh, x1:x1 + bw] = patch.astype(np.uint8)
        owner[y1:y1 + bh, x1:x1 + bw] = j
        boxes.append([x1, y1, x1 + bw - 1, y1 + bh - 1])
        classes.append(cls)
    boxes_a = np.asarray(boxes, np.float32)
    difficult = np.zeros(n, bool)
    for j in range(n):
        x1, y1, x2, y2 = boxes_a[j].astype(int)
        vis = (owner[y1:y2 + 1, x1:x2 + 1] == j).mean()
        difficult[j] = vis < 0.5
    return im, boxes_a, np.asarray(classes, np.int32), difficult


class SyntheticImdb(Imdb):
    def __init__(self, split: str = "train", seed: int = 0, num_images: int = 64,
                 image_hw=(192, 256), hard: bool = False):
        name = f"synthetic_{'hard_' if hard else ''}{split}"
        super().__init__(name, list(CLASSES))
        self.seed = seed
        self._n = num_images
        self.image_hw = image_hw
        self.hard = hard

    @property
    def num_images(self) -> int:
        return self._n

    def gt_roidb(self):
        roidb = []
        for i in range(self._n):
            rng = np.random.RandomState(self.seed * 100003 + i)
            if self.hard:
                im, boxes, classes, difficult = make_image_hard(
                    rng, *self.image_hw)
            else:
                im, boxes, classes = make_image(rng, *self.image_hw)
                difficult = np.zeros(len(classes), bool)
            roidb.append(
                {
                    "image": im,
                    "height": im.shape[0],
                    "width": im.shape[1],
                    "boxes": boxes,
                    "gt_classes": classes,
                    "difficult": difficult,
                    "flipped": False,
                }
            )
        return roidb

    def evaluate_detections(self, all_boxes, output_dir: str):
        """Simple mean AP over the synthetic classes (VOC-style matching)."""
        from aznet_tpu_torch.eval.voc_eval import eval_detections_on_roidb

        return eval_detections_on_roidb(all_boxes, self.roidb, self.num_classes)
