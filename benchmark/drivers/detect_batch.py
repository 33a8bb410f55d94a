"""Batched detection on given proposals: ``fn(images [B, H, W, 3] uint8,
boxes [B, R, 4])`` of the program's batched detect entry on the
configuration's canvas, images and boxes on the card, class probabilities
and decoded boxes copied to the host each call."""

from __future__ import annotations

import torch

from harness import check, inputs
from harness.driver import Driver as Base


class Driver(Base):
    kind = "frcnn"
    middle_span = "heads"

    def setup(self) -> None:
        t = self.traffic
        n = t["pool_batches"] * t["batch"]
        self.images = inputs.device_images(self.seed, n, t["image_hw"], self.device)
        self.boxes = torch.from_numpy(inputs.given_boxes(
            self.seed, n, t["rois"], t["image_hw"], t["side_min"], t["aspect"])).to(self.device)
        self.canvas = tuple(self.conf["canvas"])
        self.build_system()
        self.fn = self.system.detect_batch(self.canvas)
        self.warm_up()

    def span_modules(self) -> dict:
        return {"trunk": self.system.trunk, "head": self.system.head}

    def rows(self, k: int):
        b = self.images_per_call
        j = k % self.traffic["pool_batches"]
        return slice(j * b, (j + 1) * b)

    def call(self, k: int):
        s = self.rows(k)
        scores, pred = self.fn(self.images[s], self.boxes[s])
        self.stamp()
        return scores.cpu(), pred.cpu()

    def numbers(self, ref, k: int, i: int, result) -> dict:
        s = self.rows(k)
        return check.detect_numbers(ref, self.images[s][i], self.canvas, self.boxes[s][i], *result)
