"""Batched proposals: ``fn(images [B, H, W, 3] uint8)`` of the program's
batched propose entry on the configuration's canvas, the images on the card,
the proposals (boxes, scores, valid flags) copied to the host each call."""

from __future__ import annotations

from harness import check, inputs
from harness.driver import Driver as Base


class Driver(Base):
    kind = "az"
    middle_span = "search"

    def setup(self) -> None:
        t = self.traffic
        n = t["pool_batches"] * t["batch"]
        self.images = inputs.device_images(self.seed, n, t["image_hw"], self.device)
        self.canvas = tuple(self.conf["canvas"])
        self.build_system()
        self.fn = self.system.propose_batch(self.canvas)
        self.warm_up()

    def batch(self, k: int):
        b = self.images_per_call
        j = k % self.traffic["pool_batches"]
        return self.images[j * b:(j + 1) * b]

    def call(self, k: int):
        boxes, scores, valid = self.fn(self.batch(k))
        self.stamp()
        return boxes.cpu(), scores.cpu(), valid.cpu()

    def numbers(self, ref, k: int, i: int, result) -> dict:
        return check.propose_numbers(ref, self.batch(k)[i], self.canvas, *result,
                                     self.cell.limits[check.BAND_KEY])
