"""One image a call through the program's one-image API: a raw NumPy image
in, NumPy proposals ``[n, 5]`` out; the program picks its own canvas."""

from __future__ import annotations

import torch

from harness import check, inputs
from harness.driver import Driver as Base
from reference import nets


class Driver(Base):
    kind = "az"
    middle_span = "search"

    def setup(self) -> None:
        t = self.traffic
        if t["batch"] != 1:
            raise ValueError(f"the one-image API takes one image a call, not {t['batch']}")
        self.images = inputs.host_images(self.seed, t["pool_batches"], t["image_hw"])
        h, w = t["image_hw"]
        test = self.conf["TEST"]
        self.canvas = nets.canvas_for(h, w, test["SCALES"][0], test["MAX_SIZE"])
        self.build_system()
        self.warm_up()

    def call(self, k: int):
        out = self.system.im_propose(self.images[k % len(self.images)])
        self.stamp()  # the API copies its proposals to the host itself
        return out

    @staticmethod
    def result_of(out, i: int):
        return out

    def numbers(self, ref, k: int, i: int, result) -> dict:
        image = torch.from_numpy(self.images[k % len(self.images)])
        n, total = result.shape[0], self.conf["SEAR"]["NUM_PROPOSALS"]
        boxes = torch.zeros((total, 4))
        scores = torch.zeros(total)
        valid = torch.arange(total) < n
        boxes[:n] = torch.from_numpy(result[:, :4])
        scores[:n] = torch.from_numpy(result[:, 4])
        return check.propose_numbers(ref, image, self.canvas, boxes, scores, valid,
                                     self.cell.limits[check.BAND_KEY])
