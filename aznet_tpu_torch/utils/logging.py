"""Structured metric logging.

Counterpart of ``aznet_tpu/utils/logging.py``: stdout lines plus an
append-only JSONL file of scalars per step.
"""

from __future__ import annotations

import json
import os
import time
from typing import Optional


class MetricLogger:
    def __init__(self, output_dir: Optional[str] = None, name: str = "train"):
        self.path = None
        if output_dir:
            os.makedirs(output_dir, exist_ok=True)
            self.path = os.path.join(output_dir, f"{name}_metrics.jsonl")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, prefix: str = "") -> None:
        scalars = {k: float(v) for k, v in metrics.items()}
        msg = " ".join(f"{k}={v:.4f}" for k, v in scalars.items())
        print(f"[{prefix}{step}] {msg} (t={time.time() - self._t0:.0f}s)", flush=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps({"step": step, "t": time.time() - self._t0,
                                    **scalars}) + "\n")
