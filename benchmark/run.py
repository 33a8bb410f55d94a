#!/usr/bin/env python3
"""The benchmark of ``aznet_tpu_torch`` (the PyTorch and CUDA port): one run
of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload resnet50_1080p.propose_b4 --seed 7 --seconds 10 --trace 0

Run from the root of a checkout on a machine with an NVIDIA card. Prints, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device`` and, traced, ``breakdown``;
then ``checks``, each compared number with its limit, which are also the last
lines of standard error. Exits non-zero, printing no result, without a card,
or when a module of JAX or of the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
sys.path[:0] = [str(HERE), str(ROOT)]
# Kernel caches inside the checkout, at fixed paths.
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True, help="a cell's name in BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from harness import runner, spec

    cell = spec.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA device(s): is_available "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    result = runner.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                             torch.device("cuda", 0), T_START)
    leaked = runner.jax_modules()
    if leaked:
        print(f"modules of {leaked} were loaded in this process", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
