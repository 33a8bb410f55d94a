#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process: the
program's, the lower-precision control's (the reference in the program's
place, ``reference/lowp.py``) and a planted fault's. One JSON line a run,
with ``correct`` at the cell's own limits. The limits in
``limits/<cell>.json`` are set from these readings (``PERF.md``); with
``--bands`` a propose cell's numbers are read at each of several zoom bands
(``harness/check.py``) on the same run.

    python3 benchmark/tools/calibrate.py --workload resnet50_1080p.propose_b4 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --fault-seeds 31,32 --seconds 3

A fault's run that reads ``correct`` at the cell's limits is a fault the
check does not catch, whether it was not planted where the program runs or
is too weak for the limits: the tool names it and the seed and exits 1.
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--control", default="fp8",
                   help="roundings of the reference in the program's place, comma-separated "
                        "(reference/lowp.py: fp8 is the control, bf16 a witness)")
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--fault-seeds", default="",
                   help="seeds of runs of the program with its frontier's top-k reversed")
    p.add_argument("--bands", default="", help="zoom bands to read a propose cell's numbers at")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)

    import torch

    from harness import spec

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    return calibrate(spec.load_cell(args.workload), args, torch.device("cuda", 0))


def calibrate(cell, args: argparse.Namespace, dev) -> int:
    """The runs ``args`` asks for, one JSON line each; 1 where a fault's run
    reads ``correct``."""
    import torch

    from harness import check, runner
    from harness.system import PortSystem, ReferenceSystem, reverse_frontier_top_k

    runs = [("program", s, PortSystem) for s in args.seeds.split(",") if s]
    runs += [("reversed_top_k", s, PortSystem) for s in args.fault_seeds.split(",") if s]
    for rounding in args.control.split(","):
        control = functools.partial(ReferenceSystem, rounding=rounding)
        runs += [(f"reference_{rounding}", s, control) for s in args.control_seeds.split(",") if s]
    own_band = cell.limits.get(check.BAND_KEY)
    bands = [float(b) for b in args.bands.split(",") if b] or [own_band]
    if own_band not in bands:
        bands.append(own_band)
    missed = []
    for side, seed, system in runs:
        t0 = time.perf_counter()
        undo = (reverse_frontier_top_k(cell.conf["SEAR"]["CAND_BUF"]) if side == "reversed_top_k"
                else lambda: None)
        try:
            r, driver, sample, _ = runner.measure(cell, int(seed), args.seconds, False, dev, t0,
                                                  system_cls=system)
        finally:
            undo()
        t1 = time.perf_counter()
        numbers = {}
        for band in bands:
            cell.limits[check.BAND_KEY] = band
            numbers[str(band)] = runner.judge(cell, int(seed), dev, driver, sample)
        cell.limits[check.BAND_KEY] = own_band
        own = numbers[str(own_band)]
        correct = check.verdict({k: v for k, v in own.items() if k in cell.limits},
                                cell.limits)[0] and r["failed"] == 0
        if correct and side == "reversed_top_k":
            missed.append(seed)
        print(json.dumps({"workload": cell.name, "side": side, "seed": int(seed),
                          "attempted": r["attempted"], "failed": r["failed"], "correct": correct,
                          "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "seconds": t1 - t0, "judge_s": time.perf_counter() - t1}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    for seed in missed:
        print(f"the fault reversed_top_k reads correct on seed {seed}: the check does not "
              f"catch it", file=sys.stderr)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
