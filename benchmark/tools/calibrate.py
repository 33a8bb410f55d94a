#!/usr/bin/env python3
"""Read a cell's compared numbers over many seeds in one process: the
program's, and the lower-precision control's (the reference in the
program's place, ``reference/lowp.py``). One JSON line a run. The limits in
``limits/<cell>.json`` are set from these readings (``PERF.md``); with
``--bands`` a propose cell's numbers are read at each of several zoom bands
(``harness/check.py``) on the same run.

    python3 benchmark/tools/calibrate.py --workload resnet50_1080p.propose_b4 \\
        --seeds 11,12,13 --control-seeds 21,22,23 --seconds 3 --bands 0.005,0.01
"""

import argparse
import functools
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]


def main(argv=None) -> int:
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
    args = p.parse_args(argv)

    import torch

    from harness import check, runner, spec
    from harness.system import PortSystem, ReferenceSystem, reverse_frontier_top_k

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    runs = [("program", s, PortSystem) for s in args.seeds.split(",") if s]
    runs += [("reversed_top_k", s, PortSystem) for s in args.fault_seeds.split(",") if s]
    for rounding in args.control.split(","):
        control = functools.partial(ReferenceSystem, rounding=rounding)
        runs += [(f"reference_{rounding}", s, control) for s in args.control_seeds.split(",") if s]
    bands = [float(b) for b in args.bands.split(",") if b] or [cell.limits.get(check.BAND_KEY)]
    for side, seed, system in runs:
        t0 = time.perf_counter()
        undo = (reverse_frontier_top_k(cell.conf["SEAR"]["CAND_BUF"]) if side == "reversed_top_k"
                else lambda: None)
        r, driver, sample, _ = runner.measure(cell, int(seed), args.seconds, False, dev, t0,
                                              system_cls=system)
        undo()
        t1 = time.perf_counter()
        numbers = {}
        for band in bands:
            cell.limits[check.BAND_KEY] = band
            numbers[str(band)] = runner.judge(cell, int(seed), dev, driver, sample)
        print(json.dumps({"workload": cell.name, "side": side, "seed": int(seed),
                          "attempted": r["attempted"], "failed": r["failed"], "numbers": numbers,
                          "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                          "seconds": t1 - t0, "judge_s": time.perf_counter() - t1}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
