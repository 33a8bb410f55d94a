"""The benchmark's CPU tests: ``python -m pytest benchmark/tests -q`` from the
root of the repository. Tests that need the card carry the ``cuda`` marker
and skip without one."""

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

from harness import spec  # noqa: E402
from reference import nets  # noqa: E402

TINY_SEAR = {"MAX_LEVELS": 3, "FRONTIER_CAP": 16, "CAND_BUF": 256, "NUM_PROPOSALS": 50}
# The propose cells' limit at this size, between the program's readings
# (0.0042-0.0087 over three seeds a cell) and the lower-precision control's
# (0.0596-0.5077); the detect cell's limit file holds at this size too.
TINY_PROPOSE_LIMITS = {"proposal_gap": 0.02, "zoom_band": 0.2}


PINS_DIR = BENCH / "tests" / "pins"


def pin_path(name: str) -> Path:
    """The cell's pin file: what the benchmark reads of it, written by
    ``tools/fingerprint.py --workload <cell> --pin``."""
    return PINS_DIR / f"{name}.json"


def network_cells() -> dict:
    """``{(network, kind): the first cell of BENCHMARK.json that runs it}``."""
    out = {}
    for w in spec.load_bench()["workloads"]:
        cell = spec.load_cell(w["name"])
        out.setdefault((cell.conf["MODEL"]["BACKBONE"], spec.driver_class(cell).kind), cell.name)
    return out


def tiny_cell(name: str) -> spec.Cell:
    """A cell of BENCHMARK.json cut to a CPU test's size: its network's
    ``TINY`` settings (VGG-16 at an eighth of its widths, ResNet-50 whole;
    fc6/fc7 64 wide), a 3-level search, 60x80 images on a 64x96 canvas, 1 to
    2 images a call. Its limits are its pin file's ``tiny_limits`` where it
    has them, else ``TINY_PROPOSE_LIMITS`` for a propose cell and its limits
    file for a detect cell."""
    cell = spec.load_cell(name)
    conf = copy.deepcopy(cell.conf)
    conf["MODEL"].update(nets.network(conf["MODEL"]).TINY)
    conf["SEAR"].update(TINY_SEAR)
    conf["TEST"].update(SCALES=[64], MAX_SIZE=128)
    conf["canvas"] = [64, 96]
    traffic = dict(cell.traffic)
    traffic.update(image_hw=[60, 80], pool_batches=2, check_images=3, trace_calls=2,
                   batch=1 if traffic["driver"] == "im_propose" else 2)
    if "rois" in traffic:
        traffic["rois"] = 20
    cell.conf, cell.traffic = conf, traffic
    pinned = pin_path(name)
    pinned = json.loads(pinned.read_text()) if pinned.exists() else {}
    if "tiny_limits" in pinned:
        cell.limits = dict(pinned["tiny_limits"])
    elif "proposal_gap" in cell.limits:
        cell.limits = dict(TINY_PROPOSE_LIMITS)
    return cell


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda", 0)
