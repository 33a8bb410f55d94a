"""The port's spans (``aznet_tpu_torch/utils/profiling.py``): none outside a
``torch.profiler`` session; inside one, one tree a call with the layers'
spans under its root; the same outputs and the same torch operations with
spans on and off; the buffer's cap. Smallnet, float32, on the CPU (the
config of ``tests/test_torch_api.py``, with a 3-level search so that the
tail runs two levels)."""

import collections
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from aznet_tpu_torch import api
from aznet_tpu_torch.config import Config, cfg_from_dict
from aznet_tpu_torch.search.propose import frontier_schedule
from aznet_tpu_torch.utils import profiling

torch.set_num_threads(1)

CFG = cfg_from_dict(Config(), {
    "MODEL": {"BACKBONE": "smallnet", "FC_DIM": 32, "NUM_TEMPLATES": 5, "NUM_CLASSES": 4,
              "COMPUTE_DTYPE": "float32"},
    "SEAR": {"FRONTIER_CAP": 16, "CAND_BUF": 128, "MAX_LEVELS": 3, "NUM_PROPOSALS": 10},
    "TEST": {"SCALES": [64], "MAX_SIZE": 128},
})
CANVAS = (64, 128)
B = 2
ROOTS = {  # an entry: its root span and how many of each child the root has
    "propose_batch": ("propose", {"preprocess": 1, "trunk": 1, "search": B}),
    "detect_batch": ("detect", {"preprocess": 1, "trunk": 1, "heads": B}),
    "im_propose": ("im_propose", {"upload": 1, "propose": 1, "download": 1}),
    "im_detect": ("im_detect", {"upload": 1, "detect": 1, "download": 1}),
    "fused_detect": ("fused_detect", {"preprocess": 1, "trunk": 1, "search": B, "heads": B}),
}
IMAGES = {  # an entry: its calls' ``search`` and ``heads`` spans, one an image
    "propose_batch": {"search": B}, "detect_batch": {"heads": B}, "im_propose": {"search": 1},
    "im_detect": {"heads": 1}, "fused_detect": {"search": B, "heads": B},
}


@pytest.fixture(scope="module")
def entries():
    """Each entry as a function of no arguments on fixed inputs."""
    az = api.build_az_net(CFG, device="cpu", seed=3)
    fr = api.share_trunk(api.build_frcnn_net(CFG, device="cpu", seed=4), az)
    rng = np.random.RandomState(0)
    ims = rng.randint(0, 256, (B, 96, 128, 3)).astype(np.uint8)
    boxes = torch.from_numpy(np.asarray(
        [[[0, 0, 40, 30], [10, 20, 90, 60], [50, 5, 127, 95]]] * B, np.float32))
    src_hw = torch.tensor([[96.0, 128.0]] * B)
    scales = torch.tensor([api.compute_scale(96, 128, 64, 128)] * B)
    propose = api.make_propose_batch(az.model, CFG, CANVAS)
    detect = api.make_detect_batch(fr.model, CFG, CANVAS)
    fused = api.make_fused_detect_batch_padded(az.model, fr.model, CFG, CFG, CANVAS)
    return {
        "propose_batch": lambda: propose(torch.from_numpy(ims)),
        "detect_batch": lambda: detect(torch.from_numpy(ims), boxes),
        "im_propose": lambda: api.im_propose(az, ims[0, :90, :120]),
        "im_detect": lambda: api.im_detect(fr, ims[1, :90, :120], boxes[0].numpy()),
        "fused_detect": lambda: fused(torch.from_numpy(ims), src_hw, scales),
        "az": az,
    }


@pytest.fixture
def recorder(monkeypatch):
    rec = profiling.SpanRecorder()
    monkeypatch.setattr(profiling, "RECORDER", rec)
    return rec


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [torch.as_tensor(out)]


@pytest.mark.parametrize("entry", list(ROOTS))
def test_no_span_outside_a_profiler(entries, recorder, entry):
    entries[entry]()
    assert profiling.spans() == [] and profiling.dropped() == 0


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        t0 = time.perf_counter_ns()
        out = fn()
        t1 = time.perf_counter_ns()
    return out, t0, t1


@pytest.mark.parametrize("entry", list(ROOTS))
def test_spans_form_one_tree_a_call(entries, recorder, entry):
    calls = []
    for _ in range(2):
        _, t0, t1 = _traced(entries[entry])
        calls.append((t0, t1))
    spans = profiling.spans()
    by_id = {s.id: s for s in spans}
    roots = [s for s in spans if s.parent is None]
    root_name, children = ROOTS[entry]
    assert [r.name for r in roots] == [root_name, root_name]
    for root, (t0, t1) in zip(sorted(roots, key=lambda r: r.start), calls):
        assert t0 <= root.start <= root.end <= t1 and root.call == root.id
        got = collections.Counter(s.name for s in spans if s.parent == root.id)
        assert got == collections.Counter(children), got
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert p.start <= s.start <= s.end <= p.end, (p, s)
            assert s.call == p.call
    for name in ("search", "heads"):
        for root in roots:
            images = sorted(s.attrs["image"] for s in spans
                            if s.name == name and s.call == root.id)
            assert images == list(range(IMAGES[entry].get(name, 0))), (name, images)


def test_search_spans_follow_the_levels_run(entries, recorder, monkeypatch):
    """A ``search.level`` per head call of the image, with its level and the
    rows the head evaluated; a ``search.sync`` per tail level entered; one
    ``search.select``."""
    model = entries["az"].model
    rows = []
    fn = model.roi_forward

    def roi_forward(feat, rois, *args, **kwargs):
        rows.append(rois.shape[0])
        return fn(feat, rois, *args, **kwargs)

    monkeypatch.setattr(model, "roi_forward", roi_forward)
    _traced(entries["propose_batch"])
    spans = profiling.spans()
    sched = frontier_schedule(CFG.SEAR)
    unrolled = sum(1 for c in sched if c != CFG.SEAR.FRONTIER_CAP)
    searches = sorted((s for s in spans if s.name == "search"), key=lambda s: s.start)
    assert len(searches) == B
    seen = 0
    for search in searches:
        under = collections.defaultdict(list)
        for s in spans:
            if s.parent == search.id:
                under[s.name].append(s)
        levels = sorted(under["search.level"], key=lambda s: s.start)
        n = len(levels)
        assert [s.attrs["level"] for s in levels] == list(range(n))
        assert [s.attrs["rows"] for s in levels] == rows[seen:seen + n]
        seen += n
        tail = n - unrolled
        rem = CFG.SEAR.MAX_LEVELS - unrolled
        assert len(under["search.sync"]) == tail + (tail < rem)
        assert len(under["search.select"]) == 1
        assert set(under) == {"search.level", "search.sync", "search.select"}
    assert seen == len(rows) and seen > B * unrolled  # the tail ran


@pytest.mark.parametrize("entry", list(ROOTS))
def test_outputs_and_operations_are_the_same_on_and_off(entries, recorder, entry):
    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    with Count() as off:
        out_off = entries[entry]()
    assert profiling.spans() == []
    with Count() as on:
        out_on, _, _ = _traced(entries[entry])
    assert profiling.spans()
    assert on.ops == off.ops and sum(on.ops.values()) > 0
    a, b = _flat(out_off), _flat(out_on)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_buffer_drops_the_oldest_past_its_cap(monkeypatch):
    rec = profiling.SpanRecorder(cap=4)
    monkeypatch.setattr(profiling, "RECORDER", rec)
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            for i in range(9):
                with profiling.span("inner", image=i):
                    pass
    got = profiling.spans()
    assert [s.name for s in got] == ["inner"] * 3 + ["outer"]
    assert [s.attrs.get("image") for s in got[:3]] == [6, 7, 8]
    assert profiling.dropped() == 6
    assert all(s.parent == got[-1].id for s in got[:3])


def test_span_off_is_one_shared_context():
    assert profiling.span("a", image=1) is profiling.span("b")
