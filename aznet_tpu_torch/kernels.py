"""The port's hand-written CUDA kernels, each named once: a row's card entry
(``owner.<attr>``, looked up when called, so that whatever replaces it runs),
its plain version on the same arguments, its launch counter
(``ops.cuda.COUNTERS``) and the rule by which the two agree. :func:`recording`
copies the entries' calls, :func:`held` replays them through the plain
versions; the program calls neither."""

from __future__ import annotations

import contextlib
import functools
from collections import namedtuple
from typing import Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from aznet_tpu_torch.ops import conv1_fused, conv_int8, iou, nms, roi_pool
from aznet_tpu_torch.ops.cuda import (conv1_kernel, conv_int8_kernel, iou_kernel, launch_counts,
                                      nms_kernel, roi_align_kernel, set_launch_counts)
from aznet_tpu_torch.search import propose


def equal_bits(got: torch.Tensor, want: torch.Tensor):
    """(equal shapes, dtypes and bits: -0 is not +0, NaN is NaN; the share
    of elements that differ)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return False, 1.0
    if got.is_floating_point():
        got, want = (t.view(getattr(torch, f"int{8 * t.element_size()}")) for t in (got, want))
    differ = (got != want).float().mean().item() if got.numel() else 0.0
    return differ == 0.0, differ


class Kernel(NamedTuple):
    owner: object  # a module
    attr: str
    plain: Callable
    counter: str
    rule: Callable = equal_bits  # (got, want) -> (ok, share of elements that differ)
    writes: tuple = ()  # the arguments the entry writes, by position
    within: str | None = None  # first_only keeps the calls until that row's second

    @property
    def card(self) -> Callable:
        return getattr(self.owner, self.attr)


def _int8_plain(x, s_x, w_k, s_w, bias, s_out=None, out_dtype=torch.bfloat16, *, pool):
    layer = conv_int8.Int8Conv(w_k, s_w, bias)
    return conv_int8.conv3x3_int8_reference(x, s_x, layer, s_out, pool, out_dtype)


_ULP = conv1_fused.within_one_bf16_ulp
_conv1 = conv1_fused.conv1_2_pool_reference
KERNELS = {
    "nms": Kernel(nms_kernel, "nms_cuda_batched", nms.nms_mask_reference, "nms"),
    "roi_align": Kernel(roi_align_kernel, "roi_align_cuda", roi_pool.roi_align_fused_reference,
                        "roi_align"),
    "conv1": Kernel(conv1_kernel, "conv1_2_pool_cuda", lambda y, w_k, b: _conv1(
        y, conv1_fused.unpack_kernel_layout(w_k, y.shape[3], b.shape[0]), b), "conv1", _ULP),
    "conv1_f32": Kernel(conv1_kernel, "conv1_2_pool_cuda_f32", lambda y, w_k, b: _conv1(
        y, conv1_fused.unpack_kernel_layout_f32(w_k, b.shape[0]), b), "conv1_f32", _ULP),
    "chain": Kernel(conv_int8_kernel, "conv3x3_int8_chain",
                    functools.partial(_int8_plain, pool=True), "chain"),
    "strip": Kernel(conv_int8_kernel, "conv3x3_int8_strip",
                    functools.partial(_int8_plain, pool=False), "strip"),
    "iou": Kernel(iou_kernel, "bbox_overlaps_cuda", iou.bbox_overlaps, "iou"),
    "search_seed": Kernel(propose, "seed_cuda", propose.seed_plain, "search_select"),
    "search_level": Kernel(propose, "level_cuda", propose.level_plain, "search_level",
                           writes=(5, 6), within="search_seed"),
    "search_select": Kernel(propose, "select_cuda", propose.select_plain, "search_select"),
}


# Copies of a call's arguments, taken before it, and of what it returned and
# the arguments of Kernel.writes, taken after it.
Record = namedtuple("Record", "name args kwargs out written")


def _copy(v):
    """``v`` with every tensor in it copied, strides kept."""
    return tree_map(lambda t: torch.empty_strided(t.shape, t.stride(), dtype=t.dtype,
                                                  device=t.device).copy_(t.detach())
                    if isinstance(t, torch.Tensor) else t, v)


def _tensors(v) -> list:
    return [t for t in tree_leaves(v) if isinstance(t, torch.Tensor)]


@contextlib.contextmanager
def recording(names=None, first_only: bool = False, records: list | None = None):
    """While active, each call of the card entry of a row in ``names``
    (default: every row) appends a :class:`Record` to ``records`` (a new
    list if None), which this yields; with ``first_only``, only each entry's
    first call (and the calls :attr:`Kernel.within` keeps)."""
    records = [] if records is None else records
    real = {n: KERNELS[n].card for n in (KERNELS if names is None else names)}
    calls = dict.fromkeys(KERNELS, 0)

    def wrap(name, row, entry):
        def call(*args, **kwargs):
            calls[name] += 1
            if first_only and calls[row.within or name] > 1:
                return entry(*args, **kwargs)
            before = _copy((args, kwargs))
            out = entry(*args, **kwargs)
            written = tuple(_copy(args[i]) for i in row.writes)
            records.append(Record(name, *before, _copy(out), written))
            return out
        return call

    for name, entry in real.items():
        setattr(KERNELS[name].owner, KERNELS[name].attr, wrap(name, KERNELS[name], entry))
    try:
        yield records
    finally:
        for name, entry in real.items():
            setattr(KERNELS[name].owner, KERNELS[name].attr, entry)


def held(records) -> dict[str, dict]:
    """Replays each record through its row's plain version where its tensors
    lie, and applies the row's rule to what the entry returned and to the
    arguments it wrote. Per kernel: ``{"n": records, "ok", "err": max
    |kernel - plain|, "differ": the largest share of elements that differ,
    "shapes": of the first tensor argument}``. The launch counts are left as
    they were (a plain version may launch a kernel: the selection's NMS)."""
    counts, out = launch_counts(), {}
    try:
        for rec in records:
            row, args = KERNELS[rec.name], list(rec.args)
            for i in row.writes:
                args[i] = _copy(args[i])
            got = _tensors(rec.out) + list(rec.written)
            want = _tensors(row.plain(*args, **rec.kwargs)) + [args[i] for i in row.writes]
            s = out.setdefault(rec.name, {"n": 0, "ok": True, "err": 0.0, "differ": 0.0,
                                          "shapes": set()})
            s["n"] += 1
            s["ok"] &= len(got) == len(want)
            s["shapes"].add(next((tuple(a.shape) for a in _tensors(rec.args)), ()))
            for g, w in zip(got, want):
                same = g.shape == w.shape and g.numel() > 0
                ok, differ = row.rule(g, w) if same else equal_bits(g, w)
                # abs() of equal bits may be NaN - NaN
                err = (g.float() - w.float()).abs().nan_to_num(0.0).max().item() if same else 0.0
                s["ok"] &= bool(ok)
                s["differ"], s["err"] = max(s["differ"], differ), max(s["err"], err)
    finally:
        set_launch_counts(counts)
    return {k: {**s, "shapes": sorted(s["shapes"])} for k, s in out.items()}
