"""Port parity, the host modules: the host library (``utils/native.py`` over
``csrc/host.cc``), the host NMS, the NumPy box math, the host preprocess and
the box helpers, each against the JAX package on the same NumPy inputs.

Tolerances:
- exact: NMS keep lists (the library and the NumPy loop), the IoU matrix
  and the COCO matcher against the reference's NumPy tiers, ``np_boxes``,
  ``box_area`` / ``flip_boxes`` / ``scale_boxes``, ``prep_im_for_blob`` on
  both branches (cv2, and the NumPy resize with cv2 blocked),
  ``im_list_to_blob``, ``canvas_shape``;
- ``prep_blob`` against ``prep_im_for_blob``: 0.51 (cv2 resizes in fixed
  point), as the reference's own test; bit-equal to the reference's source
  built with the port's flags; within 1e-4 of the reference's Makefile build
  (``-march=native``: GCC contracts the bilinear blend into FMAs, measured
  3.05e-5 on values in [-123, 153]).
"""

import importlib
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aznet_tpu.ops import boxes as jboxes
from aznet_tpu.utils import native as jnative
from aznet_tpu.utils import np_boxes as jnp_boxes
from aznet_tpu_torch.ops import boxes as tboxes
from aznet_tpu_torch.ops import nms as tnms
from aznet_tpu_torch.ops import preprocess as tprep
from aznet_tpu_torch.utils import native, np_boxes

torch.set_num_threads(1)

# The packages' ``__init__`` re-export functions named like these modules.
jnms = importlib.import_module("aznet_tpu.ops.nms")
jprep = importlib.import_module("aznet_tpu.ops.preprocess")
jcoco = importlib.import_module("aznet_tpu.eval.coco_eval")
tcoco = importlib.import_module("aznet_tpu_torch.eval.coco_eval")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEANS = (102.9801, 115.9465, 122.7717)


def _dets(seed, n, ties=False, degenerate=False, grid=False):
    """``[n, 5]`` float32 detections: boxes at 0..500 with wh 5..200;
    ``ties``: scores on 5 levels; ``degenerate``: every 5th box has a width
    of -1, -0.5 or -3 (zero, small or negative area at offset 1); ``grid``:
    integer coordinates."""
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 500, (n, 2))
    wh = rng.uniform(5, 200, (n, 2))
    if grid:
        xy, wh = np.floor(xy), np.floor(wh)
    if degenerate:
        wh[::5, 0] = rng.choice([-1.0, -0.5, -3.0], len(wh[::5]))
    s = (np.floor(rng.rand(n) * 5) / 5 if ties else rng.permutation(n) / max(n, 1))
    return np.concatenate([xy, xy + wh, s[:, None]], 1).astype(np.float32)


def _jax_nms(dets, thresh, offset, tier, monkeypatch):
    """The reference's ``nms`` through its library tier or its NumPy loop."""
    if tier == "np":
        monkeypatch.setattr(jnative, "available", lambda: False)
    try:
        with np.errstate(invalid="ignore"):
            return jnms.nms(dets, thresh, offset=offset)
    finally:
        monkeypatch.undo()


NMS_CASES = [  # seed, n, ties, degenerate, grid, thresh, offset
    (3, 1, False, False, False, 0.3, 1.0),
    (3, 17, False, False, False, 0.7, 1.0),
    (4, 200, False, False, False, 0.3, 1.0),
    (5, 1000, False, False, False, 0.7, 1.0),
    (6, 300, True, False, False, 0.5, 1.0),
    (7, 300, True, False, True, 0.3, 0.0),
    (8, 200, False, True, False, 0.5, 1.0),
    (9, 200, False, True, True, 0.4, 0.0),
    (10, 500, False, False, True, 0.0, 0.0),
]


@pytest.mark.parametrize("seed,n,ties,degenerate,grid,thresh,offset", NMS_CASES)
def test_nms_matches_reference(monkeypatch, seed, n, ties, degenerate, grid, thresh, offset):
    """Both of the port's tiers against the reference's NumPy loop, which
    needs no library: the port's NumPy loop on every case, the port's library
    where no pair's union is 0. Two zero-area boxes have a union of 0: the
    library skips a pair with no overlap, the NumPy loop divides 0 by 0 and
    drops the NaN, so only the degenerate cases tell the tiers apart."""
    dets = _dets(seed, n, ties, degenerate, grid)
    want_np = _jax_nms(dets, thresh, offset, "np", monkeypatch)
    with np.errstate(invalid="ignore"):
        assert tnms.nms_np(dets, thresh, offset) == want_np
    got = tnms.nms(dets, thresh, offset)
    assert 0 < len(got) <= n
    if not degenerate:
        assert got == want_np


@pytest.mark.skipif(not jnative.available(), reason="the reference's host library is not built")
@pytest.mark.parametrize("seed,n,ties,degenerate,grid,thresh,offset", NMS_CASES)
def test_nms_library_matches_reference_library(monkeypatch, seed, n, ties, degenerate, grid,
                                               thresh, offset):
    """The port's library equals the reference's library tier on every case,
    the degenerate ones included."""
    dets = _dets(seed, n, ties, degenerate, grid)
    assert tnms.nms(dets, thresh, offset) == _jax_nms(dets, thresh, offset, "lib", monkeypatch)


def test_nms_empty():
    empty = np.zeros((0, 5), np.float32)
    assert tnms.nms(empty, 0.3) == tnms.nms_np(empty, 0.3) == jnms.nms(empty, 0.3) == []
    assert native.nms(empty, 0.3) == []
    with pytest.raises(ValueError, match=r"\[N, 5\]"):
        native.nms(np.zeros((3, 4), np.float32), 0.3)


@pytest.mark.parametrize("offset", [1.0, 0.0])
def test_bbox_overlaps_equals_numpy(offset):
    rng = np.random.RandomState(5)
    a = rng.uniform(0, 100, (50, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rng.uniform(1, 50, (50, 2))
    b = rng.uniform(0, 100, (20, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(1, 50, (20, 2))
    got = native.bbox_overlaps(a, b, offset)
    assert got.dtype == np.float32 and got.shape == (50, 20)
    assert (got == 0).any() and (got > 0).any()
    np.testing.assert_array_equal(got, jnp_boxes.iou_np(a, b, offset))
    assert native.bbox_overlaps(a[:0], b, offset).shape == (0, 20)


def _coco_case(seed):
    """A random ``_match_image`` input: IoUs on a coarse grid (ties), gts
    sorted ignored-last, some crowds."""
    rng = np.random.RandomState(seed)
    n_d, n_g = rng.randint(0, 12), rng.randint(0, 8)
    ious = np.round(rng.uniform(0, 1, (n_d, n_g)) * 20) / 20
    ignore = np.sort(rng.rand(n_g) < 0.3)
    crowd = ignore & (rng.rand(n_g) < 0.5)
    return ious, ignore, crowd


@pytest.mark.parametrize("seed", range(4))
def test_coco_match_equals_numpy_tiers(seed):
    for s in range(seed * 50, seed * 50 + 50):
        ious, ignore, crowd = _coco_case(s)
        thrs = np.minimum(jcoco.IOU_THRS, 1.0 - 1e-10)
        want = jcoco._match_image_np(ious, ignore, crowd, thrs) if ious.size else None
        ref = jcoco._match_image_ref(ious, ignore, crowd, jcoco.IOU_THRS)
        got = tcoco._match_image(ious, ignore, crowd, jcoco.IOU_THRS)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
        if want is not None:
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)
            for g, w in zip(tcoco._match_image_np(ious, ignore, crowd, thrs), want):
                np.testing.assert_array_equal(g, w)
        for g, r in zip(tcoco._match_image_ref(ious, ignore, crowd, jcoco.IOU_THRS), ref):
            np.testing.assert_array_equal(g, r)


def _prep_inputs():
    rng = np.random.RandomState(7)
    return [(rng.randint(0, 256, hw + (3,)).astype(np.uint8), target, max_size)
            for hw, target, max_size in (((120, 160), 180, 300), ((375, 500), 600, 1000),
                                         ((50, 70), 40, 60))]


def test_prep_blob_matches_prep_im_for_blob():
    for im, target, max_size in _prep_inputs():
        want, scale = tprep.prep_im_for_blob(im, MEANS, target, max_size)
        oh, ow = tprep.canvas_shape(target, max_size)
        got = native.prep_blob(im, oh, ow, scale, MEANS)
        h, w = want.shape[:2]
        np.testing.assert_allclose(got[:h, :w], want, atol=0.51, rtol=0)
        assert (got[h:] == 0).all() and (got[:, w:] == 0).all()


def test_prep_blob_is_the_reference_code(tmp_path):
    """Bit-equal to the reference's ``csrc/aznet_host.cc`` built with the
    port's flags (the same code), and within 1e-4 of the reference's own
    Makefile build where it exists (module docstring)."""
    ref = tmp_path / "libref.so"
    subprocess.run([native.CXX, *native.CXX_FLAGS, "-o", str(ref),
                    os.path.join(REPO, "csrc", "aznet_host.cc")], check=True)
    import ctypes

    lib = ctypes.CDLL(str(ref))
    makefile_build = os.path.join(REPO, "csrc", "build", "libaznet_host.so")
    for im, target, max_size in _prep_inputs():
        scale = tprep.compute_scale(im.shape[0], im.shape[1], target, max_size)
        oh, ow = tprep.canvas_shape(target, max_size)
        got = native.prep_blob(im, oh, ow, scale, MEANS)
        want = np.empty_like(got)
        fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))  # noqa: E731
        lib.az_prep_blob(im.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), im.shape[0],
                         im.shape[1], fp(want), oh, ow, ctypes.c_float(scale),
                         fp(np.asarray(MEANS, np.float32)))
        np.testing.assert_array_equal(got, want)
        if os.path.exists(makefile_build):
            np.testing.assert_allclose(got, jnative.prep_blob(im, oh, ow, scale, MEANS),
                                       atol=1e-4, rtol=0)


def test_np_boxes_exact():
    rng = np.random.RandomState(1)
    a = rng.uniform(0, 300, (30, 4)).astype(np.float32)
    a[:, 2:] = a[:, :2] + rng.uniform(-2, 80, (30, 2))
    b = rng.uniform(0, 300, (12, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(1, 80, (12, 2))
    for off in (1.0, 0.0):
        np.testing.assert_array_equal(np_boxes.area_np(a, off), jnp_boxes.area_np(a, off))
        np.testing.assert_array_equal(np_boxes.intersection_np(a, b, off),
                                      jnp_boxes.intersection_np(a, b, off))
        np.testing.assert_array_equal(np_boxes.iou_np(a, b, off), jnp_boxes.iou_np(a, b, off))
        np.testing.assert_array_equal(np_boxes.bbox_transform_np(b, b[::-1], off),
                                      jnp_boxes.bbox_transform_np(b, b[::-1], off))
    assert np_boxes.iou_np(a[:0], b).shape == (0, 12)


@pytest.mark.parametrize("branch", ["cv2", "numpy"])
def test_host_preprocess_matches(monkeypatch, branch):
    if branch == "numpy":
        monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises ImportError
    else:
        pytest.importorskip("cv2")
    ims = []
    for im, target, max_size in _prep_inputs():
        got, g_scale = tprep.prep_im_for_blob(im, MEANS, target, max_size)
        want, w_scale = jprep.prep_im_for_blob(im, MEANS, target, max_size)
        assert g_scale == w_scale
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype  # float64 on the NumPy branch, as the reference
        ims.append(got)
        assert tprep.canvas_shape(target, max_size) == jprep.canvas_shape(target, max_size)
    np.testing.assert_array_equal(tprep.im_list_to_blob(ims), jprep.im_list_to_blob(ims))
    np.testing.assert_array_equal(tprep._resize_bilinear_np(ims[0], 33, 47),
                                  jprep._resize_bilinear_np(ims[0], 33, 47))


def test_box_helpers_exact():
    rng = np.random.RandomState(2)
    b = rng.uniform(0, 400, (3, 7, 4)).astype(np.float32)
    t = torch.from_numpy(b)
    for off in (1.0, 0.0):
        np.testing.assert_array_equal(tboxes.box_area(t, off).numpy(),
                                      np.asarray(jboxes.box_area(jnp.asarray(b), off)))
        np.testing.assert_array_equal(tboxes.flip_boxes(t, 500.0, off).numpy(),
                                      np.asarray(jboxes.flip_boxes(jnp.asarray(b), 500.0, off)))
    np.testing.assert_array_equal(tboxes.scale_boxes(t, 1.6).numpy(),
                                  np.asarray(jboxes.scale_boxes(jnp.asarray(b), 1.6)))


def test_library_builds_under_build_and_never_opens_csrc_build():
    """In a fresh process without JAX: the port's host calls load the
    library built under ``build/aznet_tpu_torch/host-<hash>/``, and no
    library from ``csrc/build/`` is mapped."""
    code = textwrap.dedent("""
        import sys
        for name in ("jax", "jaxlib", "flax"):
            sys.modules[name] = None
        import numpy as np
        from aznet_tpu_torch.ops.nms import nms
        from aznet_tpu_torch.utils import native
        from aznet_tpu_torch.eval.coco_eval import _match_image
        dets = np.array([[0, 0, 9, 9, .9], [1, 1, 9, 9, .8], [50, 50, 60, 60, .7]], np.float32)
        assert nms(dets, 0.5) == [0, 2]
        _match_image(np.ones((1, 1)), np.zeros(1, bool), np.zeros(1, bool), [0.5])
        native.prep_blob(np.zeros((4, 4, 3), np.uint8), 8, 8, 2.0, (1, 2, 3))
        maps = [l.split()[-1] for l in open("/proc/self/maps") if "libaznet" in l]
        print("\\n".join(sorted(set(maps))))
        assert not any(m.split(".")[0] == "aznet_tpu" for m in sys.modules)
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         env=dict(os.environ, PYTHONPATH=REPO), timeout=300)
    assert res.returncode == 0, res.stderr
    libs = res.stdout.split()
    build = os.path.join(REPO, "build", "aznet_tpu_torch")
    assert len(libs) == 1 and libs[0].startswith(build + os.sep + "host-"), libs
    assert libs[0] == str(native.build())
    assert not any(os.path.join("csrc", "build") in lib for lib in libs)


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_ROOT", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host library build failed"):
        native.build()
    monkeypatch.setattr(native, "CXX", "no-such-compiler-aznet")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
