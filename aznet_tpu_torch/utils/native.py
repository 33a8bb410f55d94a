"""ctypes bindings of the port's host library (``aznet_tpu_torch/csrc/host.cc``).

Counterpart of ``aznet_tpu/utils/native.py``, with the same contracts:
greedy NMS, the IoU matrix, the COCO greedy matcher and the fused image
blob. The library is the port's own copy of the reference's host code, built
at first use in a process with the host C++ compiler::

    c++ -O3 -fPIC -std=c++17 -ffp-contract=off -shared -pthread

into ``build/aznet_tpu_torch/host-<hash>/`` under the repository root, keyed
by a hash of the source and the flags. ``-ffp-contract=off`` and no
``-march=native``: GCC contracts floating point by default, so with FMA
enabled it may fuse the bilinear blend of ``az_prep_blob`` and round apart
from the NumPy resize. A missing compiler or a failed build raises; nothing
falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from .._build import BUILD_ROOT

SRC = Path(__file__).resolve().parent.parent / "csrc" / "host.cc"
LIB_NAME = "libaznet_host.so"
CXX = "c++"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-ffp-contract=off", "-shared", "-pthread")


def build() -> Path:
    """Compile ``host.cc`` if this hash has no library yet; return its path."""
    digest = hashlib.sha256(" ".join((CXX,) + CXX_FLAGS).encode() + SRC.read_bytes())
    out_dir = BUILD_ROOT / f"host-{digest.hexdigest()[:16]}"
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"host C++ compiler {CXX!r} not found") from e
    if res.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"host library build failed:\n{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees a partial file
    return lib_path


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    f32p, f64p = ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_double)
    u8p, i32p = ctypes.POINTER(ctypes.c_ubyte), ctypes.POINTER(ctypes.c_int)
    c_int, c_float = ctypes.c_int, ctypes.c_float
    lib.az_nms.restype = c_int
    lib.az_nms.argtypes = [f32p, c_int, c_float, c_float, i32p]
    lib.az_bbox_overlaps.restype = None
    lib.az_bbox_overlaps.argtypes = [f32p, c_int, f32p, c_int, c_float, f32p]
    lib.az_prep_blob.restype = None
    lib.az_prep_blob.argtypes = [u8p, c_int, c_int, f32p, c_int, c_int, c_float, f32p]
    lib.az_coco_match.restype = None
    lib.az_coco_match.argtypes = [f64p, c_int, c_int, u8p, u8p, f64p, c_int, u8p, u8p]
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _rows(a, width: int, dtype, name: str) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype)
    if a.ndim != 2 or a.shape[1] != width:
        raise ValueError(f"{name} must be [N, {width}], got {a.shape}")
    return a


def nms(dets: np.ndarray, thresh: float, offset: float = 1.0) -> list:
    """Greedy NMS over ``dets [N, 5]``; the contract of ``ops.nms.nms``:
    kept indices, highest score first, ties to the lower index."""
    dets = _rows(dets, 5, np.float32, "dets")
    n = dets.shape[0]
    if n == 0:
        return []
    keep = np.empty(n, np.int32)
    count = _lib().az_nms(_ptr(dets, ctypes.c_float), n, float(thresh), float(offset),
                          _ptr(keep, ctypes.c_int))
    return keep[:count].tolist()


def bbox_overlaps(boxes: np.ndarray, query: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """IoU matrix ``[N, K]`` float32 of ``boxes [N, 4]`` and ``query [K, 4]``."""
    boxes = _rows(boxes, 4, np.float32, "boxes")
    query = _rows(query, 4, np.float32, "query")
    out = np.empty((boxes.shape[0], query.shape[0]), np.float32)
    _lib().az_bbox_overlaps(_ptr(boxes, ctypes.c_float), boxes.shape[0],
                            _ptr(query, ctypes.c_float), query.shape[0], float(offset),
                            _ptr(out, ctypes.c_float))
    return out


def coco_match(ious: np.ndarray, gt_ignore: np.ndarray, crowd: np.ndarray, thrs: np.ndarray):
    """COCO greedy matcher; the contract of ``eval.coco_eval._match_image``.
    ``thrs`` must already be clamped (``min(t, 1 - 1e-10)``) by the caller.
    Returns ``(dt_match [T, D], dt_ignore [T, D])`` bool."""
    ious = np.ascontiguousarray(ious, np.float64)
    if ious.ndim != 2:
        raise ValueError(f"ious must be [D, G], got {ious.shape}")
    n_d, n_g = ious.shape
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    cr = np.ascontiguousarray(crowd, np.uint8)
    if gi.shape != (n_g,) or cr.shape != (n_g,):
        raise ValueError(f"gt_ignore {gi.shape} and crowd {cr.shape} must be [{n_g}]")
    thrs = np.ascontiguousarray(thrs, np.float64).reshape(-1)
    n_t = thrs.shape[0]
    dtm = np.empty((n_t, n_d), np.uint8)
    dtig = np.empty((n_t, n_d), np.uint8)
    _lib().az_coco_match(_ptr(ious, ctypes.c_double), n_d, n_g, _ptr(gi, ctypes.c_ubyte),
                         _ptr(cr, ctypes.c_ubyte), _ptr(thrs, ctypes.c_double), n_t,
                         _ptr(dtm, ctypes.c_ubyte), _ptr(dtig, ctypes.c_ubyte))
    return dtm.astype(bool), dtig.astype(bool)


def prep_blob(im: np.ndarray, out_h: int, out_w: int, scale: float, means) -> np.ndarray:
    """Fused uint8 BGR ``[H, W, 3]`` -> mean-subtracted, bilinear-resized
    (half-pixel centres) float32 ``[out_h, out_w, 3]`` canvas, zero past
    ``round(H * scale) x round(W * scale)``."""
    im = np.ascontiguousarray(im, np.uint8)
    if im.ndim != 3 or im.shape[2] != 3 or min(im.shape[:2]) < 1:
        raise ValueError(f"im must be [H, W, 3] with H, W >= 1, got {im.shape}")
    m = np.ascontiguousarray(means, np.float32)
    if m.shape != (3,) or out_h < 0 or out_w < 0 or not scale > 0:
        raise ValueError(f"bad means {m.shape}, canvas {out_h}x{out_w} or scale {scale}")
    out = np.empty((out_h, out_w, 3), np.float32)
    _lib().az_prep_blob(_ptr(im, ctypes.c_ubyte), im.shape[0], im.shape[1],
                        _ptr(out, ctypes.c_float), out_h, out_w, float(scale),
                        _ptr(m, ctypes.c_float))
    return out
