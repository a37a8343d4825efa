"""Host C++ of the data and evaluation paths, built with g++ and loaded
through ctypes.

Counterpart of ``imvoxelnet_tpu/native/__init__.py``.  ``image_ops.cc``
holds the loader's fused normalize + pad, the PNG row unfilter and
the bilinear resize; ``eval_kernels.cc`` the KITTI protocol's greedy
matcher, and the rotated-rect intersection areas and greedy rotated NMS on
the host that the tests take as oracles of the clip and NMS paths.  Each source is compiled at first use into
``build/lib<name>-<hash>.so`` (the hash is of the source and the flags, so
an edited source is rebuilt), atomically (a temporary file renamed into
place, safe under concurrent loaders), never at import.

The JAX package falls back to numpy when no compiler is found; the port
does not: a failed build raises.  The numpy functions the tests hold these
to are ``data/pipeline.py:normalize``/``pad_to``,
``data/image_io.py:png_unfilter_plain`` / ``resize_linear_u8_plain`` and
``eval/kitti_eval.py:compute_statistics``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_DIR, 'build')
CXX = 'g++'
_FLAGS = ['-O3', '-shared', '-fPIC', '-std=c++17']

_P, _L, _D, _I = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_double,
                  ctypes.c_int)
# each library's functions: (argument types, result type)
SIGNATURES = {
    'image_ops': {
        'normalize_pad_u8': ([_P, _L, _L, _P, _P, _P, _L, _L], None),
        'png_unfilter': ([_P, _L, _L, _L, _P], ctypes.c_int64),
        'resize_linear_u8': ([_P, _L, _L, _L, _P, _L, _L] + [_P] * 8, None)},
    'eval_kernels': {
        'compute_statistics_thresholds': (
            [_P, _L, _L, _P, _P, _P, _P, _P, _P, _L, _D, _P, _L, _I, _P],
            None),
        'rect_intersection_areas': ([_P, _L, _P, _L, _P], None),
        'rotated_nms_host': ([_P, _P, _L, _D, _P], None)},
}

_lock = threading.Lock()
_loaded: dict = {}


def _so_path(name: str) -> str:
    with open(os.path.join(_DIR, f'{name}.cc'), 'rb') as f:
        digest = hashlib.sha256(f.read())
    digest.update(' '.join(_FLAGS).encode())
    return os.path.join(BUILD_DIR, f'lib{name}-{digest.hexdigest()[:12]}.so')


def _build(name: str, so: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{so}.{os.getpid()}.{threading.get_ident()}.tmp'
    cmd = [CXX] + _FLAGS + [os.path.join(_DIR, f'{name}.cc'), '-o', tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f'cannot build {name}.cc: the compiler '
                           f'{CXX!r} did not start ({e})') from e
    if proc.returncode != 0:
        raise RuntimeError(f'{CXX} failed for {name}.cc (exit '
                           f'{proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, so)


def library(name: str) -> dict:
    """The ctypes functions of library ``name``, built on first use."""
    with _lock:
        fns = _loaded.get(name)
        if fns is None:
            so = _so_path(name)
            if not os.path.exists(so):
                _build(name, so)
            lib = ctypes.CDLL(so)
            fns = {}
            for fn_name, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = restype
                fns[fn_name] = fn
            _loaded[name] = fns
    return fns


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def _f64(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float64)


# --------------------------------------------------------------------------
# image_ops.cc
# --------------------------------------------------------------------------

def normalize_pad_u8(img_u8, mean, std, pad_hw):
    """``(img - mean) / std`` of an ``(h, w, 3)`` uint8 image as float32,
    zero-padded to ``pad_hw`` ``(ph, pw)``, in one pass."""
    img = np.ascontiguousarray(img_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f'normalize_pad_u8 takes an (h, w, 3) uint8 image, '
                         f'got {img.dtype} {img.shape}')
    h, w = img.shape[:2]
    ph, pw = pad_hw
    if h > ph or w > pw:
        raise ValueError(f'image {(h, w)} exceeds the pad size {(ph, pw)}')
    mean = np.ascontiguousarray(mean, np.float32)
    std = np.ascontiguousarray(std, np.float32)
    out = np.empty((ph, pw, 3), np.float32)
    library('image_ops')['normalize_pad_u8'](
        _ptr(img), h, w, _ptr(mean), _ptr(std), _ptr(out), ph, pw)
    return out


def png_unfilter(filtered, h: int, row_bytes: int, bpp: int):
    """Reverse the PNG row filters: ``filtered`` holds ``h`` rows of
    ``1 + row_bytes`` bytes (the inflated IDAT stream) -> ``(h, row_bytes)``
    uint8."""
    src = np.frombuffer(filtered, np.uint8)
    if src.size != h * (row_bytes + 1):
        raise ValueError(f'{src.size} bytes for {h} rows of '
                         f'{row_bytes} + 1')
    out = np.empty((h, row_bytes), np.uint8)
    bad = library('image_ops')['png_unfilter'](_ptr(src), h, row_bytes, bpp,
                                               _ptr(out))
    if bad:
        raise ValueError(f'PNG row {bad - 1}: filter type '
                         f'{src[(bad - 1) * (row_bytes + 1)]} is not 0-4')
    return out


def resize_linear_u8(img, out_hw, x_taps, y_taps):
    """Bilinear resize of an ``(h, w, c)`` uint8 image to ``out_hw`` from
    precomputed taps: ``x_taps`` / ``y_taps`` are each ``(i0, i1, w0, w1)``
    int32 arrays of the output width / height (``data/image_io.py:_taps``)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3:
        raise ValueError(f'resize_linear_u8 takes an (h, w, c) uint8 image, '
                         f'got {img.dtype} {img.shape}')
    h, w, cn = img.shape
    oh, ow = out_hw
    taps = [np.ascontiguousarray(t, np.int32) for t in (*x_taps, *y_taps)]
    if any(len(t) != ow for t in taps[:4]) or any(len(t) != oh
                                                  for t in taps[4:]):
        raise ValueError('taps do not match the output size')
    if not (0 <= min(taps[0].min(), taps[1].min()) and
            max(taps[0].max(), taps[1].max()) < w and
            0 <= min(taps[4].min(), taps[5].min()) and
            max(taps[4].max(), taps[5].max()) < h):
        raise ValueError('a tap lies outside the image')
    out = np.empty((oh, ow, cn), np.uint8)
    library('image_ops')['resize_linear_u8'](
        _ptr(img), h, w, cn, _ptr(out), oh, ow, *[_ptr(t) for t in taps])
    return out


# --------------------------------------------------------------------------
# eval_kernels.cc
# --------------------------------------------------------------------------

def compute_statistics_thresholds(overlaps, dt_scores, dt_alphas, gt_alphas,
                                  ignored_gt, ignored_det, dc_overlaps,
                                  min_overlap, thresholds, compute_aos,
                                  out_pr):
    """The greedy TP/FP/FN matcher of one image at every score threshold,
    accumulated into ``out_pr`` ``(n_thresholds, 4)`` float64 in place."""
    overlaps = _f64(overlaps)
    n_dt, n_gt = overlaps.shape
    dc = _f64(dc_overlaps)
    n_dc = dc.shape[1] if dc.size else 0
    thresholds = _f64(thresholds)
    if out_pr.dtype != np.float64 or not out_pr.flags.c_contiguous or \
            out_pr.shape != (len(thresholds), 4):
        raise ValueError(f'out_pr must be a C-contiguous float64 '
                         f'({len(thresholds)}, 4) array')
    args = [_f64(dt_scores), _f64(dt_alphas), _f64(gt_alphas),
            np.ascontiguousarray(ignored_gt, np.int64),
            np.ascontiguousarray(ignored_det, np.int64),
            dc if n_dc else np.zeros(1)]
    library('eval_kernels')['compute_statistics_thresholds'](
        _ptr(overlaps), n_dt, n_gt, *[_ptr(a) for a in args], n_dc,
        float(min_overlap), _ptr(thresholds), len(thresholds),
        int(compute_aos), _ptr(out_pr))



def rect_intersection_areas(boxes1, boxes2):
    """Intersection areas of every ``(x, y, w, h, r)`` rect of ``boxes1
    (n, 5)`` with every one of ``boxes2 (k, 5)`` -> ``(n, k)`` float64, by a
    Sutherland-Hodgman clip in float64 (the corners of
    ``ops/boxes.py:bev_corners``)."""
    b1, b2 = _f64(boxes1).reshape(-1, 5), _f64(boxes2).reshape(-1, 5)
    out = np.zeros((len(b1), len(b2)), np.float64)
    library('eval_kernels')['rect_intersection_areas'](
        _ptr(b1), len(b1), _ptr(b2), len(b2), _ptr(out))
    return out


def rotated_nms_host(boxes_xywhr, scores, iou_thr):
    """Greedy rotated BEV NMS of ``(n, 5)`` xywhr boxes in descending score
    order (``std::sort``, so equal scores in no promised order), suppressing
    at ``iou > iou_thr`` -> keep ``(n,)`` bool."""
    b, s = _f64(boxes_xywhr).reshape(-1, 5), _f64(scores)
    if len(s) != len(b):
        raise ValueError(f'{len(b)} boxes, {len(s)} scores')
    keep = np.zeros(len(b), np.uint8)
    library('eval_kernels')['rotated_nms_host'](
        _ptr(b), _ptr(s), len(b), float(iou_thr), _ptr(keep))
    return keep.astype(bool)
