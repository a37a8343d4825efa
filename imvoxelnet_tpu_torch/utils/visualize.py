"""Visualization: predicted 3D boxes projected into the views as wireframes,
and a wireframe ``.obj`` export.

Counterpart of ``imvoxelnet_tpu/utils/visualize.py`` (``MultiViewMixin.show``,
``mmdet3d/datasets/dataset_wrappers.py:82-126``): the corners of each box
(``ops/boxes.py:corners``) projected with the dataset's ``intrinsic @
extrinsic`` and drawn edge by edge with ``cv2.line``; frames are read with
the port's ``data/image_io.load_image`` (RGB) and written as PNG by
``cv2.imwrite``.  Host code on numpy arrays.  ``cv2`` is needed here and
nowhere else on the port's paths: without it these functions raise.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..data.image_io import load_image
from ..ops import boxes as box_ops

# edges of the reference's corner order
# (x0y0z0, x0y0z1, x0y1z1, x0y1z0, x1y0z0, x1y0z1, x1y1z1, x1y1z0)
_EDGES = [(0, 1), (1, 2), (2, 3), (3, 0),
          (4, 5), (5, 6), (6, 7), (7, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise ImportError('drawing and writing the wireframes needs cv2 '
                          '(opencv-python), which is not installed') from e
    return cv2


def box_corners(boxes):
    """The ``(N, 8, 3)`` float32 corners of ``(N, 7)`` bottom-center boxes,
    as numpy."""
    boxes = torch.as_tensor(np.asarray(boxes, np.float32).reshape(-1, 7))
    return box_ops.corners(boxes).numpy()


def draw_boxes(image, boxes, projection, color=(0, 255, 0), thickness=2):
    """Draw ``(N, 7)`` bottom-center boxes as wireframes on an RGB image.

    Args:
      image: ``(H, W, 3)`` uint8 (a modified copy is returned).
      projection: ``(3, 4)`` ``K @ E[:3]``.

    A box with a corner at or behind the camera is skipped; pixel
    coordinates are truncated to integers, as the JAX package does.
    """
    cv2 = _cv2()
    img = np.ascontiguousarray(image.copy())
    if len(boxes) == 0:
        return img
    projection = np.asarray(projection)
    for corners in box_corners(boxes):
        pts4 = np.concatenate([corners, np.ones((8, 1), np.float32)], axis=1)
        uvw = pts4 @ projection.T
        if np.any(uvw[:, 2] <= 0):
            continue
        uv = (uvw[:, :2] / uvw[:, 2:3]).astype(int)
        for a, b in _EDGES:
            cv2.line(img, tuple(int(c) for c in uv[a]),
                     tuple(int(c) for c in uv[b]), color, thickness)
    return img


def export_boxes_obj(boxes, path):
    """Write ``(N, 7)`` bottom-center boxes as a wireframe ``.obj`` (8
    vertices and 12 lines a box) for MeshLab; returns ``path``."""
    corners = box_corners(boxes)
    lines = [f'v {x:.5f} {y:.5f} {z:.5f}' for cs in corners
             for x, y, z in cs]
    for b in range(len(corners)):
        off = b * 8 + 1
        lines += [f'l {off + a} {off + c}' for a, c in _EDGES]
    with open(path, 'w') as f:
        f.write('\n'.join(lines) + '\n')
    return path


def show_multi_view_result(dataset, index, boxes, out_dir):
    """Draw ``boxes`` into every view of sample ``index`` of ``dataset``
    and write ``{index}_{view}.png`` into ``out_dir``; returns the paths."""
    cv2 = _cv2()
    data = dataset.get_data_info(index)
    os.makedirs(out_dir, exist_ok=True)
    intrinsic = np.asarray(data['intrinsic'], np.float32)[:3, :3]
    paths = []
    for i, rel in enumerate(data['img_paths']):
        img = load_image(os.path.join(dataset.data_root, rel))
        extrinsic = np.asarray(data['extrinsics'][i], np.float32)
        img = draw_boxes(img, boxes, intrinsic @ extrinsic[:3])
        out = os.path.join(out_dir, f'{index}_{i}.png')
        if not cv2.imwrite(out, np.ascontiguousarray(img[:, :, ::-1])):
            raise OSError(f'cv2 could not write {out}')
        paths.append(out)
    return paths
