"""SUN RGB-D raw data -> info pkl converter.

Counterpart of ``imvoxelnet_tpu/data/converters/sunrgbd_converter.py``,
which decodes every whole JPEG with ``cv2`` to read its shape; here the
shape comes from the file's header (``data/image_io.py:image_shape``).

Parity: ``tools/data_converter/sunrgbd_data_utils.py`` — label-line parsing
(:33-55, note ``2l, 2w, 2h`` full sizes and ``heading = -atan2(o1, o0)``),
column-major calib Rt (:119-125), the 10-class VoteNet list and the 30-class
monocular (PerspectiveNet) list (:75-86).  The depth-point sampling branch is
optional (the ImVoxelNet pipeline never reads points).
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..image_io import image_shape

VOTENET_CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
                   'dresser', 'night_stand', 'bookshelf', 'bathtub')
MONOCULAR_CLASSES = (
    'recycle_bin', 'cpu', 'paper', 'toilet', 'stool', 'whiteboard',
    'coffee_table', 'picture', 'keyboard', 'dresser', 'painting', 'bookshelf',
    'night_stand', 'endtable', 'drawer', 'sink', 'monitor', 'computer',
    'cabinet', 'shelf', 'lamp', 'garbage_bin', 'box', 'bed', 'sofa',
    'sofa_chair', 'pillow', 'desk', 'table', 'chair')


def parse_label_line(line):
    """One label-txt line -> instance dict (``sunrgbd_data_utils.py:33-55``)."""
    data = line.split(' ')
    vals = [float(x) for x in data[1:]]
    name = data[0]
    xmin, ymin, w2d, h2d = vals[0], vals[1], vals[2], vals[3]
    centroid = np.array(vals[4:7])
    w, l, h = vals[7], vals[8], vals[9]
    o0, o1 = vals[10], vals[11]
    heading = -np.arctan2(o1, o0)
    box3d = np.concatenate([centroid, [l * 2, w * 2, h * 2, heading]])
    return dict(name=name,
                bbox2d=np.array([xmin, ymin, xmin + w2d, ymin + h2d]),
                box3d=box3d, dims_lhw=np.array([l * 2, h * 2, w * 2]),
                location=centroid, rotation_y=heading)


def read_calib(path):
    with open(path) as f:
        lines = [line.rstrip() for line in f]
    rt = np.array([float(x) for x in lines[0].split(' ')]).reshape(
        (3, 3), order='F')
    k = np.array([float(x) for x in lines[1].split(' ')])
    return k, rt


def create_sunrgbd_infos(root_path, split='train', monocular=False,
                         num_workers=8):
    """Build the info list the datasets read (``sunrgbd_data_utils.py:133-228``)."""
    classes = MONOCULAR_CLASSES if monocular else VOTENET_CLASSES
    cat2label = {c: i for i, c in enumerate(classes)}
    split_dir = os.path.join(root_path, 'sunrgbd_trainval')
    with open(os.path.join(split_dir, f'{split}_data_idx.txt')) as f:
        sample_ids = [int(x) for x in f.read().split()]

    def process(idx):
        img_path = os.path.join('sunrgbd_trainval', 'image', f'{idx:06d}.jpg')
        k, rt = read_calib(os.path.join(split_dir, 'calib', f'{idx:06d}.txt'))
        info = dict(
            image=dict(image_idx=idx,
                       image_shape=np.array(
                           image_shape(os.path.join(root_path, img_path)),
                           np.int32),
                       image_path=img_path),
            calib=dict(K=k, Rt=rt),
        )
        label_path = os.path.join(split_dir, 'label', f'{idx:06d}.txt')
        if os.path.exists(label_path):
            with open(label_path) as f:
                objs = [parse_label_line(line.rstrip())
                        for line in f if line.strip()]
            objs = [o for o in objs if o['name'] in cat2label]
            annos = dict(gt_num=len(objs))
            if objs:
                annos.update(
                    name=np.array([o['name'] for o in objs]),
                    bbox=np.stack([o['bbox2d'] for o in objs]),
                    location=np.stack([o['location'] for o in objs]),
                    dimensions=np.stack([o['dims_lhw'] for o in objs]),
                    rotation_y=np.array([o['rotation_y'] for o in objs]),
                    index=np.arange(len(objs), dtype=np.int32),
                    gt_boxes_upright_depth=np.stack(
                        [o['box3d'] for o in objs]),
                )
                annos['class'] = np.array(
                    [cat2label[o['name']] for o in objs])
            info['annos'] = annos
        return info

    with ThreadPoolExecutor(num_workers) as pool:
        infos = list(pool.map(process, sample_ids))
    suffix = 'monocular_' if monocular else 'imvoxelnet_'
    out = os.path.join(root_path, f'sunrgbd_{suffix}infos_{split}.pkl')
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'{len(infos)} infos -> {out}')
    return infos
