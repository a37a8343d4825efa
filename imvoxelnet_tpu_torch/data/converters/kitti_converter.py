"""KITTI raw data -> info pkl converter.

Counterpart of ``imvoxelnet_tpu/data/converters/kitti_converter.py``, which
decodes every whole PNG with ``cv2`` to read its shape; here the shape comes
from the PNG's header (``data/image_io.py:image_shape``).

Parity: ``tools/data_converter/kitti_converter.py`` + ``kitti_data_utils.py``
(calib matrix extension to 4x4, label parsing with dimensions reordered to
``(l, h, w)``).  Output matches the reference's ``kitti_infos_{split}.pkl``
contract that ``KittiMultiViewDataset`` reads.
"""

from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..image_io import image_shape


def _extend_matrix(mat):
    return np.concatenate(
        [mat, np.array([[0., 0., 0., 1.]], mat.dtype)], axis=0)


def read_calib(path):
    with open(path) as f:
        lines = f.readlines()
    out = {}
    for i, key in enumerate(('P0', 'P1', 'P2', 'P3')):
        vals = np.array([float(x) for x in lines[i].split(' ')[1:13]])
        out[key] = _extend_matrix(vals.reshape(3, 4))
    r0 = np.array([float(x) for x in lines[4].split(' ')[1:10]]).reshape(3, 3)
    rect = np.eye(4)
    rect[:3, :3] = r0
    out['R0_rect'] = rect
    for i, key in enumerate(('Tr_velo_to_cam', 'Tr_imu_to_velo'), start=5):
        vals = np.array([float(x) for x in lines[i].split(' ')[1:13]])
        out[key] = _extend_matrix(vals.reshape(3, 4))
    return out


def read_label(path):
    names, truncated, occluded, alpha = [], [], [], []
    bbox, dims, loc, rots = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split(' ')
            if not parts[0]:
                continue
            names.append(parts[0])
            vals = [float(x) for x in parts[1:]]
            truncated.append(vals[0])
            occluded.append(int(vals[1]))
            alpha.append(vals[2])
            bbox.append(vals[3:7])
            # raw label dims are (h, w, l); stored as (l, h, w)
            dims.append([vals[9], vals[7], vals[8]])
            loc.append(vals[10:13])
            rots.append(vals[13])
    n = len(names)
    return dict(
        name=np.array(names),
        truncated=np.array(truncated),
        occluded=np.array(occluded),
        alpha=np.array(alpha),
        bbox=np.array(bbox).reshape(n, 4),
        dimensions=np.array(dims).reshape(n, 3),
        location=np.array(loc).reshape(n, 3),
        rotation_y=np.array(rots),
        score=np.zeros(n),
        index=np.arange(n, dtype=np.int32),
        group_ids=np.arange(n, dtype=np.int32),
    )


def create_kitti_infos(root_path, split='train', num_workers=8):
    split_file = os.path.join(root_path, 'ImageSets', f'{split}.txt')
    with open(split_file) as f:
        ids = [int(x) for x in f.read().split()]
    folder = 'testing' if split == 'test' else 'training'

    def process(idx):
        img_path = os.path.join(folder, 'image_2', f'{idx:06d}.png')
        info = dict(
            image=dict(image_idx=idx,
                       image_path=img_path,
                       image_shape=np.array(
                           image_shape(os.path.join(root_path, img_path)),
                           np.int32)),
            point_cloud=dict(
                num_features=4,
                velodyne_path=os.path.join(folder, 'velodyne',
                                           f'{idx:06d}.bin')),
            calib=read_calib(
                os.path.join(root_path, folder, 'calib', f'{idx:06d}.txt')),
        )
        label_path = os.path.join(root_path, folder, 'label_2',
                                  f'{idx:06d}.txt')
        if os.path.exists(label_path):
            info['annos'] = read_label(label_path)
        return info

    with ThreadPoolExecutor(num_workers) as pool:
        infos = list(pool.map(process, ids))
    out = os.path.join(root_path, f'kitti_infos_{split}.pkl')
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'{len(infos)} infos -> {out}')
    return infos
