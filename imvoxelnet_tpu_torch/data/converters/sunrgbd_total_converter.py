"""Total3DUnderstanding json -> info pkl converter.

Counterpart of
``imvoxelnet_tpu/data/converters/sunrgbd_total_converter.py``, as it is.

Parity: ``tools/data_converter/sunrgbd_total.py:16-93``: pitch/roll from the
rot matrix, the Total3D axis permutation, inversion of the dataset-side
``_get_matrices`` Rt preprocessing, layout/object boxes with swapped axes and
negated angle.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

TOTAL_CLASSES = (
    'cabinet', 'bed', 'chair', 'sofa', 'table', 'door', 'window', 'bookshelf',
    'picture', 'counter', 'blinds', 'desk', 'shelves', 'curtain', 'dresser',
    'pillow', 'mirror', 'clothes', 'books', 'fridge', 'tv', 'paper', 'towel',
    'shower_curtain', 'box', 'whiteboard', 'person', 'night_stand', 'toilet',
    'sink', 'lamp', 'bathtub', 'bag')


def _swap_box(center, size, angle):
    return np.array([center[2], center[0], center[1],
                     size[2], size[0], size[1], -angle])


def convert_total_sunrgbd(json_path):
    with open(json_path) as f:
        data = json.load(f)

    categories = {}
    for cat in data['categories']:
        if cat['name'] in TOTAL_CLASSES:
            categories[cat['id']] = TOTAL_CLASSES.index(cat['name'])

    by_image = {}
    for ann in data['annotations']:
        by_image.setdefault(ann['image_id'], []).append(ann)

    infos = []
    for image_data in data['images']:
        r = np.array(image_data['rot_mat'])
        yaw = np.arctan(-r[2][0] / r[0][0])
        pitch = np.arctan(r[1][0] / np.sqrt(r[0][0] ** 2 + r[2][0] ** 2))
        roll = np.arctan(-r[1][2] / r[1][1])
        assert np.isclose(yaw, 0), yaw

        t = np.array([[0., 0., 1.], [0., -1., 0.], [-1., 0., 0.]])
        r = t @ r.T
        r = r[:, [2, 0, 1]]
        r[2] *= -1
        # invert the dataset-side Rt preprocessing
        r = r.T
        r[:, 1] = -r[:, 1]
        r[:, [1, 2]] = r[:, [2, 1]]

        classes, boxes = [], []
        for ann in by_image.get(image_data['id'], []):
            if ann['category_id'] in categories:
                classes.append(categories[ann['category_id']])
                boxes.append(_swap_box(ann['center'], ann['size'],
                                       ann['angle']))
        infos.append(dict(
            image=dict(image_path=os.path.join('OFFICIAL_SUNRGBD',
                                               image_data['file_name'])),
            calib=dict(K=np.array(image_data['K']).T, Rt=r),
            layout=_swap_box(image_data['room_center'],
                             image_data['room_size'],
                             image_data['room_angle']),
            angles=np.array([pitch, roll]),
            annos=dict(
                gt_num=len(classes),
                gt_boxes_upright_depth=(np.stack(boxes) if boxes
                                        else np.zeros((0, 7))),
                **{'class': np.array(classes, np.int64)},
            ),
        ))

    out = json_path.replace('.json', '.pkl')
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'{len(infos)} infos -> {out}')
    return infos
