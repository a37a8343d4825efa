"""Synthetic raw dataset trees, as the converters (``data/converters``) read
them.

The raw datasets are not in the repository.  These writers put the files
each converter reads under ``root``, in the datasets' published layouts:

- :func:`kitti_raw`: ``ImageSets/<split>.txt``, ``training/calib`` and
  ``training/label_2`` text files for the frames of a
  ``synthetic_splits.kitti_split`` (its PNG frames and its info list), so
  that ``create_kitti_infos`` gives that list back.
- :func:`scannet_raw`: a ``.sens`` stream (version 4, JPEG color) per scene
  of a ``synthetic_splits.scannet_split``, holding its frames re-encoded as
  JPEG and its poses, with ``scannet_instance_data`` and
  ``meta_data/scannetv2_<split>.txt``.
- :func:`sunrgbd_raw`: ``sunrgbd_trainval`` (JPEG images, column-major
  ``Rt`` calibration, label lines of half sizes and heading vectors).
- :func:`total3d_raw`: a Total3DUnderstanding json and its images.
- :func:`nuscenes_raw`: the nuScenes json tables of two scenes (a LIDAR_TOP
  and six cameras a sample, ego poses, annotations) and the camera frames.

Every number is written so that it reads back exactly (``repr`` of a
float).  JPEG files are encoded with ``cv2``, imported where they are
written.
"""

from __future__ import annotations

import json
import os
import struct

import numpy as np

from . import synthetic as syn
from .synthetic_splits import frame


def _line(values) -> str:
    return ' '.join(repr(float(v)) for v in np.ravel(values))


def _jpeg(img_rgb, quality: int = 95) -> bytes:
    import cv2
    ok, buf = cv2.imencode('.jpg', np.ascontiguousarray(img_rgb[:, :, ::-1]),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    if not ok:
        raise RuntimeError('cv2 could not encode a JPEG frame')
    return buf.tobytes()


def _write_bytes(path, data: bytes):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, 'wb') as f:
        f.write(data)


# --------------------------------------------------------------------------
# KITTI
# --------------------------------------------------------------------------

def kitti_raw(root, infos, split='val'):
    """The calibration and label files of ``infos`` (a
    ``synthetic_splits.kitti_split`` list, frames already under ``root``)
    and ``ImageSets/<split>.txt``.  ``P0`` and ``P1`` repeat ``P2``, and
    ``Tr_imu_to_velo`` is the identity: no reader uses them."""
    folder = os.path.join(root, 'training')
    os.makedirs(os.path.join(root, 'ImageSets'), exist_ok=True)
    with open(os.path.join(root, 'ImageSets', f'{split}.txt'), 'w') as f:
        f.write(''.join(f'{info["image"]["image_idx"]:06d}\n'
                        for info in infos))
    for info in infos:
        idx, calib = info['image']['image_idx'], info['calib']
        rows = [('P0', calib['P2'][:3]), ('P1', calib['P2'][:3]),
                ('P2', calib['P2'][:3]), ('P3', calib['P3'][:3]),
                ('R0_rect', calib['R0_rect'][:3, :3]),
                ('Tr_velo_to_cam', calib['Tr_velo_to_cam'][:3]),
                ('Tr_imu_to_velo', np.eye(4)[:3])]
        _write_bytes(os.path.join(folder, 'calib', f'{idx:06d}.txt'),
                     ''.join(f'{k}: {_line(v)}\n' for k, v in rows).encode())
        a = info['annos']
        lines = []
        for i, name in enumerate(a['name']):
            l, h, w = a['dimensions'][i]
            lines.append(f'{name} {_line([a["truncated"][i]])} '
                         f'{int(a["occluded"][i])} '
                         f'{_line([a["alpha"][i]])} {_line(a["bbox"][i])} '
                         f'{_line([h, w, l])} {_line(a["location"][i])} '
                         f'{_line([a["rotation_y"][i]])}\n')
        _write_bytes(os.path.join(folder, 'label_2', f'{idx:06d}.txt'),
                     ''.join(lines).encode())


# --------------------------------------------------------------------------
# ScanNet
# --------------------------------------------------------------------------

def write_sens(path, color_jpegs, poses, intrinsic, color_hw):
    """A ScanNet ``.sens`` stream (SensorData version 4): the header with
    the color intrinsic, JPEG color (compression 2), no depth, then each
    frame's pose and JPEG bytes.  Matrices are stored as float32, as the
    format has them."""
    h, w = color_hw
    f32 = lambda m: np.asarray(m, np.float32).tobytes()   # noqa: E731
    name = b'synthetic'
    out = [struct.pack('I', 4), struct.pack('Q', len(name)), name,
           f32(intrinsic), f32(np.eye(4)), f32(intrinsic), f32(np.eye(4)),
           struct.pack('i', 2), struct.pack('i', 1), struct.pack('I', w),
           struct.pack('I', h), struct.pack('I', w), struct.pack('I', h),
           struct.pack('f', 1000.0), struct.pack('Q', len(color_jpegs))]
    for i, (jpeg, pose) in enumerate(zip(color_jpegs, poses)):
        out += [f32(pose), struct.pack('QQ', i, i),
                struct.pack('Q', len(jpeg)), struct.pack('Q', 0), jpeg]
    _write_bytes(path, b''.join(out))


def scannet_raw(root, infos, split='val'):
    """``scans/<scene>/<scene>.sens`` for each scene of ``infos`` (a
    ``synthetic_splits.scannet_split`` list, frames already under
    ``root``): its frames decoded and re-encoded as JPEG, its poses and
    intrinsic; ``scannet_instance_data/<scene>_bbox.npy`` (boxes and class)
    and ``_axis_align_matrix.npy``; ``meta_data/scannetv2_<split>.txt``.
    Returns the scene names."""
    from ..data.image_io import load_image

    scenes = []
    for info in infos:
        scene = info['img_paths'][0].split('/')[1]
        frames = [load_image(os.path.join(root, p)) for p in info['img_paths']]
        write_sens(os.path.join(root, 'scans', scene, f'{scene}.sens'),
                   [_jpeg(img) for img in frames], info['extrinsics'],
                   info['intrinsics'], frames[0].shape[:2])
        inst = os.path.join(root, 'scannet_instance_data')
        os.makedirs(inst, exist_ok=True)
        a = info['annos']
        np.save(os.path.join(inst, f'{scene}_bbox.npy'), np.concatenate(
            [a['gt_boxes_upright_depth'], a['class'][:, None]], 1))
        np.save(os.path.join(inst, f'{scene}_axis_align_matrix.npy'),
                a['axis_align_matrix'])
        scenes.append(scene)
    _write_bytes(os.path.join(root, 'meta_data', f'scannetv2_{split}.txt'),
                 ''.join(f'{s}\n' for s in scenes).encode())
    return scenes


# --------------------------------------------------------------------------
# SUN RGB-D and Total3D
# --------------------------------------------------------------------------

SUNRGBD_CLASSES = ('bed', 'table', 'sofa', 'chair', 'toilet', 'desk',
                   'dresser', 'night_stand', 'bookshelf', 'bathtub')


def sunrgbd_raw(root, n: int, seed: int = 0, split='val',
                frame_hw=(530, 730)):
    """``sunrgbd_trainval`` with ``n`` JPEG frames (ids 1..n), their
    calibration (``Rt`` column-major, then ``K`` transposed) and label
    lines (``name xmin ymin w h cx cy cz w/2 l/2 h/2 cos -sin`` of each
    box's centre, half sizes and heading) of :func:`synthetic.
    furniture_boxes` named after the VoteNet classes; the first frame's
    label holds one ``wall`` only, which no class list keeps."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, 'sunrgbd_trainval')
    h, w = frame_hw
    f = 529.5 * w / 730
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    ids = list(range(1, n + 1))
    _write_bytes(os.path.join(base, f'{split}_data_idx.txt'),
                 ''.join(f'{i}\n' for i in ids).encode())
    for idx in ids:
        rt = syn._rotation(np.deg2rad(rng.uniform(-8.0, -2.0)),
                           np.deg2rad(rng.uniform(-3.0, 3.0)))
        _write_bytes(os.path.join(base, 'image', f'{idx:06d}.jpg'),
                     _jpeg(frame(rng, h, w)))
        _write_bytes(os.path.join(base, 'calib', f'{idx:06d}.txt'),
                     f'{_line(rt.ravel(order="F"))}\n'
                     f'{_line(k.T.ravel())}\n'.encode())
        boxes, labels, mask = syn.furniture_boxes(rng, 1, 8)
        lines = []
        for box, label in zip(boxes[0][mask[0]], labels[0][mask[0]]):
            x, y, z, dx, dy, dz, yaw = (float(v) for v in box)
            name = 'wall' if idx == 1 else SUNRGBD_CLASSES[label]
            lines.append(f'{name} {_line([10, 20, 100, 80])} '
                         f'{_line([x, y, z + dz / 2])} '
                         f'{_line([dy / 2, dx / 2, dz / 2])} '
                         f'{_line([np.cos(yaw), -np.sin(yaw)])}\n')
            if idx == 1:
                break
        _write_bytes(os.path.join(base, 'label', f'{idx:06d}.txt'),
                     ''.join(lines).encode())


TOTAL_CLASSES_USED = ('bed', 'chair', 'table', 'desk', 'lamp')


def total3d_raw(root, n: int, seed: int = 0, split='val',
                frame_hw=(530, 730)):
    """``sunrgbd_total_infos_<split>.json`` in Total3DUnderstanding's form
    and its ``n`` JPEG frames under ``OFFICIAL_SUNRGBD/``: each image's
    ``rot_mat`` (yaw 0, the pitch and roll to recover), ``K``, the room
    and its objects (``center``, ``size``, ``angle`` in Total3D's axes; one
    ``wall`` a frame, which no class list keeps).  Returns the json's
    path."""
    rng = np.random.RandomState(seed)
    h, w = frame_hw
    f = 529.5 * w / 730
    k = [[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]]
    categories = [dict(id=i + 1, name=c)
                  for i, c in enumerate(TOTAL_CLASSES_USED)]
    categories.append(dict(id=99, name='wall'))
    images, annotations = [], []
    for i in range(n):
        p, q = np.deg2rad(rng.uniform(-8, -2)), np.deg2rad(rng.uniform(-3, 3))
        rz = np.array([[np.cos(p), -np.sin(p), 0], [np.sin(p), np.cos(p), 0],
                       [0, 0, 1]])
        rx = np.array([[1, 0, 0], [0, np.cos(q), -np.sin(q)],
                       [0, np.sin(q), np.cos(q)]])
        boxes, labels, mask = syn.furniture_boxes(rng, 1, 8,
                                                  len(TOTAL_CLASSES_USED))
        boxes, labels = boxes[0][mask[0]], labels[0][mask[0]]
        room = syn.layout_boxes(rng, boxes[None], np.ones((1, len(boxes)),
                                                          bool))[0]
        name = f'img/{i:06d}.jpg'
        _write_bytes(os.path.join(root, 'OFFICIAL_SUNRGBD', name),
                     _jpeg(frame(rng, h, w)))
        # (x, y, z, dx, dy, dz, yaw) -> Total3D's center (y, z, x), size
        # (dy, dz, dx), angle -yaw, which the converter swaps back
        def total(b):
            x, y, z, dx, dy, dz, yaw = (float(v) for v in b)
            return [y, z + dz / 2, x], [dy, dz, dx], -yaw
        c, s, a = total(room)
        images.append(dict(id=i, file_name=name, rot_mat=(rz @ rx).tolist(),
                           K=k, room_center=c, room_size=s, room_angle=a))
        for j, (box, label) in enumerate(zip(boxes, labels)):
            c, s, a = total(box)
            cat = 99 if j == 0 else int(label) + 1
            annotations.append(dict(image_id=i, category_id=cat, center=c,
                                    size=s, angle=a))
    path = os.path.join(root, f'sunrgbd_total_infos_{split}.json')
    _write_bytes(path, json.dumps(dict(categories=categories, images=images,
                                       annotations=annotations)).encode())
    return path


# --------------------------------------------------------------------------
# nuScenes
# --------------------------------------------------------------------------

def _quat(r):
    """(w, x, y, z) of a rotation matrix (Shepperd's method)."""
    r = np.asarray(r, np.float64)
    t = np.trace(r)
    if t > 0:
        s = 2.0 * np.sqrt(1.0 + t)
        return [s / 4, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
                (r[1, 0] - r[0, 1]) / s]
    i = int(np.argmax(np.diag(r)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = 2.0 * np.sqrt(1.0 + r[i, i] - r[j, j] - r[k, k])
    q = [0.0] * 4
    q[0] = (r[k, j] - r[j, k]) / s
    q[1 + i] = s / 4
    q[1 + j] = (r[j, i] + r[i, j]) / s
    q[1 + k] = (r[k, i] + r[i, k]) / s
    return q


def _yaw_quat(yaw):
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def nuscenes_raw(root, n: int, seed: int = 0, version='v1.0-mini',
                 frame_hw=(syn.NUSCENES_H, syn.NUSCENES_W)):
    """The json tables of ``version`` under ``root`` for two scenes
    (``scene-0001`` with the first ``n - n // 2`` samples, ``scene-0002``
    with the rest): per sample a LIDAR_TOP and the six cameras of
    :data:`synthetic.NUSCENES_CAMERAS` (their frames as PNG content under
    ``samples/<CAM>/``), an ego pose moved and turned at random, and the
    cars of :func:`synthetic.nuscenes_cars` with one pedestrian, all as
    global boxes.  Returns the path of a file that lists ``scene-0002``,
    the ``val_scenes`` argument of ``create_nuscenes_infos``."""
    rng = np.random.RandomState(seed)
    base = os.path.join(root, version)
    cams = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
            'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')
    t = dict(sensor=[dict(token='sensor_lidar', channel='LIDAR_TOP',
                          modality='lidar')],
             calibrated_sensor=[dict(
                 token='cs_lidar', sensor_token='sensor_lidar',
                 translation=[syn.LIDAR_ON_EGO[0], syn.LIDAR_ON_EGO[1],
                              syn.LIDAR_HEIGHT],
                 rotation=[1.0, 0.0, 0.0, 0.0], camera_intrinsic=[])],
             ego_pose=[], sample_data=[], sample=[], scene=[],
             sample_annotation=[])
    k = [[syn.NUSCENES_F, 0, syn.NUSCENES_C[0]],
         [0, syn.NUSCENES_F, syn.NUSCENES_C[1]], [0, 0, 1]]
    for cam, (yaw, x, y, z) in zip(cams, syn.NUSCENES_CAMERAS):
        a = np.deg2rad(yaw)
        # camera axes (right, down, ahead) in the ego frame
        r = np.stack([[np.sin(a), -np.cos(a), 0.0], [0.0, 0.0, -1.0],
                      [np.cos(a), np.sin(a), 0.0]], 1)
        t['sensor'].append(dict(token=f'sensor_{cam}', channel=cam,
                                modality='camera'))
        t['calibrated_sensor'].append(dict(
            token=f'cs_{cam}', sensor_token=f'sensor_{cam}',
            translation=[x, y, z], rotation=_quat(r), camera_intrinsic=k))
    h, w = frame_hw
    halves = (('scene-0001', range(0, n - n // 2)),
              ('scene-0002', range(n - n // 2, n)))
    for s, (scene, samples) in enumerate(halves):
        tokens = [f'sample_{i}' for i in samples]
        t['scene'].append(dict(token=f'scene_{s}', name=scene,
                               first_sample_token=tokens[0] if tokens
                               else ''))
        for j, i in enumerate(samples):
            ego_t = [float(v) for v in rng.uniform(-500, 500, 3)]
            ego_t[2] = 0.0
            ego_yaw = rng.uniform(-np.pi, np.pi)
            t['ego_pose'].append(dict(token=f'ego_{i}', translation=ego_t,
                                      rotation=_yaw_quat(ego_yaw),
                                      timestamp=i))
            t['sample'].append(dict(
                token=tokens[j], scene_token=f'scene_{s}', timestamp=i,
                prev=tokens[j - 1] if j else '',
                next=tokens[j + 1] if j + 1 < len(tokens) else ''))
            for channel in ('LIDAR_TOP',) + cams:
                cs = 'cs_lidar' if channel == 'LIDAR_TOP' else f'cs_{channel}'
                ext = 'bin' if channel == 'LIDAR_TOP' else 'jpg'
                name = f'samples/{channel}/{i:06d}.{ext}'
                t['sample_data'].append(dict(
                    token=f'sd_{channel}_{i}', sample_token=tokens[j],
                    ego_pose_token=f'ego_{i}', calibrated_sensor_token=cs,
                    filename=name, is_key_frame=True, timestamp=i))
                if channel != 'LIDAR_TOP':
                    path = os.path.join(root, name)
                    os.makedirs(os.path.dirname(path), exist_ok=True)
                    syn.write_png(path, frame(rng, h, w))
            boxes, _, mask = syn.nuscenes_cars(rng, 1, 8)
            rot = np.array([[np.cos(ego_yaw), -np.sin(ego_yaw), 0],
                            [np.sin(ego_yaw), np.cos(ego_yaw), 0], [0, 0, 1]])
            objects = [(b, 'vehicle.car') for b in boxes[0][mask[0]]]
            objects.append((np.array([5.0, 3.0, -1.8, 0.6, 0.7, 1.7, 0.3]),
                            'human.pedestrian.adult'))
            for m, (b, category) in enumerate(objects):
                # lidar boxes (bottom centre, yaw = -heading - pi/2) ->
                # global centres and headings
                centre = np.array([b[0] + syn.LIDAR_ON_EGO[0],
                                   b[1] + syn.LIDAR_ON_EGO[1],
                                   b[2] + b[5] / 2 + syn.LIDAR_HEIGHT])
                t['sample_annotation'].append(dict(
                    token=f'ann_{i}_{m}', sample_token=tokens[j],
                    translation=(rot @ centre + ego_t).tolist(),
                    size=[float(b[3]), float(b[4]), float(b[5])],
                    rotation=_yaw_quat(ego_yaw - b[6] - np.pi / 2),
                    category_name=category, num_lidar_pts=10,
                    num_radar_pts=0))
    os.makedirs(base, exist_ok=True)
    for name, rows in t.items():
        with open(os.path.join(base, f'{name}.json'), 'w') as f:
            json.dump(rows, f)
    val = os.path.join(root, 'val_scenes.txt')
    _write_bytes(val, b'scene-0002\n')
    return val
