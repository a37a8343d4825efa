"""nuScenes -> standard info pkl converter, devkit-free.

Counterpart of
``imvoxelnet_tpu/data/converters/nuscenes_converter.py``, as it is.

Parity: ``tools/data_converter/nuscenes_converter.py`` (the standard info
format ``NuScenesMultiViewDataset`` reads): per-sample LIDAR_TOP pose chain,
six cameras with ``sensor2lidar`` transforms via the sweep->ego->global->
ego'->lidar composition (:266-321), GT boxes in the lidar frame as
``(x, y, z, w, l, h, -yaw - pi/2)`` (:223-249).  The devkit is replaced by
direct reads of the dataset's json tables and an explicit quaternion ->
rotation-matrix implementation.
"""

from __future__ import annotations

import json
import os
import pickle

import numpy as np

CAMERAS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
           'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')

# nuScenes detection NameMapping (nuscenes_converter.py / NuScenesDataset)
NAME_MAPPING = {
    'movable_object.barrier': 'barrier',
    'vehicle.bicycle': 'bicycle',
    'vehicle.bus.bendy': 'bus',
    'vehicle.bus.rigid': 'bus',
    'vehicle.car': 'car',
    'vehicle.construction': 'construction_vehicle',
    'vehicle.motorcycle': 'motorcycle',
    'human.pedestrian.adult': 'pedestrian',
    'human.pedestrian.child': 'pedestrian',
    'human.pedestrian.construction_worker': 'pedestrian',
    'human.pedestrian.police_officer': 'pedestrian',
    'movable_object.trafficcone': 'traffic_cone',
    'vehicle.trailer': 'trailer',
    'vehicle.truck': 'truck',
}


def quat_to_mat(q):
    """(w, x, y, z) quaternion -> (3, 3) rotation matrix."""
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array([
        [1 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1 - (xx + yy)],
    ])


def quat_yaw(q):
    """Yaw of a (w, x, y, z) quaternion (yaw_pitch_roll[0])."""
    w, x, y, z = q
    return np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))


def quat_mul(a, b):
    aw, ax, ay, az = a
    bw, bx, by, bz = b
    return np.array([
        aw * bw - ax * bx - ay * by - az * bz,
        aw * bx + ax * bw + ay * bz - az * by,
        aw * by - ax * bz + ay * bw + az * bx,
        aw * bz + ax * by - ay * bx + az * bw,
    ])


def quat_inv(q):
    w, x, y, z = q
    n = w * w + x * x + y * y + z * z
    return np.array([w, -x, -y, -z]) / n


class Tables:
    def __init__(self, root, version):
        base = os.path.join(root, version)
        self.t = {}
        for name in ('sample', 'sample_data', 'calibrated_sensor', 'ego_pose',
                     'sample_annotation', 'scene', 'sensor'):
            with open(os.path.join(base, f'{name}.json')) as f:
                rows = json.load(f)
            self.t[name] = {r['token']: r for r in rows}
        self.scenes = list(self.t['scene'].values())
        # index sample_data by (sample, channel)
        self.sample_cam = {}
        for sd in self.t['sample_data'].values():
            cs = self.t['calibrated_sensor'][sd['calibrated_sensor_token']]
            channel = self.t['sensor'][cs['sensor_token']]['channel']
            if sd['is_key_frame']:
                self.sample_cam[(sd['sample_token'], channel)] = sd
        self.anns_by_sample = {}
        for ann in self.t['sample_annotation'].values():
            self.anns_by_sample.setdefault(ann['sample_token'], []).append(ann)


def _sensor2lidar(tables, sd, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat):
    """(:266-321) returns rotation (3,3), translation (3,), intrinsic."""
    cs = tables.t['calibrated_sensor'][sd['calibrated_sensor_token']]
    pose = tables.t['ego_pose'][sd['ego_pose_token']]
    l2e_r_s_mat = quat_to_mat(cs['rotation'])
    e2g_r_s_mat = quat_to_mat(pose['rotation'])
    l2e_t_s = np.asarray(cs['translation'])
    e2g_t_s = np.asarray(pose['translation'])

    inv_chain = np.linalg.inv(e2g_r_mat).T @ np.linalg.inv(l2e_r_mat).T
    rot = (l2e_r_s_mat.T @ e2g_r_s_mat.T) @ inv_chain
    trans = (l2e_t_s @ e2g_r_s_mat.T + e2g_t_s) @ inv_chain
    trans -= (e2g_t @ inv_chain + l2e_t @ np.linalg.inv(l2e_r_mat).T)
    intrinsic = np.asarray(cs['camera_intrinsic'])
    return rot.T, trans, intrinsic


def create_nuscenes_infos(root, version='v1.0-trainval', val_scenes=None):
    """Build {prefix}_infos_{train,val}.pkl in the standard format.

    ``val_scenes``: path to a text file of validation scene names (the
    official split, normally from ``nuscenes.utils.splits``); scenes not
    listed go to train.
    """
    tables = Tables(root, version)
    val_set = set()
    if val_scenes:
        with open(val_scenes) as f:
            val_set = {line.strip() for line in f if line.strip()}

    train_infos, val_infos = [], []
    for scene in tables.scenes:
        sample_token = scene['first_sample_token']
        is_val = scene['name'] in val_set
        while sample_token:
            sample = tables.t['sample'][sample_token]
            lidar_sd = tables.sample_cam.get((sample_token, 'LIDAR_TOP'))
            if lidar_sd is None:
                sample_token = sample['next']
                continue
            cs = tables.t['calibrated_sensor'][
                lidar_sd['calibrated_sensor_token']]
            pose = tables.t['ego_pose'][lidar_sd['ego_pose_token']]
            l2e_t = np.asarray(cs['translation'])
            l2e_r_mat = quat_to_mat(cs['rotation'])
            e2g_t = np.asarray(pose['translation'])
            e2g_r_mat = quat_to_mat(pose['rotation'])
            q_l2e_inv = quat_inv(cs['rotation'])
            q_e2g_inv = quat_inv(pose['rotation'])

            cams = {}
            for cam in CAMERAS:
                sd = tables.sample_cam.get((sample_token, cam))
                if sd is None:
                    continue
                rot, trans, intr = _sensor2lidar(
                    tables, sd, l2e_t, l2e_r_mat, e2g_t, e2g_r_mat)
                cams[cam] = dict(
                    data_path=sd['filename'],
                    sensor2lidar_rotation=rot,
                    sensor2lidar_translation=trans,
                    cam_intrinsic=intr,
                )

            locs, dims, rots, names, n_pts, valid = [], [], [], [], [], []
            for ann in tables.anns_by_sample.get(sample_token, []):
                # global -> ego -> lidar
                c = np.asarray(ann['translation'])
                c = (c - e2g_t) @ e2g_r_mat  # R^T (c - t) as row vector
                c = (c - l2e_t) @ l2e_r_mat
                q = quat_mul(q_l2e_inv, quat_mul(q_e2g_inv, ann['rotation']))
                yaw = quat_yaw(q)
                locs.append(c)
                dims.append(ann['size'])                      # (w, l, h)
                rots.append(-yaw - np.pi / 2)
                names.append(NAME_MAPPING.get(ann['category_name'],
                                              ann['category_name']))
                pts = ann.get('num_lidar_pts', 0)
                n_pts.append(pts)
                valid.append(pts + ann.get('num_radar_pts', 0) > 0)

            info = dict(
                token=sample_token,
                timestamp=sample['timestamp'],
                cams=cams,
                lidar_path=lidar_sd['filename'],
                gt_boxes=(np.concatenate(
                    [np.asarray(locs), np.asarray(dims),
                     np.asarray(rots)[:, None]], 1)
                    if locs else np.zeros((0, 7))),
                gt_names=np.asarray(names),
                num_lidar_pts=np.asarray(n_pts, np.int64),
                valid_flag=np.asarray(valid, bool),
            )
            (val_infos if is_val else train_infos).append(info)
            sample_token = sample['next']

    for split, infos in (('train', train_infos), ('val', val_infos)):
        out = os.path.join(root, f'nuscenes_infos_{split}.pkl')
        with open(out, 'wb') as f:
            pickle.dump({'infos': infos, 'metadata': {'version': version}}, f)
        print(f'{len(infos)} infos -> {out}')
    return train_infos, val_infos
