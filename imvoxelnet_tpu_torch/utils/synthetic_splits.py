"""Synthetic validation splits on disk, in the datasets' own schemas.

Each writer puts PNG frames (``utils/synthetic.py:write_png``, every row
filter type in use) at the dataset's real frame size under ``root`` and an
info file in the schema the dataset class reads (``data/datasets.py``), and
returns the info file's path.  The cameras and the GT are those of the
synthetic batches (``utils/synthetic.py``): KITTI's camera 2
(``K_KITTI``, ``LIDAR_TO_CAM``) with cars placed and projected as the JAX
package's ``tools/make_synthetic_kitti.py`` places them, a Kinect-like
SUN RGB-D camera over :func:`furniture_boxes` (and, for Total3D, the
camera's angles and a :func:`layout_boxes` room), ScanNet cameras on a
circle in a room of :func:`room_boxes`, and the six nuScenes cameras around
:func:`nuscenes_cars`.  The frames are smooth noise, so that they compress
as photographs do rather than as white noise; the weights that see them are
random anyway.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

from . import synthetic as syn


def frame(rng, h: int, w: int) -> np.ndarray:
    """An ``(h, w, 3)`` uint8 frame: a coarse random grid resized up, with
    a little pixel noise."""
    from ..data.image_io import resize_linear_u8_plain

    coarse = rng.randint(0, 256, (h // 48 + 2, w // 48 + 2, 3)).astype(
        np.uint8)
    img = resize_linear_u8_plain(coarse, (h, w)).astype(np.int16)
    img += rng.randint(-6, 7, img.shape).astype(np.int16)
    return np.clip(img, 0, 255).astype(np.uint8)


def _write_frame(root, rel, rng, h, w):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    syn.write_png(path, frame(rng, h, w))


def _dump(obj, path):
    with open(path, 'wb') as f:
        pickle.dump(obj, f)
    return path


# --------------------------------------------------------------------------
# KITTI
# --------------------------------------------------------------------------

KITTI_FRAME = (375, 1242)                    # (h, w) of KITTI's camera 2
# KITTI's P2 and P3 translations (the cameras' offsets, fx * t)
KITTI_P2_T = (44.85728, 0.2163791, 0.002745884)
KITTI_P3_T = (-339.5242, 2.199936, 0.002729905)


def kitti_calib(rng):
    """``P2``, ``P3`` (the right camera, for the stereo dataset),
    ``R0_rect`` and ``Tr_velo_to_cam`` as 4x4 float64, from ``K_KITTI`` and
    ``LIDAR_TO_CAM``; ``R0_rect`` turns by 0.2-0.6 degrees about the
    camera's y axis and by up to 0.2 about its x axis, as the rectifying
    rotations of KITTI's recording days differ."""
    calib = {}
    for name, t in (('P2', KITTI_P2_T), ('P3', KITTI_P3_T)):
        calib[name] = np.eye(4)
        calib[name][:3, :3] = syn.K_KITTI
        calib[name][:3, 3] = t
    a, b = np.deg2rad(rng.uniform(0.2, 0.6)), np.deg2rad(rng.uniform(-0.2,
                                                                     0.2))
    r_y = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    r_x = np.array([[1, 0, 0], [0, np.cos(b), -np.sin(b)],
                    [0, np.sin(b), np.cos(b)]])
    rect = np.eye(4)
    rect[:3, :3] = r_x @ r_y
    return dict(calib, R0_rect=rect,
                Tr_velo_to_cam=syn.LIDAR_TO_CAM.astype(np.float64))


def _kitti_cars(rng, p2, img_hw):
    """1-6 cars in camera-2 coordinates, each inside the image, with the 2D
    box of its projected corners (clipped to the image)."""
    from ..eval.kitti_eval import _camera_corners

    h, w = img_hw
    n = rng.randint(1, 7)
    loc = np.zeros((n, 3))
    loc[:, 2] = rng.uniform(8.0, 45.0, n)
    loc[:, 0] = loc[:, 2] * rng.uniform(-0.6, 0.6, n)
    loc[:, 1] = rng.uniform(1.5, 1.8, n)
    dims = np.stack([rng.uniform(3.5, 4.5, n), rng.uniform(1.4, 1.8, n),
                     rng.uniform(1.5, 1.8, n)], 1)                 # (l, h, w)
    rot = rng.uniform(-np.pi, np.pi, n)
    corners = _camera_corners(np.concatenate([loc, dims, rot[:, None]], 1))
    uvw = corners @ p2[:3, :3].T + p2[:3, 3]
    uv = uvw[..., :2] / uvw[..., 2:3]
    bbox = np.concatenate([uv.min(1), uv.max(1)], 1)
    bbox[:, [0, 2]] = bbox[:, [0, 2]].clip(0, w)
    bbox[:, [1, 3]] = bbox[:, [1, 3]].clip(0, h)
    return dict(
        name=np.array(['Car'] * n), truncated=np.zeros(n),
        occluded=np.zeros(n, np.int64),
        alpha=rot - np.arctan2(loc[:, 0], loc[:, 2]), bbox=bbox,
        dimensions=dims, location=loc, rotation_y=rot)


def kitti_split(root, n: int, seed: int = 0, frame_hw=KITTI_FRAME):
    """``n`` KITTI frames (``training/image_2/*.png``) of one recording
    day's calibration (:func:`kitti_calib`) and ``kitti_infos_val.pkl``."""
    rng = np.random.RandomState(seed)
    calib = kitti_calib(rng)
    infos = []
    for idx in range(n):
        rel = f'training/image_2/{idx:06d}.png'
        _write_frame(root, rel, rng, *frame_hw)
        infos.append(dict(
            image=dict(image_idx=idx, image_path=rel,
                       image_shape=np.array(frame_hw, np.int32)),
            calib=calib, annos=_kitti_cars(rng, calib['P2'], frame_hw)))
    return _dump(infos, os.path.join(root, 'kitti_infos_val.pkl'))


# --------------------------------------------------------------------------
# SUN RGB-D and Total3D
# --------------------------------------------------------------------------

SUNRGBD_FRAME = (530, 730)


def sunrgbd_split(root, n: int, seed: int = 0, n_classes: int = 10,
                  total3d: bool = False, frame_hw=SUNRGBD_FRAME):
    """``n`` SUN RGB-D frames (``image/*.jpg`` holding PNG content) and
    ``sunrgbd_infos_val.pkl``: a camera pitched by -8..-2 degrees and
    rolled by -3..3 over :func:`furniture_boxes` of ``n_classes`` classes.
    ``total3d`` adds the camera's ``angles`` and a ``layout`` room and
    writes every second frame as a mirrored ``*_flip.jpg`` entry (the
    loader mirrors it back from the unflipped file)."""
    rng = np.random.RandomState(seed)
    h, w = frame_hw
    f = 529.5 * w / SUNRGBD_FRAME[1]
    k = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    infos = []
    for idx in range(n):
        pitch = np.deg2rad(rng.uniform(-8.0, -2.0))
        roll = np.deg2rad(rng.uniform(-3.0, 3.0))
        boxes, labels, mask = syn.furniture_boxes(rng, 1, 16, n_classes)
        boxes, labels = boxes[0][mask[0]], labels[0][mask[0]]
        rel = f'image/{idx:06d}.jpg'
        _write_frame(root, rel, rng, h, w)
        stored = boxes.astype(np.float64).copy()
        stored[:, 2] += stored[:, 5] / 2         # origin (.5, .5, .5)
        info = dict(
            image=dict(image_idx=idx, image_path=rel,
                       image_shape=np.array(frame_hw, np.int32)),
            calib=dict(K=k.T.reshape(-1), Rt=syn._rotation(pitch, roll)),
            annos=dict(gt_num=len(boxes), gt_boxes_upright_depth=stored,
                       name=np.array([f'class{c}' for c in labels]),
                       **{'class': labels.astype(np.int64)}))
        if total3d:
            room = syn.layout_boxes(rng, boxes[None], np.ones((1, len(boxes)),
                                                              bool))[0]
            room = room.astype(np.float64)
            room[2] += room[5] / 2
            info.update(angles=np.array([pitch, roll]), layout=room)
            if idx % 2:
                info['image'] = dict(info['image'],
                                     image_path=rel.replace('.jpg',
                                                            '_flip.jpg'))
        infos.append(info)
    return _dump(infos, os.path.join(root, 'sunrgbd_infos_val.pkl'))


# --------------------------------------------------------------------------
# ScanNet
# --------------------------------------------------------------------------

def scannet_split(root, n_scenes: int, views: int, seed: int = 0,
                  n_classes: int = 18, frame_hw=(480, 640)):
    """``n_scenes`` ScanNet scenes of ``views`` posed frames each
    (``posed_images/<scene>/*.jpg`` holding PNG content) and
    ``scannet_infos_val.pkl``: cameras at 1.2-1.7 m on a circle around the
    room's middle looking at it, poses in the scan's frame, which a random
    ``axis_align_matrix`` turns into the frame of :func:`room_boxes`."""
    rng = np.random.RandomState(seed)
    h, w = frame_hw
    f = syn.SCANNET_F * w / syn.SCANNET_W
    intr = np.array([[f, 0, w / 2, 0], [0, f, h / 2, 0], [0, 0, 1, 0],
                     [0, 0, 0, 1]])
    infos = []
    for s in range(n_scenes):
        t = rng.uniform(-np.pi, np.pi)
        align = np.eye(4)
        align[:2, :2] = [[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]]
        align[:3, 3] = rng.uniform(-3.0, 3.0, 3)
        paths, poses = [], []
        for v in range(views):
            a = 2 * np.pi * (v + rng.uniform(-0.3, 0.3)) / views
            r = rng.uniform(2.2, 2.8)
            eye = np.array([r * np.cos(a), r * np.sin(a),
                            rng.uniform(1.2, 1.7)])
            target = np.r_[rng.uniform(-0.5, 0.5, 2), rng.uniform(0.3, 0.8)]
            poses.append(np.linalg.inv(align) @ syn._look_at(eye, target))
            paths.append(f'posed_images/scene{s:04d}_00/{v:05d}.jpg')
            _write_frame(root, paths[-1], rng, h, w)
        boxes, labels, mask = syn.room_boxes(rng, 1, 16, n_classes)
        boxes, labels = boxes[0][mask[0]], labels[0][mask[0]]
        stored = boxes[:, :6].astype(np.float64).copy()
        stored[:, 2] += stored[:, 5] / 2         # origin (.5, .5, .5)
        infos.append(dict(
            img_paths=paths, intrinsics=intr, extrinsics=poses,
            annos=dict(gt_num=len(boxes), axis_align_matrix=align,
                       gt_boxes_upright_depth=stored,
                       **{'class': labels.astype(np.int64)})))
    return _dump(infos, os.path.join(root, 'scannet_infos_val.pkl'))


# --------------------------------------------------------------------------
# nuScenes
# --------------------------------------------------------------------------

NUSCENES_CAMERA_NAMES = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT',
                         'CAM_BACK', 'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')


def nuscenes_cams(rng):
    """The six cameras of :data:`synthetic.NUSCENES_CAMERAS` in the
    standard info file's form: ``sensor2lidar_rotation`` /
    ``_translation`` (camera to lidar) and ``cam_intrinsic`` (3, 3)."""
    cams = {}
    for name, (yaw, x, y, z) in zip(NUSCENES_CAMERA_NAMES,
                                    syn.NUSCENES_CAMERAS):
        a = np.deg2rad(yaw + rng.uniform(-1.0, 1.0))
        p = np.deg2rad(rng.uniform(-0.5, 0.5))
        ahead = np.array([np.cos(a) * np.cos(p), np.sin(a) * np.cos(p),
                          np.sin(p)])
        right = np.array([np.sin(a), -np.cos(a), 0.0])
        down = np.cross(ahead, right)
        k = np.array([[syn.NUSCENES_F, 0, syn.NUSCENES_C[0]],
                      [0, syn.NUSCENES_F, syn.NUSCENES_C[1]], [0, 0, 1]])
        cams[name] = dict(
            sensor2lidar_rotation=np.stack([right, down, ahead]).T,
            sensor2lidar_translation=np.array(
                [x - syn.LIDAR_ON_EGO[0], y - syn.LIDAR_ON_EGO[1],
                 z - syn.LIDAR_HEIGHT]),
            cam_intrinsic=k)
    return cams


def nuscenes_split(root, n: int, seed: int = 0,
                   frame_hw=(syn.NUSCENES_H, syn.NUSCENES_W)):
    """``n`` nuScenes samples of six frames (``samples/<CAM>/*.jpg``
    holding PNG content) and ``nuscenes_infos_val.pkl`` in the standard
    ``{'infos', 'metadata'}`` form, with :func:`nuscenes_cars` as
    gravity-center ``gt_boxes``."""
    rng = np.random.RandomState(seed)
    infos = []
    for s in range(n):
        cams = nuscenes_cams(rng)
        for name, cam in cams.items():
            cam['data_path'] = f'samples/{name}/{s:06d}.jpg'
            _write_frame(root, cam['data_path'], rng, *frame_hw)
        boxes, _, mask = syn.nuscenes_cars(rng, 1, 32)
        boxes = boxes[0][mask[0]].astype(np.float64)
        boxes[:, 2] += boxes[:, 5] / 2           # gravity center
        infos.append(dict(cams=cams, gt_boxes=boxes,
                          gt_names=np.array(['car'] * len(boxes)),
                          num_lidar_pts=np.full(len(boxes), 10),
                          valid_flag=np.ones(len(boxes), bool)))
    return _dump(dict(infos=infos, metadata=dict(version='synthetic')),
                 os.path.join(root, 'nuscenes_infos_val.pkl'))


# --------------------------------------------------------------------------
# learning scenes: one object and a bright blob at its projection
# --------------------------------------------------------------------------
# The scenes of the JAX package's tools/validate_learning*.py, written with
# the port's PNG writer: frames of dark noise (0-59) with a white rectangle
# around the projected gravity centre of the one GT box, which the info file
# stores as the dataset reads it (SUN RGB-D, ScanNet and nuScenes at the
# gravity centre, KITTI at the bottom centre in camera 2's frame).  Each
# writer returns the info file's path.

def _noise_frame(rng, h, w):
    return rng.randint(0, 60, (h, w, 3), np.uint8)


def _blob(img, u, v, half_w, half_h):
    """Paint the rectangle of half sizes ``half_w`` x ``half_h`` around
    pixel ``(u, v)`` white (both edges included), clipped to the frame."""
    h, w = img.shape[:2]
    img[max(v - half_h, 0):min(v + half_h, h - 1) + 1,
        max(u - half_w, 0):min(u + half_w, w - 1) + 1] = 255
    return [max(u - half_w, 0), max(v - half_h, 0), min(u + half_w, w - 1),
            min(v + half_h, h - 1)]


def _write(root, rel, img):
    path = os.path.join(root, rel)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    syn.write_png(path, img)


def kitti_learning_scene(root):
    """One Car 15 m ahead of camera 2 (:func:`kitti_calib`'s calibration)
    on a 1242x375 frame: ``kitti_infos_train.pkl``."""
    rng = np.random.RandomState(0)
    calib = kitti_calib(rng)
    h, w = KITTI_FRAME
    loc = np.array([2.0, 1.5, 15.0])      # x right, y down (bottom), z ahead
    dims = np.array([3.9, 1.56, 1.6])     # (l, h, w)
    p2 = calib['P2']
    uvw = p2[:3, :3] @ (loc - [0.0, dims[1] / 2, 0.0]) + p2[:3, 3]
    img = _noise_frame(rng, h, w)
    rect = _blob(img, int(uvw[0] / uvw[2]), int(uvw[1] / uvw[2]), 40, 25)
    rel = 'training/image_2/000000.png'
    _write(root, rel, img)
    info = dict(
        image=dict(image_idx=0, image_path=rel,
                   image_shape=np.array([h, w], np.int32)),
        calib=calib,
        annos=dict(name=np.array(['Car']), truncated=np.zeros(1),
                   occluded=np.zeros(1, np.int64), alpha=np.zeros(1),
                   bbox=np.array([rect], np.float64),
                   dimensions=dims[None], location=loc[None],
                   rotation_y=np.zeros(1)))
    return _dump([info], os.path.join(root, 'kitti_infos_train.pkl'))


def sunrgbd_learning_scene(root, total3d=False):
    """One 1 m box 3 m ahead of a 640x480 camera (fx 400): with ``Rt = I``,
    or for Total3D with the camera pitched 0.08 and rolled -0.05 rad (the
    stored ``Rt`` undoes the dataset's axis swap of
    ``predicted_extrinsics`` of those angles) and a room layout:
    ``infos.pkl``."""
    import torch

    from ..models.heads.layout_head import predicted_extrinsics

    rng = np.random.RandomState(0)
    fx, cx, cy = 400.0, 320.0, 240.0
    k = np.array([[fx, 0, cx], [0, fx, cy], [0, 0, 1]])
    box = np.array([0.5, 3.0, -0.5, 1.0, 1.0, 1.0, 0.3])   # bottom centre
    gc = box[:3] + [0.0, 0.0, box[5] / 2]
    extra = {}
    if total3d:
        angles = np.array([0.08, -0.05], np.float32)           # pitch, roll
        ext = predicted_extrinsics(torch.from_numpy(angles[None]))[0].numpy()
        e = ext[:3, :3].T.astype(np.float64)
        rt = np.stack([e[:, 0], e[:, 2], -e[:, 1]], axis=1)
        cam = ext[:3, :3] @ gc
        extra = dict(angles=angles, layout=np.array(
            [0.2, 3.2, 0.3, 5.0, 6.0, 3.0, 0.1], np.float32))
    else:
        rt = np.eye(3)
        cam = np.array([gc[0], -gc[2], gc[1]])    # (x, -z, y) of the depth
    img = _noise_frame(rng, 480, 640)
    _blob(img, int(fx * cam[0] / cam[2] + cx), int(fx * cam[1] / cam[2] + cy),
          60, 60)
    rel = 'image/000001.png'
    _write(root, rel, img)
    stored = box.copy()
    stored[2] += box[5] / 2                       # origin (.5, .5, .5)
    info = dict(image=dict(image_idx=1, image_path=rel,
                           image_shape=np.array([480, 640], np.int32)),
                calib=dict(K=k.T.reshape(-1), Rt=rt),
                annos=dict(gt_num=1, gt_boxes_upright_depth=stored[None],
                           name=np.array(['bed']),
                           **{'class': np.array([0])}),
                **extra)
    return _dump([info], os.path.join(root, 'infos.pkl'))


def scannet_learning_scene(root):
    """One axis-aligned 1 m box seen by three 640x480 cameras (fx 300) 4 m
    away, at 0 and +-0.4 rad around it: ``infos.pkl``."""
    rng = np.random.RandomState(0)
    center = np.array([0.3, -0.2, 0.5])
    fx, cx, cy = 300.0, 320.0, 240.0
    poses, paths = [], []
    for i, a in enumerate((0.0, 0.4, -0.4)):
        c, s = np.cos(a), np.sin(a)
        pose = np.eye(4)                          # camera to world
        pose[:3, 0] = [-s, c, 0.0]                # x right
        pose[:3, 1] = [0.0, 0.0, -1.0]            # y down
        pose[:3, 2] = [c, s, 0.0]                 # z: at the box
        pose[:3, 3] = center - 4.0 * np.array([c, s, 0.0])
        pc = (np.linalg.inv(pose) @ np.r_[center, 1.0])[:3]
        img = _noise_frame(rng, 480, 640)
        _blob(img, int(fx * pc[0] / pc[2] + cx), int(fx * pc[1] / pc[2] + cy),
              50, 50)
        paths.append(f'posed_images/scene/{i}.png')
        _write(root, paths[-1], img)
        poses.append(pose)
    info = dict(
        img_paths=paths,
        intrinsics=np.array([[fx, 0, cx, 0], [0, fx, cy, 0], [0, 0, 1, 0],
                             [0, 0, 0, 1]]),
        extrinsics=poses,
        annos=dict(gt_num=1, axis_align_matrix=np.eye(4),
                   gt_boxes_upright_depth=np.r_[center, 1.0, 1.0, 1.0][None],
                   **{'class': np.array([0])}))
    return _dump([info], os.path.join(root, 'infos.pkl'))


def nuscenes_learning_scene(root):
    """One car among six 320x192 cameras (fx 120) ringing the ego, drawn
    into every camera that sees it through the dataset's own ``lidar2img``:
    ``infos.pkl`` in the standard ``{'infos', 'metadata'}`` form."""
    from ..data.datasets import NuScenesMultiViewDataset
    from ..data.pipeline import ImagePipelineConfig

    rng = np.random.RandomState(0)
    h, w = 192, 320
    fx = 120.0
    gt_gc = np.array([2.4, 0.4, -0.3, 1.9, 4.6, 1.7, 0.25], np.float32)
    cams, imgs = {}, []
    for i, cam in enumerate(NuScenesMultiViewDataset.CAMERAS):
        # camera i faces lidar yaw theta: the rotation's columns are the
        # camera's x right, y down and z ahead in the lidar frame
        theta = np.deg2rad((0, -55, 55, 180, 125, -125)[i])
        cams[cam] = dict(
            data_path=f'samples/{cam}/0.png',
            cam_intrinsic=np.array([[fx, 0, w / 2], [0, fx, h / 2],
                                    [0, 0, 1.0]]),
            sensor2lidar_rotation=np.array(
                [[np.sin(theta), 0.0, np.cos(theta)],
                 [-np.cos(theta), 0.0, np.sin(theta)], [0.0, -1.0, 0.0]]),
            sensor2lidar_translation=np.array([0.0, 0.0, 0.2]))
        imgs.append(_noise_frame(rng, h, w))
    ann_file = _dump(dict(infos=[dict(
        cams=cams, gt_boxes=gt_gc[None], gt_names=np.array(['car']),
        num_lidar_pts=np.array([10]))], metadata=dict(version='synthetic')),
        os.path.join(root, 'infos.pkl'))
    data = NuScenesMultiViewDataset(root, ann_file, ('car',),
                                    ImagePipelineConfig()).get_data_info(0)
    n_seen = 0
    for i, cam in enumerate(NuScenesMultiViewDataset.CAMERAS):
        l2i = np.asarray(data['extrinsics'][i], np.float64)
        uvw = l2i[:3, :3] @ gt_gc[:3] + l2i[:3, 3]
        u, v = (int(uvw[0] / uvw[2]), int(uvw[1] / uvw[2])) if (
            uvw[2] > 0.5) else (-1, -1)
        if 0 <= u < w and 0 <= v < h:
            _blob(imgs[i], u, v, int(fx * gt_gc[4] / 2 / uvw[2]),
                  int(fx * gt_gc[5] / 2 / uvw[2]))
            n_seen += 1
        _write(root, cams[cam]['data_path'], imgs[i])
    if n_seen == 0:
        raise AssertionError('the car projects into no camera')
    return ann_file
