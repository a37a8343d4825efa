"""Dataset readers producing fixed-shape batches for the detector.

Counterpart of ``imvoxelnet_tpu/data/datasets.py``: the same classes, the
same info-file schemas, the same ``RandomState`` draws in the same order
and the same samples, bit for bit; ``collate`` gives the detector's batch
as torch tensors on the host (``models/detector.py``'s layout, the keys and
dtypes of ``utils/synthetic.py``).

Reimplements the per-dataset ``get_data_info`` / ``get_ann_info`` logic of
``mmdet3d/datasets/*_monocular_dataset.py`` + the base datasets, reading the
same info-pkl formats the reference's ``tools/create_data.py`` emits:

  - KITTI:   ``kitti_monocular_dataset.py:10-37`` (rect@Trv2c extrinsic with
             P2-translation folding, zero-translation P2 intrinsic) +
             ``kitti_dataset.py:137-193`` camera->lidar GT conversion.
  - SUN RGB-D: ``sunrgbd_monocular_dataset.py:12-80`` (K transpose, Rt axis
             swap, fixed origin [0, 3, -1]); Total3D adds angles + layout
             (:103-151, converter ``tools/data_converter/sunrgbd_total.py``).
  - ScanNet: ``scannet_monocular_dataset.py:13-61`` (per-frame extrinsics
             ``inv(axis_align @ pose)``, origin [0, 0, .5], yaw-free boxes).
  - nuScenes: ``nuscenes_monocular_dataset.py:10-41`` (6 cameras, identity
             intrinsic with lidar2img extrinsics, car-only GT).

Boxes come out as bottom-center ``(N, 7)`` float arrays (the DepthInstance /
LiDARInstance tensor layout with yaw about z).
"""

from __future__ import annotations

import os
import pickle
from typing import Optional

import numpy as np
import torch

from . import pipeline as pl

# CAM -> LIDAR default rotation (box_3d_mode.py:108-111)
_CAM2LIDAR_SIZE_PERM = (2, 0, 1)  # (x_size, y_size, z_size) -> (z, x, y)


def load_infos(ann_file):
    with open(ann_file, 'rb') as f:
        return pickle.load(f)


class BaseMultiViewDataset:
    """Common machinery: info list + image pipeline + fixed-shape samples."""

    def __init__(self, data_root, ann_file, classes, img_cfg: pl.ImagePipelineConfig,
                 n_images: int = 1, max_gt: int = 32, test_mode: bool = False,
                 filter_empty_gt: bool = True, repeat: int = 1):
        self.data_root = data_root
        self.classes = tuple(classes)
        self.img_cfg = img_cfg
        self.n_images = n_images
        self.max_gt = max_gt
        self.test_mode = test_mode
        self.filter_empty_gt = filter_empty_gt
        self.repeat = repeat
        self.data_infos = load_infos(ann_file)

    def __len__(self):
        return len(self.data_infos) * (1 if self.test_mode else self.repeat)

    def _index(self, i):
        return i % len(self.data_infos)

    # -- per-dataset hooks -------------------------------------------------
    def load_view_image(self, path):
        return pl.load_image(path)

    def get_data_info(self, index):
        raise NotImplementedError

    def get_ann_info(self, index):
        raise NotImplementedError

    def post_geometry(self, sample, ann, info, train, rng):
        """Dataset-specific origin/flip logic; mutates ``sample``/``ann``."""

    # -- sample assembly ----------------------------------------------------
    def get_sample(self, index, train: bool, rng: np.random.RandomState):
        """One fixed-shape sample dict (numpy); parity with
        ``MultiViewPipeline.__call__`` (``pipelines/multi_view.py:12-31``)."""
        index = self._index(index)
        data = self.get_data_info(index)
        n_avail = len(data['img_paths'])
        ids = rng.choice(n_avail, self.n_images,
                         replace=self.n_images > n_avail)
        imgs, infos = [], []
        for i in ids.tolist():
            img = self.load_view_image(
                os.path.join(self.data_root, data['img_paths'][i]))
            img, info = pl.process_image(img, self.img_cfg, train, rng)
            imgs.append(img)
            infos.append(info)
        sample = dict(
            images=np.stack(imgs),                                  # (V,H,W,3)
            intrinsics=np.asarray(data['intrinsic'], np.float32)[:3, :3],
            extrinsics=np.stack([np.asarray(data['extrinsics'][i], np.float32)
                                 for i in ids.tolist()]),
            origin=np.asarray(data.get('origin', (0, 0, 0)), np.float32),
            img_shape=np.asarray(infos[0]['img_shape'], np.int32),
            ori_shape=np.asarray(infos[0]['ori_shape'], np.int32),
            scale_factor=np.float32(infos[0]['scale_factor']),
            flip=bool(infos[0]['flip']),
            index=index,
        )
        # ratio = ori_h / (img_h / stride)  (imvoxelnet.py:118)
        sample['ratio'] = np.float32(
            sample['ori_shape'][0] / (sample['img_shape'][0] / 4.0))

        ann = self.get_ann_info(index) if not self.test_mode else None
        self.post_geometry(sample, ann, self.data_infos[index], train, rng)
        if ann is not None:
            boxes, labels, mask = pl.pad_gt(
                ann['gt_bboxes_3d'], ann['gt_labels_3d'], self.max_gt)
            sample.update(gt_boxes=boxes, gt_labels=labels, gt_mask=mask)
        return sample

    def collate(self, samples):
        """Stack samples into the detector's batch: a dict of host torch
        tensors (images float32, img_shape and gt_labels int32, gt_mask
        bool)."""
        batch = dict(
            images=np.stack([s['images'] for s in samples]),
            intrinsics=np.stack([s['intrinsics'] for s in samples]),
            extrinsics=np.stack([s['extrinsics'] for s in samples]),
            origins=np.stack([s['origin'] for s in samples]),
            img_shape=np.stack([s['img_shape'] for s in samples]),
            ratios=np.stack([s['ratio'] for s in samples]),
        )
        if 'gt_boxes' in samples[0]:
            batch.update(
                gt_boxes=np.stack([s['gt_boxes'] for s in samples]),
                gt_labels=np.stack([s['gt_labels'] for s in samples]),
                gt_mask=np.stack([s['gt_mask'] for s in samples]))
        for extra in ('gt_angles', 'gt_layout'):
            if extra in samples[0]:
                batch[extra] = np.stack([s[extra] for s in samples])
        return {k: torch.from_numpy(v) for k, v in batch.items()}


class KittiMultiViewDataset(BaseMultiViewDataset):
    """Monocular KITTI (``kitti_monocular_dataset.py:10-37``)."""

    POINT_CLOUD_RANGE = (0, -39.68, -3, 69.12, 39.68, 1)

    def get_data_info(self, index):
        info = self.data_infos[index]
        rect = info['calib']['R0_rect'].astype(np.float32)
        trv2c = info['calib']['Tr_velo_to_cam'].astype(np.float32)
        p2 = info['calib']['P2'].astype(np.float32)
        extrinsic = rect @ trv2c
        extrinsic = extrinsic.copy()
        extrinsic[:3, 3] += np.linalg.inv(p2[:3, :3]) @ p2[:3, 3]
        intrinsic = p2.copy()
        intrinsic[:3, 3] = 0
        return dict(
            img_paths=[info['image']['image_path']],
            intrinsic=intrinsic,
            extrinsics=[extrinsic],
        )

    def get_ann_info(self, index):
        """Camera-frame GT -> lidar bottom-center boxes
        (``kitti_dataset.py:137-193`` + ``box_3d_mode.py:108-111``)."""
        info = self.data_infos[index]
        rect = info['calib']['R0_rect'].astype(np.float32)
        trv2c = info['calib']['Tr_velo_to_cam'].astype(np.float32)
        annos = info['annos']
        keep = [i for i, n in enumerate(annos['name']) if n != 'DontCare']
        loc = annos['location'][keep].astype(np.float32)
        dims = annos['dimensions'][keep].astype(np.float32)   # (l, h, w)
        rots = annos['rotation_y'][keep].astype(np.float32)
        names = annos['name'][keep]

        rt = np.linalg.inv(rect @ trv2c)
        xyz1 = np.concatenate([loc, np.ones((len(loc), 1), np.float32)], 1)
        xyz = (xyz1 @ rt.T)[:, :3]
        # cam sizes (x=l, y=h, z=w) -> lidar (dx=w, dy=l, dz=h)
        sizes = dims[:, [2, 0, 1]]
        boxes = np.concatenate([xyz, sizes, rots[:, None]], 1)
        labels = np.array(
            [self.classes.index(n) if n in self.classes else -1
             for n in names], np.int64)
        valid = labels >= 0
        return dict(gt_bboxes_3d=boxes[valid], gt_labels_3d=labels[valid])

    def post_geometry(self, sample, ann, info, train, rng):
        if train and sample['flip']:
            boxes = ann['gt_bboxes_3d'] if ann else None
            intr, extr, boxes = pl.kitti_random_flip(
                sample['intrinsics'], sample['extrinsics'][0], boxes,
                sample['ori_shape'])
            sample['intrinsics'] = intr
            sample['extrinsics'][0] = extr
            if ann is not None:
                ann['gt_bboxes_3d'] = boxes
        if ann is not None:
            ann['gt_bboxes_3d'], ann['gt_labels_3d'] = pl.object_range_filter(
                ann['gt_bboxes_3d'], ann['gt_labels_3d'],
                self.POINT_CLOUD_RANGE)
        sample['origin'] = pl.kitti_set_origin(self.POINT_CLOUD_RANGE)


class KittiStereoDataset(KittiMultiViewDataset):
    """Two-view KITTI (``kitti_monocular_dataset.py:40-77``; shipped but
    unused by any config, kept for surface parity)."""

    def get_data_info(self, index):
        info = self.data_infos[index]
        rect = info['calib']['R0_rect'].astype(np.float32)
        trv2c = info['calib']['Tr_velo_to_cam'].astype(np.float32)
        p2 = info['calib']['P2'].astype(np.float32)
        p3 = info['calib']['P3'].astype(np.float32)
        base = rect @ trv2c
        extrinsics = []
        for p in (p2, p3):
            e = base.copy()
            e[:3, 3] += np.linalg.inv(p[:3, :3]) @ p[:3, 3]
            extrinsics.append(e)
        intrinsic = p2.copy()
        intrinsic[:3, 3] = 0
        img2 = info['image']['image_path']
        return dict(
            img_paths=[img2, img2.replace('image_2', 'image_3')],
            intrinsic=intrinsic,
            extrinsics=extrinsics,
        )


class SunRgbdMultiViewDataset(BaseMultiViewDataset):
    """SUN RGB-D monocular (``sunrgbd_monocular_dataset.py:12-80``)."""

    ORIGIN = np.array([0.0, 3.0, -1.0], np.float32)
    flip_geometry = True

    def _matrices(self, info):
        intrinsic = info['calib']['K'].copy().reshape(3, 3).T
        extrinsic = info['calib']['Rt'].copy().astype(np.float32)
        extrinsic[:, [1, 2]] = extrinsic[:, [2, 1]]
        extrinsic[:, 1] = -extrinsic[:, 1]
        intr4 = np.eye(4, dtype=np.float32)
        intr4[:3, :3] = intrinsic
        extr4 = np.eye(4, dtype=np.float32)
        extr4[:3, :3] = extrinsic.T
        return intr4, extr4

    def get_data_info(self, index):
        info = self.data_infos[index]
        intr, extr = self._matrices(info)
        return dict(
            img_paths=[info['image']['image_path']],
            intrinsic=intr,
            extrinsics=[extr],
            origin=self.ORIGIN,
        )

    def get_ann_info(self, index):
        info = self.data_infos[index]
        annos = info['annos']
        if annos['gt_num'] == 0:
            return dict(gt_bboxes_3d=np.zeros((0, 7), np.float32),
                        gt_labels_3d=np.zeros((0,), np.int64))
        boxes = annos['gt_boxes_upright_depth'].astype(np.float32).copy()
        if boxes.shape[1] == 6:
            boxes = np.concatenate(
                [boxes, np.zeros((len(boxes), 1), np.float32)], 1)
        # stored with origin (.5, .5, .5) -> bottom-center
        boxes[:, 2] -= boxes[:, 5] / 2
        labels = annos['class'].astype(np.int64)
        return dict(gt_bboxes_3d=boxes, gt_labels_3d=labels)

    def post_geometry(self, sample, ann, info, train, rng):
        if train and sample['flip'] and self.flip_geometry:
            boxes = ann['gt_bboxes_3d'] if ann else None
            extr, boxes = pl.sunrgbd_random_flip(sample['extrinsics'][0], boxes)
            sample['extrinsics'][0] = extr
            if ann is not None:
                ann['gt_bboxes_3d'] = boxes


class SunRgbdPerspectiveMultiViewDataset(SunRgbdMultiViewDataset):
    """Same data, mAP@0.15 eval (``sunrgbd_monocular_dataset.py:84-99``)."""


class SunRgbdTotalMultiViewDataset(SunRgbdMultiViewDataset):
    """Total3DUnderstanding: + camera angles and room layout
    (``sunrgbd_monocular_dataset.py:103-151``).

    The Total3D json ships flipped duplicates as ``*_flip.jpg`` entries with
    pre-flipped geometry; the loader strips the suffix and mirrors the pixels
    (``SunRgbdTotalLoadImageFromFile``, ``pipelines/multi_view.py:96-105``).
    The in-pipeline RandomFlip is therefore disabled for this dataset.
    """

    flip_geometry = False

    def load_view_image(self, path):
        if path.endswith('_flip.jpg'):
            img = pl.load_image(path.replace('_flip.jpg', '.jpg'))
            return img[:, ::-1].copy()
        return pl.load_image(path)

    def get_sample(self, index, train, rng):
        sample = super().get_sample(index, train, rng)
        info = self.data_infos[self._index(index)]
        sample['gt_angles'] = info['angles'].astype(np.float32)
        layout = info['layout'].astype(np.float32).copy()
        layout[2] -= layout[5] / 2          # origin (.5,.5,.5) -> bottom
        sample['gt_layout'] = layout
        return sample


class ScanNetMultiViewDataset(BaseMultiViewDataset):
    """ScanNet multi-view (``scannet_monocular_dataset.py:13-61``)."""

    ORIGIN = np.array([0.0, 0.0, 0.5], np.float32)

    def __init__(self, *args, shift_origin_std=(0.7, 0.7, 0.0), **kwargs):
        super().__init__(*args, **kwargs)
        self.shift_origin_std = shift_origin_std

    def get_data_info(self, index):
        info = self.data_infos[index]
        axis_align = info['annos']['axis_align_matrix'].astype(np.float32)
        extrinsics = [
            np.linalg.inv(axis_align @ np.asarray(pose, np.float32))
            for pose in info['extrinsics']
        ]
        intr4 = np.eye(4, dtype=np.float32)
        intr = np.asarray(info['intrinsics'], np.float32)
        intr4[:3, :3] = intr[:3, :3]
        return dict(
            img_paths=list(info['img_paths']),
            intrinsic=intr4,
            extrinsics=extrinsics,
            origin=self.ORIGIN,
        )

    def get_ann_info(self, index):
        info = self.data_infos[index]
        annos = info['annos']
        if annos['gt_num'] == 0:
            return dict(gt_bboxes_3d=np.zeros((0, 7), np.float32),
                        gt_labels_3d=np.zeros((0,), np.int64))
        boxes6 = annos['gt_boxes_upright_depth'].astype(np.float32).copy()
        boxes6[:, 2] -= boxes6[:, 5] / 2    # origin (.5,.5,.5) -> bottom
        boxes = np.concatenate(
            [boxes6, np.zeros((len(boxes6), 1), np.float32)], 1)
        return dict(gt_bboxes_3d=boxes,
                    gt_labels_3d=annos['class'].astype(np.int64))

    def post_geometry(self, sample, ann, info, train, rng):
        if train:
            sample['origin'] = pl.random_shift_origin(
                sample['origin'], self.shift_origin_std, rng)


class NuScenesMultiViewDataset(BaseMultiViewDataset):
    """nuScenes 6-camera car-only (``nuscenes_monocular_dataset.py:10-41``).

    Reads the *standard* nuScenes info pkl (``nuscenes_converter.py``):
    per-camera ``cams[cam]`` entries with ``data_path``, ``cam_intrinsic`` and
    sensor2lidar transforms.  Like the reference wrapper, the full
    ``lidar2img`` matrix is passed as the per-view "extrinsic" with an
    identity intrinsic — the intrinsic rescale in ``_compute_projection``
    then scales the first two projection rows, which is exactly right.
    """

    CAMERAS = ('CAM_FRONT', 'CAM_FRONT_RIGHT', 'CAM_FRONT_LEFT', 'CAM_BACK',
               'CAM_BACK_LEFT', 'CAM_BACK_RIGHT')
    # imvoxelnet_nuscenes.py:73 — midpoint origin (0, 0, -1) via KittiSetOrigin
    POINT_CLOUD_RANGE = (-49.92, -49.92, -2.92, 49.92, 49.92, 0.92)

    def __init__(self, data_root, ann_file, *args, **kwargs):
        super().__init__(data_root, ann_file, *args, **kwargs)
        if isinstance(self.data_infos, dict):   # mmdet3d pkl: {infos, metadata}
            self.data_infos = self.data_infos['infos']

    def get_data_info(self, index):
        info = self.data_infos[index]
        img_paths, extrinsics = [], []
        for cam in self.CAMERAS:
            cam_info = info['cams'][cam]
            img_paths.append(cam_info['data_path'])
            l2c_r = np.linalg.inv(cam_info['sensor2lidar_rotation'])
            l2c_t = cam_info['sensor2lidar_translation'] @ l2c_r.T
            rt = np.eye(4)
            rt[:3, :3] = l2c_r.T
            rt[3, :3] = -l2c_t
            viewpad = np.eye(4)
            intrinsic = cam_info['cam_intrinsic']
            viewpad[:intrinsic.shape[0], :intrinsic.shape[1]] = intrinsic
            lidar2img = viewpad @ rt.T
            extrinsics.append(lidar2img.astype(np.float32))
        return dict(
            img_paths=img_paths,
            intrinsic=np.eye(4, dtype=np.float32),
            extrinsics=extrinsics,
        )

    def get_ann_info(self, index):
        """Standard nuScenes GT -> car-only lidar boxes
        (``nuscenes_dataset.py`` + the car filter at
        ``nuscenes_monocular_dataset.py:26-35``)."""
        info = self.data_infos[index]
        mask = info.get('valid_flag',
                        np.asarray(info['num_lidar_pts']) > 0)
        boxes = np.asarray(info['gt_boxes'], np.float32)[mask][:, :7]
        names = np.asarray(info['gt_names'])[mask]
        # boxes stored with gravity-center origin -> bottom-center
        boxes = boxes.copy()
        boxes[:, 2] -= boxes[:, 5] / 2
        keep = names == 'car'
        labels = np.zeros(int(keep.sum()), np.int64)
        return dict(gt_bboxes_3d=boxes[keep], gt_labels_3d=labels)

    def post_geometry(self, sample, ann, info, train, rng):
        """ObjectRangeFilter + KittiSetOrigin, matching the reference train and
        test pipelines (``imvoxelnet_nuscenes.py:95-96`` train, ``:105`` test;
        ``pipelines/multi_view.py:46-53``)."""
        if ann is not None:
            ann['gt_bboxes_3d'], ann['gt_labels_3d'] = pl.object_range_filter(
                ann['gt_bboxes_3d'], ann['gt_labels_3d'],
                self.POINT_CLOUD_RANGE)
        sample['origin'] = pl.kitti_set_origin(self.POINT_CLOUD_RANGE)


class CBGSDataset:
    """Class-balanced grouping-and-sampling wrapper
    (``dataset_wrappers.py:44-79``): duplicates sample indices so every class
    appears with roughly equal frequency over an epoch."""

    def __init__(self, dataset):
        self.dataset = dataset
        self.sample_indices = self._balanced_indices()

    def _balanced_indices(self):
        n_classes = len(self.dataset.classes)
        class_to_samples = {i: [] for i in range(n_classes)}
        for idx in range(len(self.dataset.data_infos)):
            ann = self.dataset.get_ann_info(idx)
            for label in np.unique(ann['gt_labels_3d']):
                if 0 <= label < n_classes:
                    class_to_samples[int(label)].append(idx)
        duplicated = sum(len(v) for v in class_to_samples.values())
        if duplicated == 0:
            return list(range(len(self.dataset.data_infos)))
        frac = 1.0 / n_classes
        ratios = [frac / max(len(v) / duplicated, 1e-6)
                  for v in class_to_samples.values()]
        indices = []
        rng = np.random.RandomState(0)
        for (cls, samples), ratio in zip(class_to_samples.items(), ratios):
            n_take = int(len(samples) * ratio)
            if samples and n_take:
                indices += rng.choice(samples, n_take).tolist()
        return indices or list(range(len(self.dataset.data_infos)))

    def __len__(self):
        return len(self.sample_indices)

    def __getattr__(self, name):
        return getattr(self.dataset, name)

    def get_sample(self, index, train, rng):
        return self.dataset.get_sample(
            self.sample_indices[index % len(self.sample_indices)], train, rng)

    def collate(self, samples):
        return self.dataset.collate(samples)


DATASETS = {
    'kitti': KittiMultiViewDataset,
    'kitti_stereo': KittiStereoDataset,
    'sunrgbd': SunRgbdMultiViewDataset,
    'sunrgbd_perspective': SunRgbdPerspectiveMultiViewDataset,
    'sunrgbd_total': SunRgbdTotalMultiViewDataset,
    'scannet': ScanNetMultiViewDataset,
    'nuscenes': NuScenesMultiViewDataset,
}
