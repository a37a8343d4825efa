"""ScanNet posed-image extraction + info pkl converter.

Counterpart of
``imvoxelnet_tpu/data/converters/scannet_converter.py``, as it is.

Parity:
  - ``data/scannet/extract_posed_images.py`` — decode ``.sens`` streams
    (public ScanNet SensorData format: version-4 header with the four 4x4
    matrices, then per-frame pose + compressed color/depth) to jpg + pose txt
    + intrinsic txt, sampling at most ``max_frames`` per scene.
  - ``tools/data_converter/scannet_data_utils.py:56-121`` — per-scene infos
    with intrinsics/extrinsics/img_paths (non-finite poses dropped), GT boxes
    from ``scannet_instance_data/{scene}_bbox.npy`` and the axis-align matrix.
"""

from __future__ import annotations

import os
import pickle
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SCANNET_CLASSES = ('cabinet', 'bed', 'chair', 'sofa', 'table', 'door',
                   'window', 'bookshelf', 'picture', 'counter', 'desk',
                   'curtain', 'refrigerator', 'showercurtrain', 'toilet',
                   'sink', 'bathtub', 'garbagebin')


class SensReader:
    """Minimal .sens (version 4) stream decoder."""

    def __init__(self, path):
        self.path = path

    def extract(self, out_dir, max_frames=300):
        os.makedirs(out_dir, exist_ok=True)
        with open(self.path, 'rb') as f:
            version = struct.unpack('I', f.read(4))[0]
            assert version == 4, version
            strlen = struct.unpack('Q', f.read(8))[0]
            f.read(strlen)  # sensor name
            intrinsic_color = np.frombuffer(
                f.read(64), np.float32).reshape(4, 4)
            f.read(64)  # extrinsic_color
            f.read(64)  # intrinsic_depth
            f.read(64)  # extrinsic_depth
            color_compression = struct.unpack('i', f.read(4))[0]
            f.read(4)   # depth compression
            color_w = struct.unpack('I', f.read(4))[0]
            color_h = struct.unpack('I', f.read(4))[0]
            f.read(8)   # depth width/height
            f.read(4)   # depth shift
            num_frames = struct.unpack('Q', f.read(8))[0]
            assert color_compression == 2, 'expect jpeg color'

            stride = max(num_frames // max_frames, 1)
            kept = 0
            for i in range(num_frames):
                pose = np.frombuffer(f.read(64), np.float32).reshape(4, 4)
                f.read(16)  # timestamps
                color_bytes = struct.unpack('Q', f.read(8))[0]
                depth_bytes = struct.unpack('Q', f.read(8))[0]
                color = f.read(color_bytes)
                f.read(depth_bytes)
                if i % stride != 0:
                    continue
                with open(os.path.join(out_dir, f'{kept:05d}.jpg'), 'wb') as g:
                    g.write(color)   # already jpeg
                np.savetxt(os.path.join(out_dir, f'{kept:05d}.txt'), pose)
                kept += 1
            np.savetxt(os.path.join(out_dir, 'intrinsic.txt'),
                       intrinsic_color)
        return kept


def extract_posed_images(root_path, max_frames=300, num_workers=4):
    scans_dir = os.path.join(root_path, 'scans')
    out_root = os.path.join(root_path, 'posed_images')
    scenes = sorted(os.listdir(scans_dir))

    def process(scene):
        sens = os.path.join(scans_dir, scene, f'{scene}.sens')
        if os.path.exists(sens):
            SensReader(sens).extract(os.path.join(out_root, scene),
                                     max_frames)

    with ThreadPoolExecutor(num_workers) as pool:
        list(pool.map(process, scenes))


def create_scannet_infos(root_path, split='train'):
    split_file = os.path.join(root_path, 'meta_data',
                              f'scannetv2_{split}.txt')
    with open(split_file) as f:
        scenes = [line.strip() for line in f if line.strip()]
    cat2label = {c: i for i, c in enumerate(SCANNET_CLASSES)}
    del cat2label  # classes already encoded in the bbox npy

    infos = []
    inst_dir = os.path.join(root_path, 'scannet_instance_data')
    posed_dir = os.path.join(root_path, 'posed_images')
    for scene in scenes:
        info = dict(point_cloud=dict(num_features=6, lidar_idx=scene))
        scene_posed = os.path.join(posed_dir, scene)
        if os.path.isdir(scene_posed):
            files = sorted(os.listdir(scene_posed))
            img_paths, extrinsics = [], []
            for fn in files:
                if fn.endswith('.jpg'):
                    pose = np.loadtxt(
                        os.path.join(scene_posed, fn[:-4] + '.txt'))
                    if np.all(np.isfinite(pose)):
                        img_paths.append(
                            os.path.join('posed_images', scene, fn))
                        extrinsics.append(pose)
            info['img_paths'] = img_paths
            info['extrinsics'] = extrinsics
            info['intrinsics'] = np.loadtxt(
                os.path.join(scene_posed, 'intrinsic.txt'))

        bbox_path = os.path.join(inst_dir, f'{scene}_bbox.npy')
        axis_path = os.path.join(inst_dir, f'{scene}_axis_align_matrix.npy')
        annos = dict(gt_num=0, axis_align_matrix=np.eye(4))
        if os.path.exists(axis_path):
            annos['axis_align_matrix'] = np.load(axis_path)
        if os.path.exists(bbox_path):
            boxes = np.load(bbox_path)   # (K, 7): x y z dx dy dz class
            annos.update(
                gt_num=len(boxes),
                gt_boxes_upright_depth=boxes[:, :6],
                **{'class': boxes[:, 6].astype(np.int64)},
            )
        info['annos'] = annos
        infos.append(info)

    out = os.path.join(root_path, f'scannet_imvoxelnet_infos_{split}.pkl')
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'{len(infos)} infos -> {out}')
    return infos
