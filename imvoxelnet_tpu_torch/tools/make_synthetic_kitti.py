"""Write a multi-scene synthetic KITTI split for training runs.

    python -m imvoxelnet_tpu_torch.tools.make_synthetic_kitti --out DIR \\
        [--train 400] [--val 32] [--seed 0]

Counterpart of the JAX package's ``tools/make_synthetic_kitti.py``: each
frame (1242 x 375, KITTI's camera 2) places 1-4 cars at random
road-plausible camera positions with a bright filled rectangle at each
one's projection, so that a model can learn from it; ``kitti_infos_train.pkl``
and ``kitti_infos_val.pkl`` (indices disjoint) make ``DIR`` a
``--data-root`` for the port's ``tools/train.py`` and ``tools/test.py``.
:func:`make_split` is the JAX tool's, drawing the same numbers from the
same generator; the rectangle is filled with numpy (the pixels
``cv2.rectangle`` fills) and the frame written as PNG by
``utils/synthetic.write_png`` (the bytes cv2 would decode to the same
pixels: the array is BGR, as cv2 takes it).  The calibration comes from
``utils/synthetic_splits.kitti_calib`` (:func:`kitti_base`) instead of the
reference checkout's fixture.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from ..utils.synthetic import write_png
from ..utils.synthetic_splits import KITTI_FRAME, kitti_calib


def kitti_base(seed: int = 0) -> dict:
    """The info every frame starts from: ``image`` and a recording day's
    ``calib`` (``kitti_calib``), no annotations."""
    return dict(image=dict(image_idx=0, image_path='',
                           image_shape=np.array(KITTI_FRAME, np.int32)),
                calib=kitti_calib(np.random.RandomState(seed)))


def fill_rect(img, pt1, pt2, color):
    """``cv2.rectangle(img, pt1, pt2, color, -1)``: both corners' rows and
    columns inclusive, clipped to the image."""
    (x0, y0), (x1, y1) = pt1, pt2
    x0, x1 = sorted((x0, x1))
    y0, y1 = sorted((y0, y1))
    h, w = img.shape[:2]
    img[max(y0, 0):min(y1, h - 1) + 1, max(x0, 0):min(x1, w - 1) + 1] = color


def make_split(base, root, name, n_scenes, rng, start_idx=0):
    calib = base['calib']
    p2 = calib['P2'].astype(np.float64)
    infos = []
    img_dir = os.path.join(root, 'training', 'image_2')
    os.makedirs(img_dir, exist_ok=True)
    for s in range(n_scenes):
        idx = start_idx + s
        # retry until at least one car lands inside the frustum, so that
        # every requested index is written exactly once
        names = []
        for _attempt in range(64):
            n_cars = rng.randint(1, 5)
            img = rng.randint(0, 60, (375, 1242, 3)).astype(np.uint8)
            names, bboxes, dims, locs, rots = [], [], [], [], []
            for _ in range(n_cars):
                # camera frame: x right, y down (ground ~1.6m below cam), z fwd
                loc = np.array([rng.uniform(-8.0, 8.0), rng.uniform(1.4, 1.7),
                                rng.uniform(8.0, 45.0)])
                rot = rng.uniform(-np.pi, np.pi)
                l, h, w = (rng.uniform(3.5, 4.5), rng.uniform(1.4, 1.8),
                           rng.uniform(1.5, 1.8))
                uvw = p2[:3, :3] @ loc + p2[:3, 3]
                u, v = uvw[0] / uvw[2], uvw[1] / uvw[2]
                if not (40 < u < 1202 and 40 < v < 345):
                    continue
                # apparent size ~ focal * metric / depth; jitter intensity so
                # the score distribution is not degenerate
                fu = p2[0, 0]
                hw = max(6, int(fu * l / (2.5 * loc[2])))
                hh = max(5, int(fu * h / (2.0 * loc[2])))
                tint = int(rng.uniform(140, 255))
                fill_rect(img, (int(u) - hw, int(v) - hh),
                          (int(u) + hw, int(v) + int(0.4 * hh)),
                          (tint, tint, tint))
                names.append('Car')
                bboxes.append([u - hw, v - hh, u + hw, v + 0.4 * hh])
                dims.append([l, h, w])
                locs.append(loc)
                rots.append(rot)
            if names:
                break
        assert names, f'scene {idx}: no in-frustum car after 64 attempts'
        k = len(names)
        rel = f'training/image_2/{idx:06d}.png'
        # BGR, as cv2.imwrite takes the array
        write_png(os.path.join(root, rel), np.ascontiguousarray(
            img[:, :, ::-1]))
        info = dict(base)
        info['image'] = dict(base['image'],
                             image_idx=idx, image_path=rel,
                             image_shape=np.array([375, 1242], np.int32))
        info['annos'] = dict(
            name=np.array(names),
            truncated=np.zeros(k), occluded=np.zeros(k, np.int64),
            alpha=np.asarray(rots),
            bbox=np.asarray(bboxes, np.float64),
            dimensions=np.asarray(dims, np.float64),
            location=np.asarray(locs, np.float64),
            rotation_y=np.asarray(rots, np.float64),
            score=np.zeros(k), index=np.arange(k, dtype=np.int32),
            group_ids=np.arange(k, dtype=np.int32),
            difficulty=np.zeros(k, np.int32),
        )
        infos.append(info)
    out = os.path.join(root, f'kitti_infos_{name}.pkl')
    with open(out, 'wb') as f:
        pickle.dump(infos, f)
    print(f'{name}: {len(infos)} scenes -> {out}')
    return len(infos)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--out', required=True)
    parser.add_argument('--train', type=int, default=400)
    parser.add_argument('--val', type=int, default=32)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args(argv)

    base = kitti_base(args.seed)
    rng = np.random.RandomState(args.seed)
    os.makedirs(args.out, exist_ok=True)
    # val indices start at the requested train count, so the two splits
    # never share an image index
    make_split(base, args.out, 'train', args.train, rng)
    make_split(base, args.out, 'val', args.val, rng, start_idx=args.train)


if __name__ == '__main__':
    main()
