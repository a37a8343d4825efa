"""The one traffic generator: pools of distinct seeded batches.

A traffic mix (``portbench/traffic/<name>.json``) names the mode (``serve``
or ``train``), the batch size and how many distinct batches the pool
holds; the configuration's file names the dataset, the image sizes and the
assumed ground truth per scene.  Everything is drawn from ``--seed``: the
cameras and boxes on the host (a few hundred numbers), the images on the
device in one call.  The scene geometry is the dataset's scenes module
(``scenes/<data.dataset>.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import spec


def rng_for(seed: int, *tags: int) -> np.random.RandomState:
    """A host generator for ``seed`` (any size of integer) and ``tags``."""
    words = np.random.SeedSequence([int(seed), *tags]).generate_state(8)
    return np.random.RandomState(words)


def torch_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from ``seed`` and ``tags``."""
    word = np.random.SeedSequence([int(seed), *tags]).generate_state(
        1, np.uint64)[0]
    return int(word) & ((1 << 63) - 1)


def make_pool(config: dict, traffic: dict, seed: int, device):
    """``traffic['pool']`` distinct batches of ``traffic['batch']`` scenes
    of ``config``'s dataset in the detector's layout, on ``device``.
    Serving batches are at the test size, training batches at the train
    size with padded ground truth."""
    data = config['data']
    scenes = spec.scenes(data['dataset'])
    train = traffic['mode'] == 'train'
    b, n = traffic['batch'], traffic['pool']
    w, h = data['train_size'] if train else data['test_size']
    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, 1))
    images = torch.randn((n, b, scenes.VIEWS, h, w, 3), generator=gen,
                         device=device)
    pool = []
    for i in range(n):
        rng = rng_for(seed, 2, i)
        k, ext, origins = scenes.cameras(rng, b, (w, h), train)
        batch = dict(
            images=images[i],
            intrinsics=torch.tensor(k, device=device),
            extrinsics=torch.tensor(ext, device=device),
            origins=torch.tensor(origins, device=device),
            img_shape=torch.tensor([[h, w]] * b, dtype=torch.int32,
                                   device=device),
            ratios=torch.full((b,), scenes.ratio(w), device=device))
        if train:
            boxes, labels, mask = scenes.ground_truth(rng, b, (w, h), data)
            batch.update(gt_boxes=torch.tensor(boxes, device=device),
                         gt_labels=torch.tensor(labels, device=device),
                         gt_mask=torch.tensor(mask, device=device))
        pool.append(batch)
    return pool
