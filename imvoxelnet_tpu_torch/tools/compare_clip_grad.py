"""The clip's backward kernel of this checkout against other copies of the
port, bit for bit and timed in turns on one card.

    python3 -m imvoxelnet_tpu_torch.tools.compare_clip_grad DIR [DIR ...]

Each ``DIR`` holds another copy of the ``imvoxelnet_tpu_torch`` package, for
example a parent commit's (``git archive <commit> imvoxelnet_tpu_torch |
tar -x -C DIR``); it is imported under its own name, so its kernels are
built from its own sources into its own ``kernels/build/``.  Both copies'
``kernels.rect_clip.rect_intersection_area_grad`` run on the same inputs:

* a stress input of 934,400 pairs of the IoU-3D loss's shape with 80% of
  the area gradients nonzero (``chip_smoke.py``'s kind of input);
* the corners and area gradient that reach the kernel in a b=4 bfloat16
  training step of ``imvoxelnet_sunrgbd`` and ``imvoxelnet_sunrgbd_fast``
  (seed 0, the presets' 768x576 synthetic batch);
* each of those with an all-zero area gradient.

Per input and ``DIR`` it prints, as one JSON line, the 32-bit words of the
two gradients that differ from this checkout's, and the device
milliseconds per call (launches queued behind a spin kernel) in the order
other, this, this, other; then the card's name and power limit.  Exits 1
if any word differs.  Needs a CUDA device.
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..configs.presets import get_preset
from ..kernels import rect_clip as clip_kernel
from ..models.detector import build_model
from ..ops import boxes as box_ops
from ..parallel import train as train_lib
from ..utils.synthetic import train_batch

SEED = 0
PRESETS = ('imvoxelnet_sunrgbd', 'imvoxelnet_sunrgbd_fast')
STRESS_PAIRS = 934400
REPS = 200
QUEUE_US = 150


def other_clip(path: str, name: str):
    """``kernels.rect_clip`` of the package copy under ``path``."""
    root = os.path.join(path, 'imvoxelnet_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, '__init__.py'),
        submodule_search_locations=[root])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f'{name}.kernels.rect_clip')


def stress_input(rng, n):
    """Furniture-sized BEV targets, predictions near them, 80% of the area
    gradients nonzero."""
    target = np.concatenate([rng.uniform(-3, 3, (n, 2)),
                             rng.uniform(0.3, 2.5, (n, 2)),
                             rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    pred = target + np.concatenate([0.2 * rng.randn(n, 2),
                                    0.15 * rng.randn(n, 2),
                                    0.3 * rng.randn(n, 1)], -1)
    pred[:, 2:4] = np.abs(pred[:, 2:4]) + 0.05
    c1, c2 = (box_ops.bev_corners_loss(torch.tensor(
        x.astype(np.float32), device='cuda')).contiguous()
        for x in (pred, target))
    g = rng.randn(n).astype(np.float32)
    g[rng.uniform(size=n) < 0.2] = 0.0
    return c1, c2, torch.tensor(g, device='cuda')


def step_input(name):
    """The clip backward's inputs in one b=4 bfloat16 training step."""
    preset = get_preset(name)
    cfg = dataclasses.replace(preset.model, compute_dtype='bfloat16')
    model = build_model(cfg, device='cuda', seed=SEED)
    opt, sched = train_lib.make_optimizer(
        model, preset.lr, preset.weight_decay, preset.backbone_lr_mult,
        preset.grad_clip_norm, steps_per_epoch=1000,
        lr_steps=preset.lr_steps)
    step = train_lib.make_train_step(model, opt, sched)
    batch = train_batch(preset.data, preset.data.samples_per_device, 'cuda',
                        seed=SEED + 1)
    seen = []
    wrapped = clip_kernel.rect_intersection_area_grad

    def probe(c1, c2, grad_areas):
        seen.append((c1.clone(), c2.clone(), grad_areas.clone()))
        return wrapped(c1, c2, grad_areas)
    clip_kernel.rect_intersection_area_grad = probe
    try:
        step(batch)
    finally:
        clip_kernel.rect_intersection_area_grad = wrapped
    torch.cuda.synchronize()
    return seen[0]


def device_ms(fn):
    """Device milliseconds per call, the launches queued behind a spin."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(REPS * QUEUE_US * 2000))      # ~2 cycles a ns
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / REPS


def words_differ(a, b):
    return sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
               for x, y in zip(a, b))


def main(dirs):
    if not torch.cuda.is_available():
        print('compare_clip_grad: no CUDA device', file=sys.stderr)
        return 1
    others = {d: other_clip(d, f'other_port_{i}') for i, d in enumerate(dirs)}
    inputs = {f'stress, {STRESS_PAIRS} pairs, 80% live':
              stress_input(np.random.RandomState(SEED), STRESS_PAIRS)}
    for name in PRESETS:
        inputs[f'{name} b=4 step'] = step_input(name)
    ok = True
    for label, (c1, c2, g) in inputs.items():
        for tag, grad in (('', g), (', all-zero gradient',
                                    torch.zeros_like(g))):
            mine = clip_kernel.rect_intersection_area_grad(c1, c2, grad)
            for d, other in others.items():
                theirs = other.rect_intersection_area_grad(c1, c2, grad)
                torch.cuda.synchronize()
                diff = words_differ(mine, theirs)
                ok = ok and diff == 0
                runs = {'other': lambda: other.rect_intersection_area_grad(
                            c1, c2, grad),
                        'this': lambda: clip_kernel.
                            rect_intersection_area_grad(c1, c2, grad)}
                times = [(k, device_ms(runs[k]))
                         for k in ('other', 'this', 'this', 'other')]
                print(json.dumps(dict(
                    input=label + tag, other=d, pairs=c1.shape[0],
                    live=int((grad != 0).sum()), words_differ=diff,
                    ms_in_turns=times)), flush=True)
    print(subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True,
        text=True).stdout.strip())
    return 0 if ok else 1


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
