"""The frozen FLOP count: the reference counted on the meta device gives
the analytic 2.6889 TF of a KITTI scene."""

from __future__ import annotations

import json
import os

from portbench import flops, spec, traffic
from portbench.reference import detector as rd


def _cfg(name):
    with open(os.path.join(spec.HERE, 'configs', name + '.json')) as f:
        return json.load(f)


def test_analytic_kitti_is_2_6889_tf():
    assert round(flops.analytic_kitti()[2] / 1e12, 4) == 2.6889


def test_counted_kitti_scene_equals_the_analytic_count():
    config = _cfg('imvoxelnet_kitti')
    cfg = rd.config_from_dict(config['model'])
    batch = traffic.make_pool(config, dict(mode='serve', batch=1, pool=1),
                              3, 'cpu')[0]
    counted = flops.counted(cfg, batch, train=False)
    assert round(counted / 1e12, 4) == 2.6889
    assert abs(counted / flops.analytic_kitti()[2] - 1) < 1e-4


def test_training_step_counts_forward_and_backward():
    config = _cfg('imvoxelnet_kitti')
    cfg = rd.config_from_dict(config['model'])
    batch = traffic.make_pool(config, dict(mode='train', batch=1, pool=1),
                              3, 'cpu')[0]
    fwd = flops.counted(cfg, batch, train=False)
    step = flops.counted(cfg, batch, train=True)
    assert 2.0 * fwd < step < 3.0 * fwd
