"""A configuration is added from new files alone.  In a copy of the
benchmark, a configuration that the default reference rejects (deformable
convs in the backbone's stages 3-4) on a dataset the benchmark has no
scenes of (three views a scene) comes with its own reference module
(``new_config/toy_dcn.py``, whose deformable conv only its own
``init_overrides`` covers), its scenes module (``new_config/
three_views.py``), its configuration file with ``tiny`` sizes, its limits
and its entries in ``BENCHMARK.json``, and no file of the copy is edited.
A serving run of the new cell through ``harness.run`` at the tiny sizes on
the CPU is correct; the check's control and the half-batch fault are
not."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from portbench import spec
from portbench.reference import detector as rd

NEW = os.path.join(spec.HERE, 'tests', 'new_config')
CELL = 'toy-dcn3-serve-b2'
SEED = 2 ** 31 + 33

RUN = f'''
import json
from portbench import calibrate, faults, harness, spec, traffic
from portbench import run as run_cli
from portbench.tests.tiny import tiny_cell

cell = tiny_cell({CELL!r})
limits = cell.limits['numbers']
pool = traffic.make_pool(cell.config, cell.traffic, 1, 'cpu')
sound = harness.run(cell, {SEED}, 0.3, False, 'cpu')
sound_out, _ = run_cli.result_line(cell, sound, False, {{}})
control = calibrate.control_numbers(cell, {SEED}, 'cpu')
with faults.SERVE['half_batch']():
    half = harness.run(cell, {SEED}, 0.3, False, 'cpu')
half_out, _ = run_cli.result_line(cell, half, False, {{}})
print(json.dumps(dict(
    views=pool[0]['images'].shape[1], root=spec.ROOT,
    sound=sound_out['correct'], sound_numbers=sound['numbers'],
    control=all(control[k] <= v['limit'] for k, v in limits.items()),
    control_numbers=control, half_batch=half_out['correct'],
    half_batch_numbers=half['numbers'])))
'''


def _config():
    with open(os.path.join(spec.HERE, 'configs',
                           'imvoxelnet_kitti.json')) as f:
        config = json.load(f)
    config.update(name='toy_dcn3', reference='toy_dcn')
    config['model']['stage_with_dcn'] = [False, False, True, True]
    config['data']['dataset'] = 'three_views'
    config['tiny'] = dict(
        model=dict(backbone_stage_blocks=[1, 1, 1, 1],
                   n_voxels=[32, 40, 12], voxel_size=[0.8, 0.64, 0.32],
                   fpn_out_channels=16,
                   neck=dict(in_channels=16, out_channels=32),
                   anchor_head=dict(
                       anchor_ranges=[[0, -12.8, -1.78, 25.6, 12.8, -1.78]],
                       feat_channels=32, nms_pre=64, max_out=8)),
        data=dict(test_size=[320, 96], train_size=[320, 96], max_gt=8,
                  gt_per_scene=[4, 8]))
    return config


def test_today_rejects_the_new_configuration():
    with pytest.raises(ValueError):
        rd.config_from_dict(_config()['model'])
    with pytest.raises(ModuleNotFoundError):
        spec.scenes('three_views')


def test_new_configuration_from_new_files_alone(tmp_path):
    base = tmp_path / 'portbench'
    shutil.copytree(spec.HERE, base,
                    ignore=shutil.ignore_patterns('__pycache__'))
    before = {p: p.read_bytes() for p in base.rglob('*') if p.is_file()}
    shutil.copy(os.path.join(NEW, 'toy_dcn.py'), base / 'reference')
    shutil.copy(os.path.join(NEW, 'three_views.py'), base / 'scenes')
    (base / 'configs' / 'toy_dcn3.json').write_text(json.dumps(_config()))
    shutil.copy(base / 'limits' / 'kitti-serve-b8.json',
                base / 'limits' / (CELL + '.json'))
    bench = spec.load_benchmark()
    bench['configs'].append(dict(
        name='toy_dcn3', source='https://example.org/toy',
        file='portbench/configs/toy_dcn3.json', reduced=[],
        why='deformable stages 3-4, three views'))
    bench['workloads'].append(dict(
        name=CELL, config='toy_dcn3', traffic='serve_b8', chips=1,
        why='three views a scene through a deformable backbone'))
    for m in bench['end_to_end']:
        if 'workloads' in m and m['name'] in ('scenes_per_s',
                                              'batch_p95_ms'):
            m['workloads'].append(CELL)
    (tmp_path / 'BENCHMARK.json').write_text(json.dumps(bench))
    assert all(p.read_bytes() == data for p, data in before.items())

    env = dict(os.environ, PYTHONPATH=spec.ROOT)
    proc = subprocess.run([sys.executable, '-c', RUN], cwd=tmp_path,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got['root'] == str(tmp_path)
    assert got['views'] == 3
    assert got['sound'], got['sound_numbers']
    assert not got['control'], got['control_numbers']
    assert not got['half_batch'], got['half_batch_numbers']
