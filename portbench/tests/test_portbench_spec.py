"""Every cell and metric of ``BENCHMARK.json`` is found from its files,
and a cell added as data alone is picked up with no edit."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import spec

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')


@pytest.fixture(scope='module')
def bench():
    return spec.load_benchmark()


def test_benchmark_keys_and_names(bench):
    assert set(bench) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert bench['paths'] == ['portbench']
    names = [c['name'] for c in bench['configs']]
    names += [w['name'] for w in bench['workloads']]
    names += [m['name'] for m in bench['end_to_end'] + bench['per_layer']]
    assert all(NAME.match(n) for n in names)
    assert len(names) == len(set(names))
    assert any(m['name'] == 'setup_s' for m in bench['end_to_end'])
    for m in bench['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for w in bench['workloads']:
        assert w['chips'] == 1 and len(w['why']) <= 200


@pytest.mark.parametrize('workload', [
    w['name'] for w in spec.load_benchmark()['workloads']])
def test_every_cell_resolves(bench, workload):
    cell = spec.find_cell(workload, bench)
    assert cell.traffic['mode'] in ('serve', 'train')
    assert cell.config['model']['compute_dtype'] == 'bfloat16'
    e2e = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m['moves'] in e2e
    for m in cell.end_to_end + cell.per_layer:
        assert callable(spec.reader(m['name']))
    assert set(cell.limits['numbers'])
    ref = spec.reference(cell.config)
    for name in ('config_from_dict', 'ImVoxelNet', 'imvoxelnet_predict',
                 'param_label', 'make_optimizer', 'make_train_step'):
        assert callable(getattr(ref, name)), name
    scenes = spec.scenes(cell.config['data']['dataset'])
    assert scenes.VIEWS >= 1
    for name in ('cameras', 'ratio', 'ground_truth'):
        assert callable(getattr(scenes, name)), name


def test_config_files_are_their_configs(bench):
    for c in bench['configs']:
        with open(os.path.join(spec.ROOT, c['file'])) as f:
            cfg = json.load(f)
        assert cfg['name'] == c['name'] and cfg['source'] == c['source']
        assert c['reduced'] == []


def test_extra_cell_is_picked_up_from_data_alone(bench, tmp_path):
    base = tmp_path / 'portbench'
    for sub in ('configs', 'traffic', 'limits', 'metrics'):
        shutil.copytree(os.path.join(spec.HERE, sub), base / sub)
    (base / 'traffic' / 'serve_b2.json').write_text(json.dumps(
        dict(mode='serve', batch=2, pool=2, outstanding=2, warmup=1,
             trace_iters=4, check_iters=1)))
    (base / 'limits' / 'kitti-serve-b2.json').write_text(
        (base / 'limits' / 'kitti-serve-b8.json').read_text())
    (base / 'metrics' / 'extra_ms.serve.py').write_text(
        'def read(ctx):\n    return 1.0\n')
    extra = json.loads(json.dumps(bench))
    extra['workloads'].append(dict(
        name='kitti-serve-b2', config='imvoxelnet_kitti',
        traffic='serve_b2', chips=1, why='b=2'))
    for m in extra['end_to_end']:
        if 'kitti-serve-b8' in m.get('workloads', ()):
            m['workloads'].append('kitti-serve-b2')
    extra['per_layer'].append(dict(
        name='extra_ms.serve', unit='ms', better='lower',
        source='device_trace', layer='detector', moves='scenes_per_s',
        workloads=['kitti-serve-b2']))
    cell = spec.find_cell('kitti-serve-b2', extra, base=str(base))
    assert cell.traffic['batch'] == 2
    assert [m['name'] for m in cell.per_layer] == ['extra_ms.serve']
    assert spec.reader('extra_ms.serve', base=str(base))({}) == 1.0
    assert {m['name'] for m in cell.end_to_end} == {
        'scenes_per_s', 'batch_p95_ms', 'setup_s'}
