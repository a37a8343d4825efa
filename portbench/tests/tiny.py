"""Tiny cells for the CPU tests: the benchmark's own configurations with
the grid, images and batch cut so that a run takes seconds on the CPU.  A
configuration file's ``"tiny"`` object gives its toy sizes (``model`` and
``data`` entries, merged into the file's own); a file without one takes
the rules of :func:`tiny_config` by its head."""

from __future__ import annotations

import copy
import json
import os

from portbench import spec

BASE = spec.HERE


def _json(*parts):
    with open(os.path.join(BASE, *parts)) as f:
        return json.load(f)


def _merge(into: dict, values: dict) -> None:
    """``values`` into ``into``, nested objects entry by entry."""
    for key, value in values.items():
        if isinstance(value, dict) and isinstance(into.get(key), dict):
            _merge(into[key], value)
        else:
            into[key] = copy.deepcopy(value)


def tiny_config(name: str) -> dict:
    """``configs/<name>.json`` at toy sizes: a coarse grid over the same
    scene, small images, few candidates."""
    cfg = copy.deepcopy(_json('configs', name + '.json'))
    m, d = cfg['model'], cfg['data']
    if 'tiny' in cfg:
        tiny = cfg.pop('tiny')
        _merge(m, tiny.get('model', {}))
        _merge(d, tiny.get('data', {}))
        return cfg
    m['backbone_stage_blocks'] = [1, 1, 1, 1]
    if m['head_kind'] == 'anchor3d':
        m['n_voxels'], m['voxel_size'] = [32, 40, 12], [0.8, 0.64, 0.32]
        m['fpn_out_channels'] = 16
        m['neck'].update(in_channels=16, out_channels=32)
        m['anchor_head'].update(
            anchor_ranges=[[0, -12.8, -1.78, 25.6, 12.8, -1.78]],
            feat_channels=32, nms_pre=64, max_out=8)
        d.update(test_size=[320, 96], train_size=[320, 96], max_gt=8,
                 gt_per_scene=[4, 8])
    else:
        # the encoder-decoder halves the grid three times: 32x32x16 is
        # the least that keeps its deepest level a volume (at 16x16x8 the
        # random-weight outputs overflow the head's exp)
        m['n_voxels'], m['voxel_size'] = [32, 32, 16], [0.2, 0.2, 0.16]
        m['indoor_head'].update(voxel_size=[0.2, 0.2, 0.16], nms_pre=64,
                                max_out=64)
        d.update(test_size=[320, 240], train_size=[320, 240], max_gt=8,
                 gt_per_scene=[4, 8])
    return cfg


def tiny_cell(workload: str, bench=None) -> spec.Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` at toy sizes: serving
    batches of 2 (training keeps the cell's batch, whose halves the
    half-batch fault needs), a pool of 4, 4 iterations traced."""
    cell = spec.find_cell(workload, bench or spec.load_benchmark())
    cell.config = tiny_config(cell.config['name'])
    batch = 2 if cell.traffic['mode'] == 'serve' else cell.traffic['batch']
    cell.traffic = dict(cell.traffic, batch=batch, pool=4, warmup=1,
                        trace_iters=4)
    return cell
