"""The reference agrees with the port's plain path on the CPU at tiny
sizes, in float32: the test, not the reference, imports both."""

from __future__ import annotations

import dataclasses

import pytest
import torch

from imvoxelnet_tpu_torch.configs.presets import get_preset
from imvoxelnet_tpu_torch.models import detector as port_detector
from portbench import check, program, traffic, weights
from portbench.reference import detector as rd
from portbench.tests.tiny import tiny_cell


def _float32(cell):
    cell.config['model']['compute_dtype'] = 'float32'
    return cell


def test_tiny_kitti_test_preset_forward_and_decode():
    """The port's own ``tiny_kitti_test`` preset, its plain path."""
    preset = get_preset('tiny_kitti_test')
    cfg = rd.config_from_dict(dataclasses.asdict(preset.model))
    state = weights.make_state_dict(rd, cfg, 11, 'cpu', True)
    config = dict(preset='tiny_kitti_test',
                  model=dataclasses.asdict(preset.model))
    port = program.build_model(config, state, 'cpu')
    ref = check.reference_model(rd, cfg, state, 'cpu').eval()
    batch = traffic.make_pool(
        dict(data=dict(dataset='kitti', test_size=list(preset.data.test_size),
                       train_size=list(preset.data.train_size))),
        dict(mode='serve', batch=2, pool=1), 11, 'cpu')[0]
    with torch.no_grad():
        p_outs, p_valid = port(batch)
        r_outs, r_valid = ref(batch)
        assert p_valid.any() and torch.equal(p_valid, r_valid)
        for p, r in zip(p_outs, r_outs):
            torch.testing.assert_close(p, r, rtol=1e-5, atol=1e-6)
        p_dets = port_detector.imvoxelnet_predict(port.cfg, p_outs)
        r_dets = rd.imvoxelnet_predict(cfg, r_outs)
    assert p_dets['valid'].any()
    for key in p_dets:
        torch.testing.assert_close(p_dets[key], r_dets[key])


@pytest.mark.parametrize('workload', ['kitti-serve-b8', 'sunrgbd-serve-b8'])
def test_serving_cells_agree_in_float32(workload):
    cell = _float32(tiny_cell(workload))
    cfg = rd.config_from_dict(cell.config['model'])
    state = weights.make_state_dict(rd, cfg, 12, 'cpu', True)
    pool = traffic.make_pool(cell.config, cell.traffic, 12, 'cpu')
    port = program.build_model(cell.config, state, 'cpu')
    dets, head_outs, valid = program.serve_call(port)(pool[0])
    kept = [dict(batch=pool[0], head_outs=head_outs, valid=valid,
                 dets={k: v.clone() for k, v in dets.items()})]
    numbers = check.serve_numbers(
        rd, cfg, check.reference_model(rd, cfg, state, 'cpu'),
        check.reference_model(rd, cfg, state, 'cpu', 'bfloat16'), kept)
    assert int(dets['valid'].sum()) > 0
    assert numbers['head_gap'] < 1e-5
    assert numbers['valid_mismatch'] == 0
    assert numbers['decode_mismatch'] == 0


def test_training_steps_agree_in_float32():
    cell = _float32(tiny_cell('kitti-train-b4'))
    cfg = rd.config_from_dict(cell.config['model'])
    state = weights.make_state_dict(rd, cfg, 13, 'cpu', False)
    pool = traffic.make_pool(cell.config, cell.traffic, 13, 'cpu')
    port = program.build_model(cell.config, state, 'cpu')
    step, optimizer = program.train_step(port, cell.config)
    names = {p: n for n, p in port.named_parameters()}
    losses = []
    for i in range(3):
        losses.append({k: float(v) for k, v in step(pool[i]).items()})
        if i == 0:
            grads = check.norms(check.first_gradients(optimizer, names))
    got = dict(losses=losses, grads=grads, changes=check.change_norms(
        check.moving(state), check.moving(port.state_dict())))
    want = check.reference_steps(rd, cfg, cell.config, state, pool[:3],
                                 'cpu')
    numbers = check.train_numbers(got, want)
    assert numbers['loss_gap'] < 1e-4
    assert numbers['grad_gap'] < 1e-3
    assert numbers['change_gap'] < 1e-3
