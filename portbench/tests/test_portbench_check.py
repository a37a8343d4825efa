"""The check's control and its faults, at tiny sizes on the CPU: a sound
run comes out correct; the control (float8 convolution operands), and
each fault planted under the timed path, come out not correct under the
cells' own limits.  The runs skip the harness's look for a card and drive
the rest of a run (``harness.run`` then ``run.result_line``)."""

from __future__ import annotations

import pytest
import torch

from portbench import calibrate, faults, harness, spec
from portbench import run as run_cli
from portbench.tests.tiny import tiny_cell

SEED = 2 ** 31 + 21
BENCH = spec.load_benchmark()
CELLS = [w['name'] for w in BENCH['workloads']]


def _faults(workload):
    serve = spec.find_cell(workload, BENCH).traffic['mode'] == 'serve'
    return faults.SERVE if serve else faults.TRAIN


def _cell(workload):
    cell = tiny_cell(workload)
    if cell.traffic['mode'] == 'train':
        # the CPU's bfloat16 conv backward gives NaN from the second model
        # of a process; the card's path is checked on the card
        cell.config['model']['compute_dtype'] = 'float32'
    return cell


def _correct(cell, numbers):
    record = dict(numbers=numbers, iterations=1, memory_peak=0)
    out, _ = run_cli.result_line(cell, dict(record, mode='x', batch=1,
                                            setup_s=1.0, window_s=1.0,
                                            latencies=[1.0]), False, {})
    return out['correct']


@pytest.mark.parametrize('workload', CELLS)
def test_sound_run_is_correct(workload):
    cell = _cell(workload)
    record = harness.run(cell, SEED, 0.3, False, 'cpu')
    out, lines = run_cli.result_line(cell, record, False, {})
    assert out['correct'], lines
    assert list(out)[-1] == 'checked'
    assert not harness.forbidden_modules()


@pytest.mark.parametrize('workload', CELLS)
def test_control_is_not_correct(workload):
    cell = _cell(workload)
    numbers = calibrate.control_numbers(cell, SEED, 'cpu')
    numbers.pop('detail', None)
    assert not _correct(cell, numbers), numbers


@pytest.mark.parametrize('workload,fault', [
    (workload, name) for workload in CELLS for name in _faults(workload)])
def test_fault_is_not_correct(workload, fault):
    cell = _cell(workload)
    with _faults(workload)[fault]():
        record = harness.run(cell, SEED, 0.3, False, 'cpu')
    out, lines = run_cli.result_line(cell, record, False, {})
    assert not out['correct'], lines


@pytest.mark.cuda
def test_cell_on_the_card():
    """One short run of the first cell on the card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU')
    cell = spec.find_cell(CELLS[0], BENCH)
    record = harness.run(cell, SEED, 2.0, False, 'cuda')
    out, lines = run_cli.result_line(cell, record, False, {})
    assert out['correct'], lines
