"""The export tool's multi-device programs on the CPU (``tools/export.py``,
``utils/export.py``): a ``--platforms cpu`` archive round-trips; 2-rank
``--view-sharded`` (shallow ``tiny_kitti_test`` with two views a scene,
one a rank, the views' sums pooled by a traced all-reduce) and
``--data-sharded`` (a global b=2) programs equal the unsharded eager
forward on the whole batch, as each tool's ``--verify`` holds them (rank 0
gathers the ranks' outputs); an archive's program per platform; the flags
that exclude each other.  The unsharded eager forward is held to the JAX
package by ``test_torch_port_export.py`` and the slice tests.

The two ranks (``tests/_torch_port_export_worker.py``, gloo, a free port
a run) run both sharded exports one after the other, started once for the
module with a 240 s limit; the platform archive is exported here
meanwhile.
"""

import json
import os
import sys

import pytest
import torch

from imvoxelnet_tpu_torch.parallel import mesh
from imvoxelnet_tpu_torch.tools import export as export_tool
from imvoxelnet_tpu_torch.utils import export as export_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, 'tests', '_torch_port_export_worker.py')
TIMEOUT = 240
# shallow tiny KITTI with 16 NMS candidates (test_torch_port_export.py's)
# and the axis-aligned NMS: a CPU program unrolls the rotated clip's plain
# version (two thirds of an export's time here), which
# test_torch_port_export.py runs
KITTI = ['tiny_kitti_test'] + [a for o in (
    'model.backbone_stage_blocks=(1,1,1,1)', 'model.anchor_head.nms_pre=16',
    'model.anchor_head.use_rotate_nms=False') for a in ('--override', o)]
# the view-sharded run: two views a scene, one a rank; the data-sharded
# run: a global batch of two, one sample a rank
RUNS = {'view': KITTI + ['--override', 'data.n_images_test=2',
                         '--view-sharded'],
        'data': KITTI + ['--data-sharded', '--batch-size', '2']}


@pytest.fixture(scope='module')
def ranks(tmp_path_factory):
    """The sharded tool runs, started: two rank processes that run both,
    one after the other (``tests/_torch_port_export_worker.py``), and each
    run's path."""
    out = tmp_path_factory.mktemp('sharded')
    paths = {name: str(out / f'{name}.pt2') for name in RUNS}
    runs = [argv + ['--out', paths[name], '--device', 'cpu', '--verify']
            for name, argv in RUNS.items()]
    ports = ','.join(str(p) for p in mesh.free_ports(len(runs)))
    procs = mesh.start_ranks([sys.executable, WORKER, ports,
                              json.dumps(runs)], 2, cwd=REPO,
                             OMP_NUM_THREADS='1')
    yield paths, procs
    for proc in procs:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope='module')
def sharded(ranks):
    """Each sharded run's path and rank 0's JSON line, once the ranks are
    done."""
    paths, procs = ranks
    outs = mesh.wait_ranks(procs, TIMEOUT)
    lines = [json.loads(x) for x in outs[0].splitlines()
             if x.startswith('{')]
    assert not any(x.startswith('{') for x in outs[1].splitlines())
    return {name: (paths[name], line) for name, line in zip(RUNS, lines)}


def _imvx_free(launches):
    return all(v == 0 for v in launches.values())


def test_platform_archive_round_trips(tmp_path, ranks):
    """``--platforms cpu``: one archive, one program keyed ``cpu`` (the
    kernels' plain versions, no launch), verified against the eager
    forward on the CPU (while the sharded runs' ranks work)."""
    path = str(tmp_path / 'platforms.pt2')
    summary = export_tool.main(KITTI + ['--out', path, '--platforms', 'cpu',
                                        '--verify', '--device', 'cpu'])
    assert summary['verified'] and summary['platforms'] == ['cpu']
    assert _imvx_free(summary['per_platform']['cpu']['launches'])
    assert summary['per_platform']['cpu']['program_gap'] <= 1e-5
    assert export_lib.load_meta(path) == dict(devices=1, sharding=None,
                                              platforms=['cpu'])


def test_load_exported_picks_the_platform(tmp_path):
    """A single program is keyed by the platform it was traced on; an
    archive gives the current device's program (the CPU here) or the one
    asked for, and raises for a platform it lacks; an archive that
    ``save_exported`` did not write has no record to read."""
    class Scale(torch.nn.Module):
        def __init__(self, k):
            super().__init__()
            self.k = k

        def forward(self, x):
            return {'y': x * self.k}

    x = torch.ones(3)
    programs = {name: torch.export.export(Scale(k), (x,))
                for name, k in (('cpu', 2.0), ('cuda', 3.0))}
    both, one = str(tmp_path / 'both.pt2'), str(tmp_path / 'one.pt2')
    export_lib.save_exported(programs, both, devices=1)
    export_lib.save_exported(programs['cuda'], one)
    assert export_lib.load_meta(both)['platforms'] == ['cpu', 'cuda']
    assert export_lib.load_meta(one)['platforms'] == ['cpu']
    for path, platform, k in ((both, None, 2.0), (both, 'cuda', 3.0),
                              (one, None, 3.0)):
        got = export_lib.load_exported(path, platform).module()(x)['y']
        assert torch.equal(got, x * k)
    export_lib.save_exported({'cuda': programs['cuda']}, both)
    with pytest.raises(KeyError, match="no program for 'cpu'"):
        export_lib.load_exported(both)
    with pytest.raises(KeyError, match="no program for 'cuda'"):
        export_lib.load_exported(one, 'cuda')
    plain = str(tmp_path / 'plain.pt2')
    torch.export.save(programs['cpu'], plain)
    with pytest.raises(ValueError, match='not an archive of save_exported'):
        export_lib.load_meta(plain)


@pytest.mark.parametrize('sharding', ['view', 'data'])
def test_sharded_program_equals_the_unsharded_forward(sharding, sharded):
    """Each rank's program equals the eager sharded forward on its share,
    and the ranks' outputs, gathered, equal the unsharded eager forward
    (``--verify``); the view-sharded program takes 1 of the 2 views and
    pools (sum, count) with the default group's all-reduce, the
    data-sharded one takes 1 of the 2 samples and holds no collective."""
    path, line = sharded[sharding]
    assert line['verified'] and line['sharding'] == sharding
    assert line['devices'] == 2
    assert line['decode_differs'] is None and line['error'] is None
    assert len(line['program_gaps']) == 2
    assert max(line['program_gaps']) <= 1e-5
    assert line['head_outputs_gap'] < 1e-5
    assert len(line['launches']) == 2
    assert all(_imvx_free(c) for c in line['launches'])
    assert line['collectives'] == (2 if sharding == 'view' else 0)
    assert line['inputs']['images'][:2] == [1, 1]
    assert export_lib.load_meta(path) == dict(devices=2, sharding=sharding,
                                              platforms=['cpu'])


@pytest.mark.parametrize('flags', [
    ['--view-sharded', '--data-sharded'], ['--view-sharded', '--poly-batch'],
    ['--data-sharded', '--platforms', 'cpu']])
def test_sharded_flags_exclude_each_other(flags, capsys):
    with pytest.raises(SystemExit):
        export_tool.main(KITTI + ['--out', 'unused.pt2', '--device', 'cpu',
                                  *flags])
    err = capsys.readouterr().err
    assert 'mutually exclusive' in err or '--device alone' in err


def test_a_near_tie_keeps_counts_labels_and_scores():
    """Where a sharded decode breaks a near tie otherwise, the boxes of the
    tie may differ, the detection counts, labels and scores (sorted) may
    not."""
    want = dict(boxes=torch.zeros(1, 4, 7), scores=torch.tensor(
        [[0.9, 0.5, 0.5, 0.0]]), labels=torch.tensor([[1, 2, 3, 0]]),
        valid=torch.tensor([[True, True, True, False]]))
    tie = dict(want, boxes=torch.ones(1, 4, 7),
               scores=torch.tensor([[0.9, 0.5 + 1e-7, 0.5, 0.0]]),
               labels=torch.tensor([[1, 3, 2, 0]]))
    assert export_tool.same_detections(tie, want) is None
    fewer = dict(tie, valid=torch.tensor([[True, True, False, False]]))
    assert '2 detections, not 3' in export_tool.same_detections(fewer, want)
    other = dict(tie, labels=torch.tensor([[1, 3, 3, 0]]))
    assert 'labels' in export_tool.same_detections(other, want)
    lower = dict(tie, scores=torch.tensor([[0.9, 0.4, 0.5, 0.0]]))
    assert 'scores' in export_tool.same_detections(lower, want)
