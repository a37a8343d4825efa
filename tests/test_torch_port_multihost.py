"""2-process data parallelism of the port on the CPU, through its tool.

Runs ``imvoxelnet_tpu_torch.tools.validate_multihost`` as
``tests/test_multihost.py`` runs the JAX package's
``tools/validate_multihost.py``: two OS processes in a gloo group
(torchrun's environment on a free port) each run one ``tiny_kitti_test``
step on their half of a global batch of 4, and the losses, gradients, BN
statistics and updated weights must match one process on the same global
batch (losses 1e-6 relative, the rest 1e-5 of each tensor's max-abs).  The
backbone is cut to one block a stage to keep the test short; every worker
has 120 s.
"""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_two_process_train_step_matches_one_process():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    env['OMP_NUM_THREADS'] = '1'
    proc = subprocess.run(
        [sys.executable, '-m', 'imvoxelnet_tpu_torch.tools.validate_multihost',
         '--device', 'cpu', '--timeout', '120',
         '--override', 'model.backbone_stage_blocks=(1, 1, 1, 1)'],
        capture_output=True, text=True, timeout=180, cwd=REPO, env=env)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    verdict = json.loads(proc.stdout.strip().splitlines()[-1])
    assert verdict['ok'] is True and verdict['world'] == 2
    assert verdict['dloss_rel'] <= 1e-6
    assert verdict['dgrads_max'] <= 1e-5 and verdict['dbuffers_max'] <= 1e-5
    assert verdict['dparams_max'] <= 1e-5
    assert verdict['ranks_equal']
    assert verdict['loss_1proc'] > 0
