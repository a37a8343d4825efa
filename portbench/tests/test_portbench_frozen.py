"""The four cells' inputs and counts, frozen: at the published sizes on the
CPU, for one seed, the checksums of the seeded ``state_dict`` and of the
traffic pool, and the FLOP, B1-byte and B3-operation counts that a traced
run reports (``harness.run``), as recorded before the harness found a
configuration's reference and scenes by name.  A change to how the harness
finds them must leave every reading where it was."""

from __future__ import annotations

import hashlib

import numpy as np
import pytest
import torch

from portbench import flops, rooflines, spec, traffic, weights

SEED = 2 ** 31 + 77
FROZEN = {
    'kitti-serve-b8': dict(
        state_sha256='37f6d0268ad8436d1c6726f864291071'
                     'db28adcacd34c25a28b388b3bbe09009',
        pool_sha256='abbcc7b098521f5b13682aae5ad2186e'
                    '0107037d4cec8b26da28a15e6551d98f',
        flops_per_iter=21511069827648.0,
        b1_bytes_per_iter=748496320.0,
        b3_flops_per_iter=2274889826304.0),
    'sunrgbd-serve-b8': dict(
        state_sha256='7ff4a62f2d18126df0f1241944448e2a'
                     '6f1df9d39a2dde1219241caecd242b88',
        pool_sha256='997fe78a1f2dfc0d23199424487288ca'
                    'db42695b838054e219d7bd8a569469c2',
        flops_per_iter=5594401997376.0,
        b1_bytes_per_iter=242790912.0,
        b3_flops_per_iter=0.0),
    'kitti-train-b4': dict(
        state_sha256='ff1e656271a6c4d013828394a657b8fb'
                     '453b38d00f2aebb6e129a1464a6088da',
        pool_sha256='c3ff8728b100dbace7248f822afd744d'
                    '330601deb63ccf8d301c6c4b7d04d774',
        flops_per_iter=32284161966368.0,
        b1_bytes_per_iter=644011456.0,
        b3_flops_per_iter=2274889826304.0),
    'sunrgbd-train-b4': dict(
        state_sha256='445dae49a64df3248d56cf16df846529'
                     'd1314aeac980500f22ae041879ca3761',
        pool_sha256='763a5ebf47aec961bfa39e5855b7fc09'
                    '1787497bfa2a33ed8ee536d9ffc2454f',
        flops_per_iter=8537665831200.0,
        b1_bytes_per_iter=199918256.0,
        b3_flops_per_iter=0.0),
}


def digest(tensors: dict) -> str:
    """sha256 over each tensor's name, dtype, shape and bytes, in order."""
    h = hashlib.sha256()
    for k, v in tensors.items():
        h.update(f'{k}:{v.dtype}:{tuple(v.shape)}'.encode())
        v = v.detach().contiguous().cpu().reshape(-1)
        h.update(v.view(torch.uint8).numpy().tobytes() if v.numel() else b'')
    return h.hexdigest()


@pytest.mark.parametrize('workload', sorted(FROZEN))
def test_cell_readings_are_frozen(workload):
    cell = spec.find_cell(workload, spec.load_benchmark())
    mix = cell.traffic
    serve = mix['mode'] == 'serve'
    ref = spec.reference(cell.config)
    cfg = ref.config_from_dict(cell.config['model'])
    state = weights.make_state_dict(ref, cfg, SEED, 'cpu', serve)
    pool = traffic.make_pool(cell.config, mix, SEED, 'cpu')
    shift = 0 if serve else mix['check_steps']
    batches = [pool[(i + shift) % len(pool)]
               for i in range(mix['trace_iters'])]
    got = dict(
        state_sha256=digest(state),
        pool_sha256=digest({f'{i}.{k}': v for i, b in enumerate(pool)
                            for k, v in b.items()}),
        flops_per_iter=flops.counted(ref, cfg, pool[0], not serve),
        b1_bytes_per_iter=float(np.mean(
            [rooflines.b1_bytes(cfg, b, not serve) for b in batches])),
        b3_flops_per_iter=rooflines.b3_flops(ref, cfg, pool[0], not serve))
    assert got == FROZEN[workload]
