"""The port's learning loops (``tools/validate_learning.py``) on the CPU:
each family's scene through the dataset's own sample, and two steps of its
loop end to end.  The loops' criteria are asserted on the card
(``chip_smoke.py``), after the scripts' 240 or 300 steps.
"""

import numpy as np
import pytest

from imvoxelnet_tpu_torch.tools import validate_learning as vl

from _torch_port_fixtures import shared_cores  # noqa: F401

pytestmark = pytest.mark.usefixtures('shared_cores')

# white after the pipeline's normalization (mean 123.675..., std 58.395...)
# against the scenes' noise of 0-59
BRIGHT = 1.5


@pytest.mark.parametrize('family', vl.FAMILIES)
def test_scene_puts_the_gt_centre_inside_its_blob(family, tmp_path):
    """The gravity centre of the GT box, projected through the sample's own
    intrinsic and extrinsics, lands on the blob in each view of the sample
    (the resized image the model sees) where it is ahead of the camera and
    inside the frame, and does so in at least one view."""
    _, batch = vl.scene(family, str(tmp_path))
    assert int(batch['gt_mask'].sum()) == 1
    box = batch['gt_boxes'][0, 0].double().numpy()
    centre = box[:3] + [0.0, 0.0, box[5] / 2]
    k = batch['intrinsics'][0].double().numpy()
    h, w = batch['img_shape'][0].tolist()
    # original pixels -> the resized image: img_h / ori_h = 4 / ratio
    scale = 4.0 / float(batch['ratios'][0])
    hits = 0
    for view, ext in enumerate(batch['extrinsics'][0].double().numpy()):
        uvw = k @ (ext[:3, :3] @ centre + ext[:3, 3])
        if uvw[2] <= 0.5:
            continue
        u, v = uvw[0] / uvw[2] * scale, uvw[1] / uvw[2] * scale
        if not (0 <= u < w and 0 <= v < h):
            continue
        pixel = batch['images'][0, view, int(v), int(u)]
        assert (pixel > BRIGHT).all(), (family, view, u, v, pixel)
        hits += 1
    assert hits >= 1


@pytest.mark.parametrize('family', vl.FAMILIES)
def test_two_steps_run_with_finite_losses(family, tmp_path):
    """Two updates and the served result scored by the protocol."""
    out = vl.learn(family, str(tmp_path), device='cpu', steps=2)
    assert out['steps'] == 2 and len(out['losses']) == 2
    for line in out['losses']:
        assert all(np.isfinite(v) for v in line.values()), line
    assert out['losses'][0]['loss'] != out['losses'][1]['loss']
    assert set(out['metrics']) == set(out['held']) == set(
        vl.families()[family].criteria)
    assert out['seconds'] > 0
