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


def conv_flops(cin, cout, out_elems, k=27):
    """2 * MACs of a k-tap conv producing ``out_elems`` spatial outputs."""
    return 2.0 * k * cin * cout * out_elems


def kitti_neck_flops(nx=216, ny=248, nz=12, c=64, cout=256):
    """KittiImVoxelNeck: block0 -> down0 (z/2) -> block1 -> down1 (z/2) ->
    block2 -> out_conv (pad 0)."""
    v0 = nx * ny * nz
    v1 = nx * ny * (nz // 2)
    v2 = nx * ny * (nz // 4)
    v3 = (nx - 2) * (ny - 2) * (nz // 4 - 2)
    return [('block0.conv1', conv_flops(c, c, v0)),
            ('block0.conv2', conv_flops(c, c, v0)),
            ('down0', conv_flops(c, 2 * c, v1)),
            ('block1.conv1', conv_flops(2 * c, 2 * c, v1)),
            ('block1.conv2', conv_flops(2 * c, 2 * c, v1)),
            ('down1', conv_flops(2 * c, 4 * c, v2)),
            ('block2.conv1', conv_flops(4 * c, 4 * c, v2)),
            ('block2.conv2', conv_flops(4 * c, 4 * c, v2)),
            ('out_conv', conv_flops(4 * c, cout, v3))]


def resnet50_flops(h, w):
    """torchvision ResNet-50: 4.09 GMACs at 224x224, scaled by area."""
    return 2.0 * 4.09e9 * (h * w) / (224.0 * 224.0)


def fpn_head_flops(h, w, fpn_out=64, bev_hw=(246, 214), head_cin=256,
                   head_cout=20):
    """FPN laterals and outputs at the 4 backbone scales + the 1x1 BEV
    head."""
    s4 = (h // 4) * (w // 4)
    lat = sum(2.0 * cin * fpn_out * (s4 // 4 ** i)
              for i, cin in enumerate((256, 512, 1024, 2048)))
    out3 = sum(2.0 * 9 * fpn_out * fpn_out * (s4 // 4 ** i)
               for i in range(4))
    head = 2.0 * head_cin * head_cout * bev_hw[0] * bev_hw[1]
    return lat + out3 + head


def analytic_kitti():
    """``(rows, neck total, total)`` FLOPs of one KITTI scene: a frozen copy
    of the port's analytic inventory of the KITTI forward
    (``tools/flops.py``), 2.6889 TF a scene at 1280x384."""
    neck = kitti_neck_flops()
    neck_total = sum(f for _, f in neck)
    bb = resnet50_flops(384, 1280)
    fh = fpn_head_flops(384, 1280)
    rows = neck + [('resnet50@384x1280', bb), ('fpn+head', fh)]
    return rows, neck_total, neck_total + bb + fh


def test_analytic_kitti_is_2_6889_tf():
    assert round(analytic_kitti()[2] / 1e12, 4) == 2.6889


def test_counted_kitti_scene_equals_the_analytic_count():
    config = _cfg('imvoxelnet_kitti')
    cfg = rd.config_from_dict(config['model'])
    batch = traffic.make_pool(config, dict(mode='serve', batch=1, pool=1),
                              3, 'cpu')[0]
    counted = flops.counted(rd, cfg, batch, train=False)
    assert round(counted / 1e12, 4) == 2.6889
    assert abs(counted / analytic_kitti()[2] - 1) < 1e-4


def test_training_step_counts_forward_and_backward():
    config = _cfg('imvoxelnet_kitti')
    cfg = rd.config_from_dict(config['model'])
    batch = traffic.make_pool(config, dict(mode='train', batch=1, pool=1),
                              3, 'cpu')[0]
    fwd = flops.counted(rd, cfg, batch, train=False)
    step = flops.counted(rd, cfg, batch, train=True)
    assert 2.0 * fwd < step < 3.0 * fwd
