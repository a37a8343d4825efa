"""The FLOPs of a preset's forward per scene, two ways, and the speed of
light they give on the card.

    python -m imvoxelnet_tpu_torch.tools.flops [PRESET] [--batch-size 8]
        [--no-count] [--device cuda]

Counterpart of the JAX package's ``tools/flops.py``:

1. **Analytic** (``imvoxelnet_kitti`` only): per-layer conv MACs x 2, dense
   (padded taps included, which the tensor cores execute as real MACs),
   the KITTI inventory of ``mmdet3d/models/necks/imvoxelnet.py``
   (KittiImVoxelNeck :94-123), torchvision's ResNet-50 and the FPN at
   384x1280 with a 216x248x12 grid; copied from the JAX tool.
2. **Counted**: ``torch.utils.flop_counter.FlopCounterMode`` over the
   port's forward + decode (``tools/profile_forward.py:make_run``, no
   gradient) on the preset's synthetic batch.  It counts convolutions and
   matmuls DENSE as well, and B3's operator ``torch.ops.imvx.conv3x3x3``
   through the formula ``kernels/conv3x3x3.py`` registers for it, so on
   the 3D neck the count equals the analytic inventory (the JAX tool's XLA
   count is of valid taps and reads ~14% below it).

The speed of light is the card's dense peak over the FLOPs of a scene:
989 TFLOP/s in bfloat16 (the tensor cores) and 67 TFLOP/s in float32, the
published H100 SXM peaks at 700 W; the card's name and power limit are
printed beside them.  The count runs on the card (``--device cpu`` counts
the plain versions on the CPU: the same FLOPs).
"""

from __future__ import annotations

import argparse
import json

from torch.utils.flop_counter import FlopCounterMode

from . import microbench
from .profile_forward import make_run


def conv_flops(cin, cout, out_elems, k=27):
    """2 * MACs for a k-tap conv producing ``out_elems`` spatial outputs."""
    return 2.0 * k * cin * cout * out_elems


def kitti_neck_flops(nx=216, ny=248, nz=12, c=64, cout=256):
    """KittiImVoxelNeck (``necks/imvoxelnet.py:94-123``): block0 -> down0
    (z/2) -> block1 -> down1 (z/2) -> block2 -> out_conv (pad 0)."""
    layers = []
    v0 = nx * ny * nz
    layers += [('block0.conv1', conv_flops(c, c, v0)),
               ('block0.conv2', conv_flops(c, c, v0))]
    v1 = nx * ny * (nz // 2)
    layers += [('down0', conv_flops(c, 2 * c, v1)),
               ('block1.conv1', conv_flops(2 * c, 2 * c, v1)),
               ('block1.conv2', conv_flops(2 * c, 2 * c, v1))]
    v2 = nx * ny * (nz // 4)
    layers += [('down1', conv_flops(2 * c, 4 * c, v2)),
               ('block2.conv1', conv_flops(4 * c, 4 * c, v2)),
               ('block2.conv2', conv_flops(4 * c, 4 * c, v2))]
    v3 = (nx - 2) * (ny - 2) * (nz // 4 - 2)
    layers += [('out_conv', conv_flops(4 * c, cout, v3))]
    return layers


def resnet50_flops(h, w):
    """torchvision ResNet-50 analytic count: 4.09 GMACs at 224x224, conv
    MACs scale with spatial area (all convs are stride-relative)."""
    return 2.0 * 4.09e9 * (h * w) / (224.0 * 224.0)


def fpn_head_flops(h, w, fpn_out=64, bev_hw=(246, 214), head_cin=256,
                   head_cout=20):
    """FPN laterals+outputs at the 4 backbone scales + the 1x1 BEV head."""
    s4 = (h // 4) * (w // 4)
    lat = sum(2.0 * cin * fpn_out * (s4 // 4 ** i)
              for i, cin in enumerate((256, 512, 1024, 2048)))
    out3 = sum(2.0 * 9 * fpn_out * fpn_out * (s4 // 4 ** i)
               for i in range(4))
    head = 2.0 * head_cin * head_cout * bev_hw[0] * bev_hw[1]
    return lat + out3 + head


def analytic_kitti():
    neck = kitti_neck_flops()
    neck_total = sum(f for _, f in neck)
    bb = resnet50_flops(384, 1280)
    fh = fpn_head_flops(384, 1280)
    rows = neck + [('resnet50@384x1280', bb), ('fpn+head', fh)]
    total = neck_total + bb + fh
    return rows, neck_total, total


def count(fn):
    """``(total, {module: flops})`` of one call of ``fn`` under
    ``FlopCounterMode``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    by_module = {name: sum(ops.values())
                 for name, ops in counter.get_flop_counts().items()}
    return counter.get_total_flops(), by_module


def counted(preset, batch_size, device='cuda', dtype='bfloat16'):
    """The counted FLOPs of one scene of the preset's forward + decode, and
    of its 3D neck alone."""
    _, _, run = make_run(preset, False, batch_size, dtype, device=device)
    run()
    total, by_module = count(run)
    neck = next(v for k, v in by_module.items() if k.endswith('neck_3d'))
    return total / batch_size, neck / batch_size


def speed_of_light(flops_per_scene):
    """Scenes/s at each dtype's dense peak."""
    return {str(dt).split('.')[-1]: peak / flops_per_scene
            for dt, peak in microbench.PEAK_FLOPS.items()}


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('preset', nargs='?', default='imvoxelnet_kitti')
    parser.add_argument('--batch-size', type=int, default=None,
                        help='batch of the counted forward (default 8; 1 '
                             'for nuScenes and ScanNet)')
    parser.add_argument('--no-count', action='store_true',
                        help='the analytic inventory only')
    parser.add_argument('--device', default='cuda')
    return parser.parse_args(argv)


def main(argv=None):
    """Print the counts; returns them as a dict."""
    args = parse_args(argv)
    out = dict(preset=args.preset)
    if args.preset == 'imvoxelnet_kitti':
        rows, neck_total, total = analytic_kitti()
        print('analytic per-scene FLOPs (2 x MAC), KITTI 384x1280 / '
              '216x248x12:')
        for name, f in rows:
            print(f'  {name:22s} {f / 1e12:7.4f} TF')
        print(f'  {"neck total":22s} {neck_total / 1e12:7.4f} TF')
        print(f'  {"TOTAL":22s} {total / 1e12:7.4f} TF')
        out.update(analytic_tf=total / 1e12,
                   analytic_neck_tf=neck_total / 1e12,
                   analytic_scenes_per_s=speed_of_light(total))
        for dt, sps in out['analytic_scenes_per_s'].items():
            print(f'conv-bound speed of light at the {dt} peak: '
                  f'{sps:.1f} scenes/s')
    if not args.no_count:
        if args.device == 'cuda':
            microbench.require_cuda('flops')
            out['card'] = microbench.card()
        b = args.batch_size or (1 if any(
            k in args.preset for k in ('nuscenes', 'scannet')) else 8)
        per_scene, neck = counted(args.preset, b, args.device)
        out.update(counted_tf=per_scene / 1e12, counted_neck_tf=neck / 1e12,
                   counted_batch=b,
                   counted_scenes_per_s=speed_of_light(per_scene))
        print(f'{args.preset}: FlopCounterMode (dense, b{b}): '
              f'{per_scene / 1e12:.4f} TF/scene, 3D neck '
              f'{neck / 1e12:.4f} TF')
        if 'analytic_tf' in out:
            print(f'  = {out["counted_tf"] / out["analytic_tf"]:.3f} of the '
                  f'analytic total, the neck '
                  f'{out["counted_neck_tf"] / out["analytic_neck_tf"]:.4f} '
                  f'of its inventory')
        for dt, sps in out['counted_scenes_per_s'].items():
            print(f'speed of light at the {dt} peak: {sps:.1f} scenes/s')
    if 'card' in out:
        print(out['card'])
    print(json.dumps(out))
    return out


if __name__ == '__main__':
    main()
