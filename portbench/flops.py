"""The FLOPs of a batch or a training step, from the cell's shapes alone.

``counted`` runs the reference (``portbench/reference``) on the meta
device under ``torch.utils.flop_counter.FlopCounterMode``: convolutions and
matmuls, counted dense (padded taps included, which the tensor cores
execute as real multiply-adds), as the port's ``tools/flops.py`` counts.
No kernel and no value enters the count, so a change to how the program
computes a layer cannot change it.  A training step counts the forward
and the backward that the step's trainable parameters ask for: the loss
is replaced by the sum of the head outputs, whose backward reaches every
convolution the real loss reaches (the loss's own arithmetic holds no
convolution or matmul).

``analytic_kitti`` is a frozen copy of the port's analytic inventory of
the KITTI forward (``tools/flops.py``): 2.6889 TF a scene at 1280x384.
"""

from __future__ import annotations

import torch
from torch.fx.experimental import _config as fx_config
from torch.utils.flop_counter import FlopCounterMode

from .reference import detector as rd
from .reference import train as rt


def _meta(batch):
    return {k: torch.empty_like(v, device='meta') for k, v in batch.items()}


def counted(cfg, batch, train: bool) -> float:
    """FLOPs of one forward (``train``: forward and backward) of the
    reference model of ``cfg`` on a batch of ``batch``'s shapes."""
    with torch.device('meta'):
        model = rd.ImVoxelNet(cfg)
    for name, p in model.named_parameters():
        p.requires_grad_(train and rt.param_label(name) != 'frozen')
    model.train(train)
    # the backprojection's backward selects the seen rows with a mask: on
    # the meta device every row counts as seen, which moves no FLOP (its
    # index_add_ is no convolution or matmul)
    with FlopCounterMode(display=False) as counter, fx_config.patch(
            meta_nonzero_assume_all_nonzero=True):
        with torch.set_grad_enabled(train):
            head_outs, _ = model(_meta(batch))
            if train:
                leaves = [t for out in head_outs for t in
                          (out if isinstance(out, (list, tuple)) else [out])]
                sum(t.sum() for t in leaves).backward()
    return float(counter.get_total_flops())


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
    """``(rows, neck total, total)`` FLOPs of one KITTI scene."""
    neck = kitti_neck_flops()
    neck_total = sum(f for _, f in neck)
    bb = resnet50_flops(384, 1280)
    fh = fpn_head_flops(384, 1280)
    rows = neck + [('resnet50@384x1280', bb), ('fpn+head', fh)]
    return rows, neck_total, neck_total + bb + fh
