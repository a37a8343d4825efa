"""The port's measurement tools, as far as they run without a card."""

import os
import shutil
import sys

import pytest
import torch

import imvoxelnet_tpu_torch
from imvoxelnet_tpu_torch.kernels import rect_clip as clip_kernel
from imvoxelnet_tpu_torch.tools import compare_clip_grad

PACKAGE = os.path.dirname(os.path.abspath(imvoxelnet_tpu_torch.__file__))


def test_compare_clip_grad_loads_another_copy_of_the_port(tmp_path):
    """A copy of the package is imported under its own name: its clip
    wrapper is another module, builds from the copy's sources, and refuses
    CPU tensors as the port's does."""
    shutil.copytree(PACKAGE, tmp_path / 'imvoxelnet_tpu_torch',
                    ignore=shutil.ignore_patterns('build', '__pycache__'))
    name = 'other_port_under_test'
    try:
        other = compare_clip_grad.other_clip(str(tmp_path), name)
        assert other is not clip_kernel
        assert other.__name__ == f'{name}.kernels.rect_clip'
        assert other.build.SRC_DIR == str(
            tmp_path / 'imvoxelnet_tpu_torch' / 'kernels' / 'csrc')
        c = torch.zeros(2, 4, 2)
        with pytest.raises(ValueError, match='CUDA tensor'):
            other.rect_intersection_area_grad(c, c, torch.zeros(2))
    finally:
        for key in [k for k in sys.modules if k.split('.')[0] == name]:
            del sys.modules[key]


def test_dcn_offsets_make_the_dcn_sample_between_pixels_and_off_the_map():
    """``profile_forward.dcn_offsets`` (used by ``chip_smoke.py``): seeded,
    nonzero ``conv_offset`` weights; on an input the offsets are a few
    pixels, fractional, and some taps fall off the map; no-op without a
    DCN."""
    from imvoxelnet_tpu_torch.models.dcn import DeformConv2d
    from imvoxelnet_tpu_torch.models.resnet import ResNet
    from imvoxelnet_tpu_torch.tools.profile_forward import dcn_offsets

    net = ResNet((1, 1, 1, 1), stage_with_dcn=(False, False, True, True))
    plain = ResNet((1, 1, 1, 1))
    before = {k: v.clone() for k, v in plain.state_dict().items()}
    dcn_offsets(plain)
    assert all(torch.equal(v, before[k])
               for k, v in plain.state_dict().items())
    dcn_offsets(net, seed=3)
    again = ResNet((1, 1, 1, 1), stage_with_dcn=(False, False, True, True))
    dcn_offsets(again, seed=3)
    mods = [m for m in net.modules() if isinstance(m, DeformConv2d)]
    assert len(mods) == 2
    for mod, other in zip(mods, (m for m in again.modules()
                                 if isinstance(m, DeformConv2d))):
        assert torch.equal(mod.conv_offset.bias, other.conv_offset.bias)
        x = torch.randn(2, mod.weight.shape[1], 6, 9)
        with torch.no_grad():
            offset, mask = mod.offsets_and_masks(x)
        assert 1.0 < float(offset.abs().max()) < 3.5
        assert float((offset != offset.round()).float().mean()) == 1.0
        ys = torch.arange(offset.shape[1])[:, None, None] * mod.stride
        y = ys - 1 + torch.arange(3).repeat_interleave(3) + offset[..., 0]
        assert bool(((y < 0) | (y > 5)).any())
        assert 0.0 < float(mask.min()) < float(mask.max()) < 1.0
