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
