"""Hand-written CUDA kernels for Hopper and their Python wrappers.

One wrapper per kernel (``backproject``, ``rect_clip``, ``conv3x3x3``).  A
wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, launches on PyTorch's current stream, raises if the launch
returned a CUDA error, and adds one to its plain-integer ``launches`` count.
The plain PyTorch versions live beside the ops that call the wrappers
(``ops/backproject.py``, ``ops/iou.py``, ``ops/conv3z.py``); those ops take
the plain version only for CPU tensors.
"""

from __future__ import annotations

from . import backproject, conv3x3x3, rect_clip

WRAPPERS = {'backproject': backproject, 'rect_clip': rect_clip,
            'conv3x3x3': conv3x3x3}


def launch_counts() -> dict:
    return {name: mod.launches for name, mod in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod in WRAPPERS.values():
        mod.launches = 0
