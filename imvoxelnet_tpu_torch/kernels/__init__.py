"""Hand-written CUDA kernels for Hopper and their Python wrappers.

One wrapper module per source (``backproject``, ``rect_clip``,
``conv3x3x3``).  A wrapper takes CUDA tensors only: it checks device, dtype,
shape and contiguity, launches on PyTorch's current stream, raises if the
launch returned a CUDA error, and adds one to a plain-integer count of its
module (``WRAPPERS`` names the count of each kernel; the clip's paired,
pairwise and NMS-mask entries share one, the clip's backward, its exact-NMS
entry, the rank gather, the NMS scan and the backprojection's backward have
their own).  The plain PyTorch versions live beside the ops that call the
wrappers (``ops/backproject.py``, ``ops/iou.py``, ``ops/nms.py``,
``ops/conv3z.py``); those ops take the plain version only for CPU
tensors.  The gradients of B1, B2 (paired) and
B3 are ``torch.autograd.Function``s in ``ops/backproject.py``,
``ops/iou.py`` and ``ops/conv3z.py`` whose backward launches a kernel too.
The serving entries (B1 and B3 forward, the clip's pairwise, NMS-mask and
exact-NMS entries, the rank gather, the scan) are also registered as
``torch.library`` operators, ``torch.ops.imvx.*``, with the wrappers as
their CUDA implementations and no CPU one: a ``torch.export`` program records each launch as one node, and
importing this package is what a loaded program needs to run them.  An
operator makes its operands contiguous before the wrapper checks them: the
trace drops a ``.contiguous()`` of a tensor that was contiguous there, and
a loaded program's intermediate tensors may carry other strides (a b=1
float32 KITTI program's conv input did on the card).
"""

from __future__ import annotations

from . import backproject, conv3x3x3, rect_clip

# kernel -> (wrapper module, name of its launch count there)
WRAPPERS = {'backproject': (backproject, 'launches'),
            'backproject_grad': (backproject, 'grad_launches'),
            'rect_clip': (rect_clip, 'launches'),
            'rect_clip_grad': (rect_clip, 'grad_launches'),
            'nms_over': (rect_clip, 'over_launches'),
            'nms_rank': (rect_clip, 'rank_launches'),
            'nms_scan': (rect_clip, 'scan_launches'),
            'conv3x3x3': (conv3x3x3, 'launches')}


def launch_counts() -> dict:
    return {name: getattr(mod, attr) for name, (mod, attr) in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for mod, attr in WRAPPERS.values():
        setattr(mod, attr, 0)
