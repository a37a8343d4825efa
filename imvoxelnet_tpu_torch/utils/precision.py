"""The port's one rule for float32: float32 means full float32, TF32 off.

On an NVIDIA card PyTorch runs float32 convolutions through cuDNN in TF32
(a 10-bit mantissa) unless told otherwise, while the JAX package's float32
path, which every parity test holds the port to, is full float32.  The
entry points (``parallel/train.py``'s step, ``tools/profile_forward.py``,
``chip_smoke.py``) run their work inside :func:`compute_precision` with the
model's ``compute_dtype``; library modules (``models/``, ``ops/``) flip no
global flag.

Only the ``allow_tf32`` flags are used: recent PyTorch raises when they are
mixed with the newer ``fp32_precision`` settings.
"""

from __future__ import annotations

import contextlib

import torch


def tf32_flags() -> tuple:
    """``(cudnn.allow_tf32, cuda.matmul.allow_tf32)`` as they stand."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set_tf32(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


@contextlib.contextmanager
def compute_precision(compute_dtype: str):
    """Run the block at the precision ``compute_dtype`` names.

    ``'float32'`` turns TF32 off for cuDNN convolutions and for matmuls and
    restores the caller's flags on exit; any other dtype (``'bfloat16'``,
    whose convs TF32 does not touch, or ``'float64'``) leaves them alone.
    """
    if compute_dtype != 'float32':
        yield
        return
    saved = tf32_flags()
    _set_tf32(False, False)
    try:
        yield
    finally:
        _set_tf32(*saved)
