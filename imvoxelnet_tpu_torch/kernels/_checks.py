"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch


def require(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    if not t.is_cuda:
        raise ValueError(f'{name} must be a CUDA tensor, got {t.device}')
    if t.dtype not in dtypes:
        raise TypeError(f'{name} must be one of {dtypes}, got {t.dtype}')
    if t.dim() != ndim:
        raise ValueError(f'{name} must have {ndim} dims, got {tuple(t.shape)}')
    if not t.is_contiguous():
        raise ValueError(f'{name} must be contiguous')


def same_device(*tensors: torch.Tensor) -> None:
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f'tensors on several devices: {devs}')


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
