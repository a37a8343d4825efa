"""Fold the backbone's frozen batch norms into its conv weights in a
checkpoint.

    python -m imvoxelnet_tpu_torch.tools.fuse_conv_bn IN.pth OUT.pth

Counterpart of the JAX package's ``tools/fuse_conv_bn.py``, on ``.pth``
files: the port's train state (``tools/train.py``'s ``latest.pth``) or a
reference mmdet checkpoint (``{'state_dict': ...}`` or a bare state
dict); the rest of the file is kept as it is.  The fold is
``utils/fuse.py:fuse_backbone``; the folded weights load into the same
model (the same keys) and compute the same function up to rounding.
"""

from __future__ import annotations

import argparse

import torch

from ..utils.fuse import fuse_backbone


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('in_ckpt')
    parser.add_argument('out_ckpt')
    args = parser.parse_args(argv)
    payload = torch.load(args.in_ckpt, map_location='cpu', weights_only=True)
    if isinstance(payload, dict) and 'state_dict' in payload:
        payload['state_dict'] = fuse_backbone(payload['state_dict'])
    else:
        payload = fuse_backbone(payload)
    torch.save(payload, args.out_ckpt)
    print(f'fused -> {args.out_ckpt}')
    return args.out_ckpt


if __name__ == '__main__':
    main()
