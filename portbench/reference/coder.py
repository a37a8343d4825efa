"""Delta XYZWLHR box coder.

Counterpart of ``imvoxelnet_tpu/core/coder.py`` (``encode``, ``decode``):
offsets normalised by the BEV diagonal, log sizes, additive yaw, z
referenced to the anchor's gravity center.
"""

from __future__ import annotations

import torch


def encode(anchors, boxes):
    xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
    xg, yg, zg, wg, lg, hg, rg = boxes[..., :7].unbind(-1)
    za = za + ha / 2
    zg = zg + hg / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    out = torch.stack([(xg - xa) / diag, (yg - ya) / diag, (zg - za) / ha,
                       torch.log(wg / wa), torch.log(lg / la),
                       torch.log(hg / ha), rg - ra], dim=-1)
    if anchors.shape[-1] > 7:
        out = torch.cat([out, boxes[..., 7:] - anchors[..., 7:]], dim=-1)
    return out


def decode(anchors, deltas):
    xa, ya, za, wa, la, ha, ra = anchors[..., :7].unbind(-1)
    xt, yt, zt, wt, lt, ht, rt = deltas[..., :7].unbind(-1)
    za = za + ha / 2
    diag = torch.sqrt(la ** 2 + wa ** 2)
    xg = xt * diag + xa
    yg = yt * diag + ya
    zg = zt * ha + za
    wg = torch.exp(wt) * wa
    lg = torch.exp(lt) * la
    hg = torch.exp(ht) * ha
    rg = rt + ra
    zg = zg - hg / 2
    out = torch.stack([xg, yg, zg, wg, lg, hg, rg], dim=-1)
    if anchors.shape[-1] > 7:
        out = torch.cat([out, deltas[..., 7:] + anchors[..., 7:]], dim=-1)
    return out
