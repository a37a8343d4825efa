"""Anchor-target assignment config (the assignment itself comes with the
training slice).

Counterpart of ``imvoxelnet_tpu/core/target_assign.py``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AssignerConfig:
    pos_iou_thr: float = 0.6
    neg_iou_thr: float = 0.45
    min_pos_iou: float = 0.45
