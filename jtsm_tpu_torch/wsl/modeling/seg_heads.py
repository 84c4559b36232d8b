"""The two-class stuff head of the JTSM VOC configs (reference:
projects/WSL/wsl/modeling/seg_heads.py:232; JAX package
``wsl/modeling/seg_heads.py:166`` ``TwoClassHead``)."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn


class TwoClassHead(nn.Module):
    """Constant logits, no parameters and no loss: channel 1 is 1 and
    channel 0 is 0 at every cell of the first input map, so everything that
    is not a thing is background."""

    num_classes = 2
    has_loss = False

    def forward(self, features: Dict[str, torch.Tensor]) -> torch.Tensor:
        f = next(iter(features.values()))
        b, _, h, w = f.shape
        logits = torch.zeros((b, 2, h, w), dtype=torch.float32, device=f.device)
        logits[:, 1] = 1.0
        return logits
