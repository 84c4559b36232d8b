"""WSL mask head (reference: projects/WSL/wsl/modeling/roi_heads/
mask_head.py:267; JAX package ``wsl/modeling/mask_head_wsl.py:29``
``MaskRCNNConvUpsampleWSLHead``): the Mask R-CNN conv-upsample head that
returns its float32 logits and the features before its predictor. The
JTSM heads train it (``roi_heads_jtsm.JTSMROIHeads.mask_losses``)."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ...modeling.roi_heads.mask_head import MaskRCNNConvUpsampleHead


class MaskRCNNConvUpsampleWSLHead(MaskRCNNConvUpsampleHead):
    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = x.permute(0, 3, 1, 2)  # channels-last NCHW view
        for conv in self.conv_norm_relus:
            x = conv(x)
        feats = F.relu(self.deconv(x))
        return self.predictor(feats).float(), feats
