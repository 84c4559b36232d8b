"""The RPN of weakly supervised detection (reference:
projects/WSL/wsl/modeling/proposal_generator/rpn.py:102 ``RPNWSL``; JAX
package ``wsl/modeling/rpn_wsl.py:33-89``): the core RPN (``rpn``) over
MODEL.RPN.IN_FEATURES, where under MODEL.MRRP each map's branches, folded
into its batch by the backbone, become levels of their own
(``plain5/mrrp0``, ``plain5/mrrp1``, ...) that share the anchors' sizes by
level and the ground truth. UWSOD trains it on the boxes its heads mine
(``defer_losses``, then ``get_losses``)."""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ...layers import ShapeSpec
from ...modeling.proposal_generator.rpn import RPN


class RPNWSL(nn.Module):
    def __init__(self, cfg, input_shape: Dict[str, ShapeSpec]):
        super().__init__()
        base = tuple(cfg.MODEL.RPN.IN_FEATURES)
        missing = [f for f in base if f not in input_shape]
        if missing:
            raise ValueError(f"MODEL.RPN.IN_FEATURES {list(base)} names {missing}, which the backbone "
                             f"{cfg.MODEL.BACKBONE.NAME} does not output (its outputs: {sorted(input_shape)})")
        self.base_in_features = base
        self.num_branch = cfg.MODEL.MRRP.NUM_BRANCH if cfg.MODEL.MRRP.MRRP_ON else 1
        if self.num_branch > 1:
            shapes = {f"{f}/mrrp{i}": input_shape[f] for f in base for i in range(self.num_branch)}
            sub = cfg.clone()
            sub.defrost()
            sub.MODEL.RPN.IN_FEATURES = list(shapes)
            self.rpn = RPN(sub, shapes)
        else:
            self.rpn = RPN(cfg, input_shape)

    def forward(self, image_sizes: torch.Tensor, features: Dict[str, torch.Tensor],
                gt_boxes: Optional[torch.Tensor] = None, gt_valid: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None, defer_losses: bool = False):
        """``RPN.forward`` over the maps with their branches as levels."""
        if self.num_branch > 1:
            b = image_sizes.shape[0]
            levels = {}
            for f in self.base_in_features:
                x = features[f]
                chunks = x.chunk(self.num_branch if x.shape[0] > b else 1)
                for i in range(self.num_branch):
                    levels[f"{f}/mrrp{i}"] = chunks[i] if i < len(chunks) else chunks[0]
            features = levels
        return self.rpn(image_sizes, features, gt_boxes, gt_valid, generator, defer_losses)

    def get_losses(self, deferred, gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        return self.rpn.get_losses(deferred, gt_boxes, gt_valid, generator)
