"""A thin server: builds the model once, loads weights, answers requests
(reference: detectron2/engine/defaults.py ``DefaultPredictor``).

A request is the batch dict of ``GeneralizedRCNN.inference`` (numpy arrays
or tensors); the answer is its detection dict, on the model's device.
``data.DatasetMapper`` and ``data.detection_utils.build_static_batch`` make
such a batch from a raw image.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from ..modeling import build_model


class Predictor:
    def __init__(self, cfg, state_dict: Mapping[str, torch.Tensor], device="cuda"):
        self.cfg = cfg.clone()
        self.model = build_model(self.cfg, device)
        self.model.load_state_dict(state_dict, strict=True)

    def __call__(self, request: Dict) -> Dict[str, torch.Tensor]:
        return self.model.inference(request)
