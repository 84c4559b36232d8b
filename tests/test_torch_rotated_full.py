"""``rotated_faster_rcnn_R_50_cfg()`` at full width in the port on the CPU
(R-50's res4 into RRPN and RROIHeads, bf16 as configured, seeded weights):
it serves, trains and scores small images; the card runs it at 800x1344
(``chip_smoke.py`` phase 25)."""

import pytest
import torch

from jtsm_tpu_torch.checkpoint import random_state_dict
from jtsm_tpu_torch.config import rotated_faster_rcnn_R_50_cfg
from jtsm_tpu_torch.data.datasets.synthetic_rotated import register_synthetic_rotated
from jtsm_tpu_torch.engine import test as engine_test
from jtsm_tpu_torch.evaluation import RotatedCOCOEvaluator
from jtsm_tpu_torch.modeling import build_model
from tests.test_torch_rotated_model import rotated_batch


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_full_width_model_serves_trains_and_scores_on_the_cpu():
    """``rotated_faster_rcnn_R_50_cfg()`` as configured (R-50, bf16, 45
    anchors a cell, 6000/1000 and 12000/2000 proposals, two 1024-wide fcs,
    80 classes), seeded weights: a 48x64 request (12 cells, 540 anchors)
    gives 100 finite 5-dim detections, a train step finite losses and
    gradients, and two synthetic rotated scenes score through
    ``engine.test`` with ``RotatedCOCOEvaluator``."""
    cfg = rotated_faster_rcnn_R_50_cfg()
    assert cfg.TPU.COMPUTE_DTYPE == "bfloat16" and cfg.MODEL.ROI_HEADS.NUM_CLASSES == 80
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    assert model.proposal_generator.anchor_generator.num_anchors == [45]
    assert model.roi_heads.box_head.fc1.in_features == 7 * 7 * 1024
    model.load_state_dict(random_state_dict(model, 0))
    batch = rotated_batch(seed=2, hw=(48, 64))
    batch["gt_classes"] = batch["gt_classes"] * 20
    out = model.inference({k: v for k, v in batch.items() if not k.startswith("gt_")})
    assert out["boxes"].shape == (2, 100, 5) and out["boxes"].dtype == torch.float32
    assert all(torch.isfinite(v.float()).all() for v in out.values())
    model.train()
    losses = model(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == ["loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc"]
    assert all(torch.isfinite(v) for v in losses.values())
    sum(losses.values()).backward()
    assert torch.isfinite(model.roi_heads.box_head.fc1.weight.grad).all()
    model.eval()
    name = "torch_rotated_full_width"
    register_synthetic_rotated(name, num=2, seed=3, image_hw=(48, 64), num_classes=80)
    cfg.DATASETS.TEST = (name,)
    cfg.TPU.IMAGE_BUCKETS = [[48, 64]]
    cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 48, 64
    results = engine_test(cfg, model, evaluators=[RotatedCOCOEvaluator(name)])
    assert list(results) == ["bbox"] and len(results["bbox"]) == 12
