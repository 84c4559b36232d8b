"""The GIoU box losses and ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES in the port held
against the JAX package on the CPU.

* ``giou_loss`` per box and in its gradient on overlapping, disjoint,
  touching, nested, identical, degenerate (zero width or height) and empty
  pairs: within 1e-6 relative, the gradient at ties included (both sides
  split it between the two arguments of a maximum).
* The tiny FPN Mask R-CNN (``_fpn_tiny``) with MODEL.RPN and
  ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE giou (the yaml's weights: 2 for the RPN,
  10 for the box head, which the JAX package does not apply), and with
  TRAIN_ON_PRED_BOXES, in the parity regime of
  ``tests/test_torch_syncbn_train.py``: the losses within 1e-5 relative and
  every gradient within 5e-5 of its largest magnitude.
* Under TRAIN_ON_PRED_BOXES the mask pooler reads the boxes that the box
  head's deltas of each slot's class decode to, and the mask loss sends no
  gradient into the box predictor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.ops.losses import giou_loss as jax_giou_loss
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.layers import batch_statistics
from jtsm_tpu_torch.modeling import poolers
from jtsm_tpu_torch.ops.losses import giou_loss
from tests.modeling.test_meta_archs import _batch, _fpn_tiny
from tests.test_torch_syncbn_train import _rel, jax_train_run, port_model

TOL_PIECE = 1e-6
TOL_LOSS = 1e-5
TOL_GRAD = 5e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _box_pairs():
    """(pred, target) rows: random overlapping pairs, then the cases."""
    rng = np.random.RandomState(0)
    xy = rng.uniform(0, 50, (64, 2))
    pred = np.concatenate([xy, xy + rng.uniform(1, 40, (64, 2))], 1)
    txy = xy + rng.uniform(-10, 10, (64, 2))
    target = np.concatenate([txy, txy + rng.uniform(1, 40, (64, 2))], 1)
    cases = [
        ([0, 0, 10, 10], [20, 20, 30, 30]),  # disjoint
        ([0, 0, 10, 10], [10, 0, 20, 10]),  # touching along a side
        ([0, 0, 10, 10], [10, 10, 20, 20]),  # touching at a corner
        ([0, 0, 10, 10], [2, 2, 5, 5]),  # nested
        ([3, 4, 9, 12], [3, 4, 9, 12]),  # identical
        ([5, 5, 5, 15], [0, 0, 10, 10]),  # zero width
        ([5, 5, 15, 5], [0, 0, 10, 10]),  # zero height
        ([0, 0, 10, 10], [4, 4, 4, 4]),  # an empty target
        ([4, 4, 4, 4], [4, 4, 4, 4]),  # both empty, one point
        ([7, 7, 3, 3], [0, 0, 10, 10]),  # inverted
    ]
    pred = np.concatenate([pred, [c[0] for c in cases]]).astype(np.float32)
    target = np.concatenate([target, [c[1] for c in cases]]).astype(np.float32)
    return pred, target


def test_giou_loss_matches_jax():
    pred, target = _box_pairs()
    want = np.asarray(jax_giou_loss(jnp.asarray(pred), jnp.asarray(target)))
    wts = np.random.RandomState(1).uniform(0.5, 2, len(pred)).astype(np.float32)
    gp, gt = jax.grad(lambda p, t: jnp.sum(jax_giou_loss(p, t) * wts), argnums=(0, 1))(
        jnp.asarray(pred), jnp.asarray(target))
    p, t = torch.from_numpy(pred).requires_grad_(), torch.from_numpy(target).requires_grad_()
    got = giou_loss(p, t)
    (got * torch.from_numpy(wts)).sum().backward()
    assert np.isfinite(want).all() and np.isfinite(got.detach().numpy()).all()
    assert _rel(want, got.detach().numpy()) <= TOL_PIECE
    assert _rel(np.asarray(gp), p.grad.numpy()) <= TOL_PIECE
    assert _rel(np.asarray(gt), t.grad.numpy()) <= TOL_PIECE
    # the cases: 1 - IoU + the enclosing box's share outside the union
    g = got.detach().numpy()[64:]
    for i, v in ((0, 1 + 700 / 900), (1, 1.0), (2, 1.5), (3, 1 - 9 / 100), (4, 0.0)):
        assert abs(g[i] - v) < 1e-6, (i, g[i], v)


def tiny_cfg(loss="smooth_l1", pred_boxes=False, jax_side=True):
    cfg = _fpn_tiny(jax_get_cfg())
    m = cfg.MODEL
    m.MASK_ON = True
    m.BACKBONE.FREEZE_AT = 2
    m.RPN.BATCH_SIZE_PER_IMAGE = 1024
    m.RPN.POSITIVE_FRACTION = 1.0
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 36
    m.ROI_HEADS.POSITIVE_FRACTION = 1.0
    if loss == "giou":  # mask_rcnn_R_50_FPN_1x_giou.yaml
        m.RPN.BBOX_REG_LOSS_TYPE = m.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "giou"
        m.RPN.BBOX_REG_LOSS_WEIGHT = 2.0
        m.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 10.0
    m.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = pred_boxes
    if jax_side:
        return cfg
    port = get_cfg()
    port.merge_from_other_cfg(cfg)
    return port


CASES = {"giou": dict(loss="giou"), "pred_boxes": dict(pred_boxes=True)}


@pytest.fixture(scope="module")
def runs():
    batch = {k: np.array(v) for k, v in _batch(masks=True).items()}
    return {name: dict(jax_train_run(tiny_cfg(**kw), batch, steps=0), batch=batch) for name, kw in CASES.items()}


def _port_losses_and_grads(name, run):
    model = port_model(tiny_cfg(**CASES[name], jax_side=False), run["variables"])
    model.train()
    with batch_statistics():
        losses = model(run["batch"], generator=torch.Generator().manual_seed(0))
    return model, losses


@pytest.mark.parametrize("name", sorted(CASES))
def test_losses_and_gradients_match_jax(runs, name):
    run = runs[name]
    model, losses = _port_losses_and_grads(name, run)
    sum(losses.values()).backward()
    assert sorted(losses) == sorted(run["losses"]) == ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls",
                                                       "loss_rpn_loc"]
    for k in losses:
        assert _rel(run["losses"][k], losses[k].item()) <= TOL_LOSS, (k, run["losses"][k], losses[k].item())
    want = variables_to_state_dict({"params": run["grads"]})
    grads = {n: p.grad for n, p in model.named_parameters()}
    live = 0
    for n, w in want.items():
        w = w.numpy()
        if not np.abs(w).max() > 0:
            assert grads[n] is None or not grads[n].abs().max() > 0, n
            continue
        assert _rel(w, grads[n].numpy()) <= TOL_GRAD, (n, _rel(w, grads[n].numpy()))
        live += 1
    assert live >= 20


def test_giou_losses_differ_from_smooth_l1(runs):
    """The GIoU branch is taken in both stages: the box losses of the giou
    config are not the smooth-L1 ones, and the RPN's carries its weight 2."""
    run = runs["giou"]
    model = port_model(tiny_cfg(jax_side=False), run["variables"])
    model.train()
    plain = model(run["batch"], generator=torch.Generator().manual_seed(0))
    for k in ("loss_rpn_loc", "loss_box_reg"):
        assert abs(plain[k].item() - run["losses"][k]) > 0.1 * run["losses"][k], k
    for k in ("loss_rpn_cls", "loss_cls", "loss_mask"):
        assert _rel(run["losses"][k], plain[k].item()) <= TOL_LOSS, k
    rpn = model.proposal_generator
    rpn.box_reg_loss_weight = 1.0
    rpn.box_reg_loss_type = "giou"
    half = model(run["batch"], generator=torch.Generator().manual_seed(0))["loss_rpn_loc"].item()
    assert abs(2 * half - run["losses"]["loss_rpn_loc"]) <= 1e-5 * run["losses"]["loss_rpn_loc"]


def test_train_on_pred_boxes_pools_detached_predictions(runs, monkeypatch):
    """The mask pooler's boxes are the box head's predictions (not the
    sampled proposals the box pooler read), and loss_mask alone leaves the
    box predictor without a gradient."""
    run = runs["pred_boxes"]
    seen = []
    fn = poolers.roi_align_multilevel

    def recording(features, scales, boxes, *args, **kwargs):
        seen.append(boxes.detach().clone())
        return fn(features, scales, boxes, *args, **kwargs)

    monkeypatch.setattr(poolers, "roi_align_multilevel", recording)
    model, losses = _port_losses_and_grads("pred_boxes", run)
    box_rois, mask_rois = seen
    assert not mask_rois.requires_grad
    rh = model.roi_heads
    assert box_rois.shape == (2 * rh.batch_size_per_image, 4)
    assert not (mask_rois[:, None] == box_rois[None]).all(-1).any()
    losses["loss_mask"].backward()
    assert model.roi_heads.box_predictor.bbox_pred.weight.grad is None
    assert model.roi_heads.mask_head.predictor.weight.grad is not None
