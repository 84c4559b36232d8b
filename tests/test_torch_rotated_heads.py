"""The rotated modules alone, the checkpoint names, the builds by name and
the full-width configuration in the port, on the CPU: ``RRPN`` and
``RROIHeads`` on seeded maps held against the JAX package's (weights
carried across by ``checkpoint.variables_to_state_dict``, the gains and the
deterministic sampling of ``tests/test_torch_rotated_model.py``); the
converter's detectron2 names for RRPN's 5-dim ``anchor_deltas`` and
RROIHeads' box head and predictor, and the round trip through the JAX
package's converter; ``RRPN``, ``RROIHeads`` and ``ROIAlignRotated`` by
name, and the standard RPN refusing rotated anchors
(``tests/test_torch_rotated_full.py`` serves, trains and scores the
full-width configuration).

Tolerances (float32; the largest gap measured on the CPU in brackets):
RRPN's proposals within 1e-3 px (3.8e-6), scores within 1e-5 relative,
losses within 1e-5 relative (6.1e-8); RROIHeads' detections matched by class
and box within 1e-3 px (1.9e-6) and 1e-4 in score (1.6e-7), losses within
1e-5 relative (8.6e-8).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu_torch.config import faster_rcnn_R_50_C4_cfg
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.proposal_generator.rrpn import RRPN
from jtsm_tpu_torch.modeling.roi_heads.rotated_fast_rcnn import RROIHeads
from tests.test_torch_c4 import _rel
from tests.test_torch_rotated import random_boxes, t
from tests.test_torch_rotated_model import match_rotated, narrow_cfg, rotated_batch, seeded_models

TOL_F32 = 1e-5
TOL_PX = 1e-3
TOL_LOSS = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _method(name):
    return lambda mdl, *a, **k: getattr(mdl, name)(*a, **k)


def test_rrpn_alone_as_jax():
    """RRPN on seeded res4 maps of two 128x160 images (240 anchors):
    serving proposals and scores; in training its losses and proposals."""
    cfg = narrow_cfg()
    batch = rotated_batch(seed=3, hw=(128, 160))
    jm, jb, variables, tm = seeded_models(cfg, batch)
    rng = np.random.default_rng(3)
    feat = rng.normal(size=(2, 8, 10, 256)).astype(np.float32)
    sizes = jnp.asarray(batch["image_sizes"])
    gt, gv = jb["gt_boxes"], jb["gt_valid"]
    rrpn = tm.proposal_generator
    for train in (False, True):
        with jax.default_matmul_precision("highest"):
            wp, ws, wl = jax.jit(lambda v: jm.apply(v, sizes, {"res4": jnp.asarray(feat)}, gt, gv, train=train,
                                                    rngs={"sampling": jax.random.key(1)},
                                                    method=_method("proposal_generator")))(variables)
        rrpn.train(train)
        tf = {"res4": t(feat).permute(0, 3, 1, 2)}
        gp, gs, gl = rrpn(t(batch["image_sizes"]), tf, t(batch["gt_boxes"]), t(batch["gt_valid"]),
                          torch.Generator().manual_seed(0))
        assert gp.shape == (2, 16, 5) and np.isfinite(np.asarray(ws)).sum() == torch.isfinite(gs).sum() > 20
        px = float(np.abs(np.asarray(wp) - gp.numpy()).max())
        print("proposals px", px)
        assert px <= TOL_PX
        assert _rel(np.asarray(ws)[np.isfinite(ws)], gs.numpy()[np.isfinite(gs.numpy())]) <= TOL_F32
        assert sorted(gl) == sorted(wl)
        for k in wl:
            print(k, float(wl[k]), gl[k].item())
            assert _rel(float(wl[k]), gl[k].item()) <= TOL_LOSS and float(wl[k]) > 0
    tm.eval()


def test_rroi_heads_alone_as_jax():
    """RROIHeads on seeded res4 maps and given proposals (each ground truth
    box jittered by 2 px, then random boxes; the second image's last three
    slots unused): serving detections, and in training ``loss_cls`` and
    ``loss_box_reg`` with every proposal a slot."""
    cfg = narrow_cfg()
    batch = rotated_batch(seed=4)
    jm, jb, variables, tm = seeded_models(cfg, batch, seed=4)
    rng = np.random.default_rng(4)
    feat = rng.normal(size=(2, 4, 4, 256)).astype(np.float32)
    k = 16
    props = np.concatenate([batch["gt_boxes"] + rng.normal(0, 2, batch["gt_boxes"].shape).astype(np.float32),
                            random_boxes(rng, 2 * (k - 3), extent=60.0, sides=(8.0, 30.0)).reshape(2, k - 3, 5)], 1)
    scores = np.sort(rng.normal(size=(2, k)), axis=1)[:, ::-1].astype(np.float32)
    scores[1, -3:] = -np.inf
    targets = {key: jb[key] for key in ("gt_boxes", "gt_classes", "gt_valid")}
    heads = tm.roi_heads
    tf = {"res4": t(feat).permute(0, 3, 1, 2)}
    for train in (False, True):
        with jax.default_matmul_precision("highest"):
            want, wl = jax.jit(lambda v: jm.apply(
                v, {"res4": jnp.asarray(feat)}, jnp.asarray(props), jnp.asarray(scores),
                jnp.asarray(batch["image_sizes"]), targets if train else None, train=train,
                rngs={"sampling": jax.random.key(1)}, method=_method("roi_heads")))(variables)
        heads.train(train)
        got = heads(tf, t(props), t(scores), t(batch["image_sizes"]),
                    {key: t(batch[key]) for key in targets} if train else None, torch.Generator().manual_seed(0))
        if not train:
            print("detections", match_rotated(want, got))
            continue
        assert sorted(got) == sorted(wl) == ["loss_box_reg", "loss_cls"]
        for key in wl:
            print(key, float(wl[key]), got[key].item())
            assert _rel(float(wl[key]), got[key].item()) <= TOL_LOSS and float(wl[key]) > 0
    heads.eval()


def test_checkpoint_names_and_round_trip():
    """The JAX package's variables reach the port under detectron2's names:
    RRPN's head as ``proposal_generator.rpn_head`` (``anchor_deltas`` 5
    deltas an anchor), RROIHeads' ``box_head.fc1`` (rows from (P, P, C) to
    detectron2's (C, P, P)) and its own ``cls_score`` and ``bbox_pred`` as
    ``roi_heads.box_predictor.*``. Back through the JAX package's converter
    every other entry lands where it came from; that converter has no
    branch for RROIHeads' predictor (it looks under ``box_predictor``,
    ROADMAP §3), which is held here by hand."""
    cfg = narrow_cfg()
    jm, jb, variables, tm = seeded_models(cfg, rotated_batch())
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    params = variables["params"]
    a = tm.proposal_generator.anchor_generator.num_anchors[0]
    assert state["proposal_generator.rpn_head.anchor_deltas.weight"].shape == (5 * a, 256, 1, 1)
    for leaf in ("cls_score", "bbox_pred"):
        np.testing.assert_array_equal(state[f"roi_heads.box_predictor.{leaf}.weight"],
                                      np.asarray(params["roi_heads"][leaf]["dense"]["kernel"]).T)
        np.testing.assert_array_equal(state[f"roi_heads.box_predictor.{leaf}.bias"],
                                      np.asarray(params["roi_heads"][leaf]["dense"]["bias"]))
    fc1 = np.asarray(params["roi_heads"]["box_head"]["fc1"]["dense"]["kernel"])  # (P*P*C, out)
    np.testing.assert_array_equal(state["roi_heads.box_head.fc1.weight"],
                                  fc1.reshape(7, 7, 256, -1).transpose(3, 2, 0, 1).reshape(fc1.shape[1], -1))
    assert "roi_heads.box_head.fc2.weight" not in state  # one fc in the narrow form
    back, matched, unmatched = convert_d2_state_dict_to_variables(state, variables)
    assert sorted(unmatched) == [f"roi_heads.box_predictor.{leaf}.{p}" for leaf in ("bbox_pred", "cls_score")
                                 for p in ("bias", "weight")]
    flat_back = jax.tree_util.tree_leaves_with_path(back)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(variables))
    assert len(matched) == len(state) - 4 and len(flat_back) == len(flat_want)
    for path, leaf in flat_back:
        np.testing.assert_array_equal(np.asarray(leaf), np.asarray(flat_want[path]), err_msg=str(path))


def test_rotated_pieces_build_by_name():
    cfg = narrow_cfg()
    model = build_model(cfg, device="cpu")
    assert isinstance(model.proposal_generator, RRPN) and isinstance(model.roi_heads, RROIHeads)
    assert model.roi_heads.box2box_transform.weights == (10.0, 10.0, 5.0, 5.0, 1.0)
    assert model.proposal_generator.box2box_transform.weights == (1.0, 1.0, 1.0, 1.0, 1.0)
    assert model.roi_heads.sampling_ratio == 2  # POOLER_SAMPLING_RATIO 0
    assert model.roi_heads.box_predictor.bbox_pred.out_features == 5  # class-agnostic
    # the standard RPN refuses 5-dim anchors with a message
    cfg = faster_rcnn_R_50_C4_cfg(narrow=True)
    cfg.MODEL.ANCHOR_GENERATOR.NAME = "RotatedAnchorGenerator"
    with pytest.raises(ValueError, match="RotatedAnchorGenerator' goes with MODEL.PROPOSAL_GENERATOR.NAME 'RRPN'"):
        build_model(cfg, device="cpu")
    # RRPN trains on 5-dim ground truth only: the 4-dim boxes of the DatasetMapper stop it with a message
    batch = rotated_batch()
    batch["gt_boxes"] = batch["gt_boxes"][..., :4]
    model = build_model(narrow_cfg(), device="cpu").train()
    with pytest.raises(ValueError, match="annotations_to_instances_rotated"):
        model(batch)
