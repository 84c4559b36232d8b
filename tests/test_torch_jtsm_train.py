"""The port's JTSM training (``jtsm_tpu_torch.wsl``, the ``SemSegFPNHead``
loss and ``SOLVER.CLIP_GRADIENTS``) held against the JAX package on the CPU,
from numpy seeds: each mining and loss function on inputs with forced ties,
the tiny ``_jtsm_cfg_tiny`` model's loss dict and gradients, three train
steps of the narrow gate config with its full-model clip, and bf16.

The DAN drops at 0.5 in training and the two frameworks draw other bits,
so the parity tests set the rate to 0 on both sides (``dan_dropout`` on the
JAX module through flax ``clone``, ``dropout`` on the port's DAN); the
port's dropout is tested on its own.

Tolerances, each beside the largest gap measured on the CPU:

=============================================  ==========  =========
check                                          measured    tolerance
=============================================  ==========  =========
mining functions: integers, masks, indices     0           equal
mining and loss functions: floats              <= 1e-7     1e-6
tiny loss dict (12 keys), relative             7.9e-7      1e-5
tiny gradients, of each parameter's scale      5.0e-6      1e-5
gate, three steps: losses, relative            9.1e-7      1e-5
gate, three steps: parameter updates           see below   see below
clip types against optax, relative             <= 1e-7     1e-6
tiny loss dict in bf16, relative: refinement   1.9e-2      4e-2
  branches; MIL, masks, stuff                  1.2e-3      4e-3
=============================================  ==========  =========

A parameter's "scale" is the largest magnitude of its JAX gradient (or
update). Each step's parameter update (the parameter minus its start)
is held to 1e-5 of the update's scale plus one float32 ulp of the
parameter per step taken: the updates are a few hundred ulps, and the two
frameworks round each new parameter on their own (measured: at most the
allowance's 0.999 at the first step, 0.5 after). The MIL ``det`` bias gets no gradient in exact arithmetic (the
softmax over proposals does not move when a class's logits all shift
together); both frameworks return rounding noise there, so a parameter
whose JAX gradient is below 1e-6 of the model's largest is held to that
bound on the port's side instead.

The JAX package labels no bias as a bias (``solver/build.py:97``), so it
updates biases at the base learning rate with WEIGHT_DECAY; the port
groups them as detectron2 does. The two differ where BIAS_LR_FACTOR or
WEIGHT_DECAY_BIAS leave their defaults, as the JTSM flagship's do (2.0 and
0.0; the gate keeps 1.0 and WEIGHT_DECAY). The step test takes the gate
with the flagship's two bias settings and holds every other parameter to
the JAX package's optax step and the biases to detectron2's update,
written out here from the JAX gradients: clipped by the global norm, then
momentum at twice the learning rate, without weight decay.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp
import jtsm_tpu.modeling.roi_heads.mask_head as jax_mask_head
import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from __graft_entry__ import _jtsm_batch, _jtsm_cfg_tiny
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.ops.box_regression import Box2BoxTransform as JaxBox2BoxTransform
from jtsm_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from jtsm_tpu.solver import build_optimizer as jax_build_optimizer
from jtsm_tpu.solver.build import clip_per_param_norm as jax_clip_per_param_norm
from jtsm_tpu.structures.instances import Instances as JaxInstances
from jtsm_tpu.data.detection_utils import build_static_batch as jax_build_static_batch
from jtsm_tpu.wsl.modeling import mil_heads as jax_mil
from jtsm_tpu.wsl.modeling import roi_heads_jtsm as jax_rhj
from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw
from jtsm_tpu_torch.checkpoint import random_state_dict, variables_to_state_dict
from jtsm_tpu_torch.config import jtsm_gate_cfg, wsl_cfg
from jtsm_tpu_torch.engine import create_train_state, make_train_step
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.ops.box_regression import Box2BoxTransform
from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer, param_label
from jtsm_tpu_torch.solver.build import clip_by_global_norm, clip_by_value, clip_per_param_norm
from jtsm_tpu_torch.wsl import data as wsl_data
from jtsm_tpu_torch.wsl.modeling import mil_heads
from jtsm_tpu_torch.wsl.modeling import roi_heads_jtsm as rhj
from jtsm_tpu_torch.wsl.modeling.roi_heads_wsl import image_level_gt, image_level_gt_stuff
from tests import test_torch_jtsm
from tests.test_torch_jtsm import _gate_batch, _jax_cfg, _seeded_variables

LOSSES = sorted(
    ["loss_mil", "loss_mask", "loss_mask_r0", "loss_sem_seg"]
    + [f"loss_refine_{k}{i}" for k in ("cls", "reg") for i in range(4)]
)
STEPS = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _equal_dicts(want, got, float_atol=1e-6):
    assert sorted(want) == sorted(got)
    for k in want:
        w, g = np.asarray(want[k]), _np(got[k])
        assert w.shape == g.shape, (k, w.shape, g.shape)
        if w.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w, err_msg=k)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=float_atol, err_msg=k)


def _boxes(rng, *shape, size=40.0):
    xy = rng.rand(*shape, 2) * size
    return np.concatenate([xy, xy + rng.rand(*shape, 2) * size * 0.8 + 2], -1).astype(np.float32)


# -- mining and loss functions ------------------------------------------------


@pytest.mark.parametrize("mean_loss", [True, False])
def test_mil_image_loss_matches_jax(mean_loss):
    rng = np.random.RandomState(10)
    scores = rng.rand(3, 9, 6).astype(np.float32) / 4
    scores[0, :, 2] = 0.0  # an image score at the lower clamp
    labels = (rng.rand(3, 6) > 0.5).astype(np.float32)
    want = jax.jit(jax.vmap(lambda s, l: jax_mil.mil_image_loss(s, l, mean_loss)))(scores, labels)
    got = mil_heads.mil_image_loss(_t(scores), _t(labels), mean_loss)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


def _mining_inputs(seed, b=2, r=14, c=5, per_class=False):
    """Scores from three values (ties everywhere), duplicated boxes, a
    padded tail and one image without labels."""
    rng = np.random.RandomState(seed)
    scores = rng.choice([0.1, 0.2, 0.3], (b, r, c)).astype(np.float32)
    boxes = _boxes(rng, b, r, c) if per_class else _boxes(rng, b, r)
    boxes[:, 3] = boxes[:, 1]  # equal boxes
    valid = np.ones((b, r), bool)
    valid[1, -3:] = False
    labels = (rng.rand(b, c) > 0.4).astype(np.float32)
    labels[0, :2] = 1.0
    labels[-1] = 0.0 if b > 2 else labels[-1]
    img_w = rng.rand(b, c).astype(np.float32)
    return boxes, scores, valid, labels, img_w


@pytest.mark.parametrize("top_k,per_class,weighted", [(1, False, True), (1, True, True), (3, False, False),
                                                      (2, True, False)])
def test_get_pgt_top_k_matches_jax(top_k, per_class, weighted):
    boxes, scores, valid, labels, img_w = _mining_inputs(11, b=3, per_class=per_class)
    if weighted:
        fn = jax.vmap(lambda bx, s, v, l, w: jax_mil.get_pgt_top_k(bx, s, v, l, top_k, w))
        want = jax.jit(fn)(boxes, scores, valid, labels, img_w)
        got = mil_heads.get_pgt_top_k(*map(_t, (boxes, scores, valid, labels)), top_k, _t(img_w))
    else:
        fn = jax.vmap(lambda bx, s, v, l: jax_mil.get_pgt_top_k(bx, s, v, l, top_k))
        want = jax.jit(fn)(boxes, scores, valid, labels)
        got = mil_heads.get_pgt_top_k(*map(_t, (boxes, scores, valid, labels)), top_k)
    _equal_dicts(want, got)
    assert _np(got["valid"]).any() and not _np(got["valid"]).all()


def test_get_pgt_mist_matches_jax():
    boxes, scores, valid, labels, _ = _mining_inputs(12, r=40, c=4)
    want = jax.jit(jax.vmap(jax_mil.get_pgt_mist))(boxes, scores, valid, labels)
    got = mil_heads.get_pgt_mist(*map(_t, (boxes, scores, valid, labels)))
    _equal_dicts(want, got)
    v = _np(got["valid"])
    assert v.any() and (v.sum(-1) < 6).any()  # the NMS and the 15% cut removed candidates


@pytest.mark.parametrize("form", ["fg", "bg_thresh", "matcher"])
def test_label_proposals_by_pgt_matches_jax(form):
    rng = np.random.RandomState(13)
    b, r, c, k = 3, 16, 4, 2
    boxes = _boxes(rng, b, r)
    pgt_boxes = boxes[:, rng.randint(0, r, c * k)].reshape(b, c, k, 4)  # exact overlaps
    pgt_boxes[:, 1, 0] = pgt_boxes[:, 0, 0]  # two PGT rows on one box: an IoU tie
    pgt = {
        "boxes": pgt_boxes,
        "weight": rng.rand(b, c, k).astype(np.float32),
        "valid": rng.rand(b, c, k) > 0.3,
        "classes": np.broadcast_to(np.arange(c)[None, :, None], (b, c, k)).astype(np.int32),
    }
    pgt["valid"][2] = False  # an image without any PGT
    valid = rng.rand(b, r) > 0.1
    kw = {"fg": {}, "bg_thresh": {"bg_thresh": 0.1},
          "matcher": {"iou_thresholds": [0.1, 0.5], "iou_labels": [0, -1, 1]}}[form]
    want = jax.jit(jax.vmap(lambda bx, v, p: jax_mil.label_proposals_by_pgt(bx, v, p, c, **kw)))(boxes, valid, pgt)
    got = mil_heads.label_proposals_by_pgt(_t(boxes), _t(valid), {n: _t(a) for n, a in pgt.items()}, c, **kw)
    _equal_dicts(want, got)
    assert _np(got["fg"]).any() and (_np(got["weights"])[2] == 0).all()


@pytest.mark.parametrize("class_specific", [True, False])
def test_oicr_losses_match_jax(class_specific):
    rng = np.random.RandomState(14)
    b, r, c = 2, 12, 5
    logits = rng.randn(b, r, c + 1).astype(np.float32)
    labels = rng.randint(0, c + 1, (b, r)).astype(np.int32)
    weights = np.where(rng.rand(b, r) > 0.3, rng.rand(b, r), 0.0).astype(np.float32)
    fg = labels < c
    deltas = rng.randn(b, r, 4 * (c if class_specific else 1)).astype(np.float32) * 0.3
    props, pgt_boxes = _boxes(rng, b, r), _boxes(rng, b, r)
    want = jax.jit(jax.vmap(jax_mil.oicr_branch_loss))(logits, labels, weights)
    np.testing.assert_allclose(_np(mil_heads.oicr_branch_loss(*map(_t, (logits, labels, weights)))),
                               np.asarray(want), rtol=1e-6)
    want = jax.jit(jax.vmap(jax_mil.oicr_branch_loss_terms))(logits, labels, weights)
    got = mil_heads.oicr_branch_loss_terms(*map(_t, (logits, labels, weights)))
    for w, g in zip(want, got):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=1e-6)
    jt, tt = JaxBox2BoxTransform((10.0, 10.0, 5.0, 5.0)), Box2BoxTransform((10.0, 10.0, 5.0, 5.0))
    want = jax.jit(jax.vmap(lambda *a: jax_mil.oicr_reg_loss_sum(*a, jt)))(deltas, labels, weights, fg, props,
                                                                           pgt_boxes)
    got = mil_heads.oicr_reg_loss_sum(*map(_t, (deltas, labels, weights, fg, props, pgt_boxes)), tt)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("grid_stride", [4, 1])
def test_superpixel_union_mask_crops_match_jax(grid_stride):
    rng = np.random.RandomState(15)
    b, d, s, hs, ws, m = 2, 9, 12, 45, 61, 28
    sp = np.kron(rng.randint(0, s + 2, (6, 8)), np.ones((8, 8), np.int64))[:hs, :ws].astype(np.int32)  # ids past S
    sp = np.stack([sp, np.flipud(sp)])
    oh = rng.rand(b, d, s) > 0.5
    boxes = _boxes(rng, b, d, size=50.0)
    boxes[0, 0] = [-7.3, -4.1, 70.2, 52.9]  # across every border
    boxes[1, 1] = [12.5, 9.5, 12.5, 9.5]  # zero area
    fn = jax.jit(jax.vmap(lambda a, o, bx: jax_rhj.superpixel_union_mask_crops(a, o, bx, m, grid_stride)))
    want = np.asarray(fn(sp, oh, boxes))
    got = rhj.superpixel_union_mask_crops(*map(_t, (sp, oh, boxes)), m, grid_stride)
    np.testing.assert_array_equal(_np(got), want)
    assert want.any() and not want.all()
    if grid_stride == 1:  # the one-proposal form
        one = jax.jit(jax_rhj.superpixel_union_mask_crop, static_argnums=3)(sp[0], oh[0, 0], boxes[0, 0], m)
        got = rhj.superpixel_union_mask_crop(_t(sp[0]), _t(oh[0, 0]), _t(boxes[0, 0]), m)
        np.testing.assert_array_equal(_np(got), np.asarray(one))


def test_image_level_labels_match_jax():
    rng = np.random.RandomState(16)
    classes = rng.randint(0, 25, (3, 6)).astype(np.int32)  # some past the 20 classes
    valid = rng.rand(3, 6) > 0.3
    want = jax.jit(jax.vmap(lambda c, v: jax_rhw.image_level_gt(c, v, 20)))(classes, valid)
    np.testing.assert_array_equal(_np(image_level_gt(_t(classes), _t(valid), 20)), np.asarray(want))
    seg = rng.randint(0, 60, (3, 9, 11)).astype(np.int32)  # 54..59 outside the classes
    seg[0, :4] = 255
    seg[2] = 255  # nothing labelled
    want = jax.jit(jax.vmap(lambda x: jax_rhw.image_level_gt_stuff(x, 54, 255)))(seg)
    got = image_level_gt_stuff(_t(seg), 54, 255)
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert _np(got)[2].sum() == 0 and _np(got)[0].sum() > 0


# -- the tiny model --------------------------------------------------------------


def _port_model(jax_cfg, variables, dtype="float32"):
    cfg = wsl_cfg()
    cfg.merge_from_other_cfg(jax_cfg)
    cfg.TPU.COMPUTE_DTYPE = dtype
    model = build_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return cfg, model


def _no_dropout(jm):
    return jm.clone(roi_heads=jm.roi_heads.clone(dan_dropout=0.0))


def _tiny_batch():
    return {k: np.array(v) for k, v in _jtsm_batch(2).items()}


def _port_mining(model, batch):
    """The port's heads stage by stage on ``batch``: (losses, aux, mined)."""
    rh = model.roi_heads
    features, _ = model._features(batch)
    props, scores, sp, oh = model.request_fields(batch)
    targets = {k: _t(batch[k]) for k in ("gt_classes", "gt_valid", "gt_sem_seg")}
    pooled, nonempty = rh.pool(features[rh.in_features[0]].permute(0, 2, 3, 1), props, sp, oh)
    mil, branches = rh.train_outputs(pooled, nonempty, scores)
    return rh.mine(props, scores, mil, branches, targets, sp, oh)


@pytest.fixture(scope="module")
def tiny_run():
    """The JAX side once: the loss dict and gradients of the tiny model on
    ``_jtsm_batch(2)`` (jitted, matmul precision "highest"), with the mask
    branch's mined classes, validity and targets and the painted pseudo
    sem-seg map read out of the jitted step."""
    jc = _jtsm_cfg_tiny()
    batch = _tiny_batch()
    jm = jax_build_model(jc)
    variables = _seeded_variables(jm, {k: jnp.asarray(v) for k, v in batch.items()}, seed=0)
    jm = _no_dropout(jm)
    captured = {"mask": [], "sem": []}
    loss_orig, sem_orig = jax_mask_head.mask_rcnn_loss, jax_rhj.JTSMROIHeads._mine_sem_seg

    def loss_spy(logits, cls, targets, ok, *a, **k):
        jax.debug.callback(lambda *x: captured["mask"].append([np.asarray(v) for v in x]), cls, ok, targets)
        return loss_orig(logits, cls, targets, ok, *a, **k)

    def sem_spy(self, *a):
        out = sem_orig(self, *a)
        jax.debug.callback(lambda o: captured["sem"].append(np.asarray(o)), out)
        return out

    def loss_fn(params):
        v = dict(variables, params=params)
        losses = jm.apply(v, {k: jnp.asarray(x) for k, x in batch.items()}, train=True,
                          rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(0)})
        return sum(losses.values()), losses

    jax_mask_head.mask_rcnn_loss, jax_rhj.JTSMROIHeads._mine_sem_seg = loss_spy, sem_spy
    try:
        with jax.default_matmul_precision("highest"):
            (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
            jax.block_until_ready(grads)
    finally:
        jax_mask_head.mask_rcnn_loss, jax_rhj.JTSMROIHeads._mine_sem_seg = loss_orig, sem_orig
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(cfg=jc, jm=jm, batch=batch, variables=to_np(variables), captured=captured,
                losses={k: float(v) for k, v in losses.items()}, grads=variables_to_state_dict({"params": to_np(grads)}))


@pytest.fixture(scope="module")
def tiny_port(tiny_run):
    """The port's loss dict and gradients from the same weights."""
    _, model = _port_model(tiny_run["cfg"], tiny_run["variables"])
    model.train()
    model.roi_heads.dan.dropout = 0.0
    losses = model(tiny_run["batch"], generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return dict(model=model, losses={k: v.item() for k, v in losses.items()}, grads=grads)


def test_tiny_losses_and_mined_targets_match_jax(tiny_run, tiny_port):
    want, got = tiny_run["losses"], tiny_port["losses"]
    assert sorted(got) == sorted(want) == LOSSES
    for k in LOSSES:
        assert np.isfinite(want[k]) and want[k] > 0, k
        assert _rel(want[k], got[k]) <= 1e-5, (k, want[k], got[k])
    # the mined integers: the mask ROIs' classes, validity and superpixel
    # targets, and the painted pseudo sem-seg map
    model = tiny_port["model"]
    with torch.no_grad():
        _, aux, mined = _port_mining(model, tiny_run["batch"])
    (cls, ok, targets), (_, ok_r, _) = tiny_run["captured"]["mask"]
    np.testing.assert_array_equal(_np(mined["classes"]).reshape(-1), cls)
    np.testing.assert_array_equal(_np(mined["ok"]).reshape(-1), ok)
    np.testing.assert_array_equal(_np(mined["targets"]).reshape(targets.shape), targets >= 0.5)
    np.testing.assert_array_equal(ok_r, ok)
    assert ok.any() and targets.any()
    (pgt,) = tiny_run["captured"]["sem"]
    np.testing.assert_array_equal(_np(aux["pgt_sem_seg"]), pgt)
    assert aux["pgt_sem_seg_stride"] == 4 and len(np.unique(pgt)) > 1


@pytest.mark.parametrize("prefix", ["backbone.", "roi_heads.dan", "roi_heads.mil", "roi_heads.refine",
                                    "roi_heads.mask", "sem_seg_head."])
def test_tiny_gradients_match_jax(tiny_run, tiny_port, prefix):
    want_all, got_all = tiny_run["grads"], tiny_port["grads"]
    assert sorted(want_all) == sorted(got_all)
    top = max(float(np.abs(g.numpy()).max()) for g in want_all.values())
    names = [n for n in want_all if n.startswith(prefix)]
    assert names
    for n in names:
        want, got = want_all[n].numpy(), got_all[n]
        assert got is not None, n
        scale = float(np.abs(want).max())
        if scale < 1e-6 * top:  # zero in exact arithmetic (see the module docstring)
            assert float(got.abs().max()) < 1e-6 * top, n
            continue
        assert _rel(want, got.numpy()) <= 1e-5, (n, _rel(want, got.numpy()))


def test_mine_sem_seg_equals_jax():
    """``_mine_sem_seg`` on tied scores: 53 stuff classes over 8
    superpixels, so classes overwrite each other and the force-missing pass
    repaints."""
    rng = np.random.RandomState(17)
    jc = _jtsm_cfg_tiny()
    b, r, s, ct, cs = 2, 16, 8, 20, 53
    proposals = _boxes(rng, b, r)
    valid = rng.rand(b, r) > 0.1
    mil = rng.choice([0.01, 0.02, 0.03], (b, r, ct + cs)).astype(np.float32)
    labels = (rng.rand(b, ct + cs) > 0.7).astype(np.float32)
    sp = rng.randint(0, s + 1, (b, 16, 16)).astype(np.int32)  # id 8 lies outside S
    oh = rng.rand(b, r, s) > 0.6
    jrh = jax_build_model(jc).roi_heads
    want = jax.jit(lambda *a: jrh.apply({}, *a, method=jax_rhj.JTSMROIHeads._mine_sem_seg))(
        proposals, valid, mil, labels, sp, oh)
    cfg = wsl_cfg()
    cfg.merge_from_other_cfg(jc)
    got = build_model(cfg, device="cpu").roi_heads._mine_sem_seg(*map(_t, (proposals, valid, mil, labels, sp, oh)))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert len(np.unique(np.asarray(want))) > 2


def test_flagship_frozen_backbone_runs_no_roi_align_backward(monkeypatch):
    """FREEZE_AT 5 (the flagship's): no gradient reaches the backbone, so
    the mask pooler's ROIAlign takes no backward; at FREEZE_AT 0 it takes
    one a step."""
    import jtsm_tpu_torch.ops.roi_align as roi_align

    calls = []
    plain = roi_align.roi_align_multilevel_backward_plain

    def spy(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(roi_align, "roi_align_multilevel_backward_plain", spy)
    cfg = wsl_cfg()
    cfg.merge_from_other_cfg(_jtsm_cfg_tiny())
    batch = _tiny_batch()
    for freeze_at, backward_calls in ((5, 0), (0, 1)):
        cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
        model = build_model(cfg, device="cpu")
        model.load_state_dict(random_state_dict(model, seed=1))
        model.train()
        calls.clear()
        losses = model(batch, generator=torch.Generator().manual_seed(0))
        sum(losses.values()).backward()
        assert len(calls) == backward_calls, freeze_at
        backbone_grads = [p.grad for n, p in model.named_parameters() if n.startswith("backbone.")]
        assert all(g is None for g in backbone_grads) == (freeze_at == 5)
        assert model.roi_heads.dan.dan1.weight.grad.abs().max() > 0


def test_dan_dropout_draws_from_the_generator():
    cfg = wsl_cfg()
    cfg.merge_from_other_cfg(_jtsm_cfg_tiny())
    model = build_model(cfg, device="cpu")
    model.load_state_dict(random_state_dict(model, seed=2))
    model.train()
    batch = _tiny_batch()
    assert model.roi_heads.dan.dropout == 0.5
    with torch.no_grad():
        run = [model(batch, generator=torch.Generator().manual_seed(s)) for s in (7, 7, 8)]
    assert all(torch.equal(run[0][k], run[1][k]) for k in run[0])
    assert run[0]["loss_mil"] != run[2]["loss_mil"]
    # PyTorch's own generator is not drawn from
    torch.manual_seed(0)
    before = torch.rand(4)
    torch.manual_seed(0)
    with torch.no_grad():
        model(batch, generator=torch.Generator().manual_seed(7))
    assert torch.equal(torch.rand(4), before)
    # survivors are scaled by 1 / (1 - p), the rest are 0
    dan = model.roi_heads.dan
    x = torch.rand(64, dan.dan1.in_features)
    with torch.no_grad():
        h = torch.relu(dan.dan1(x))
        dan.fcs = dan.fcs[:1]
        out = dan(x, torch.Generator().manual_seed(3))
    live, kept = h != 0, out != 0
    assert not (kept & ~live).any() and 0.4 < kept[live].float().mean() < 0.6
    torch.testing.assert_close(out[kept], h[kept] * 2.0, rtol=1e-6, atol=0)
    model.eval()
    with torch.no_grad():
        torch.testing.assert_close(dan(x), h)


def test_grabcut_evidence_is_not_ported():
    cfg = wsl_cfg()
    cfg.merge_from_other_cfg(_jtsm_cfg_tiny())
    cfg.WSL.OBJECT_EVIDENCE = "grabcut"
    model = build_model(cfg, device="cpu")
    model.train()
    with pytest.raises(NotImplementedError):
        model(_tiny_batch())


def test_train_fields_equal_jax_static_batch():
    rng = np.random.RandomState(18)
    sizes = [(40, 56), (48, 32)]
    per_image, jax_images = [], []
    for h, w in sizes:
        n = rng.randint(1, 4)
        d = {"image": np.zeros((h, w, 3), np.float32), "gt_classes": rng.randint(0, 20, n),
             "gt_boxes": _boxes(rng, n), "sem_seg": rng.randint(0, 54, (h, w)).astype(np.int32)}
        per_image.append(d)
        jax_images.append({"image": d["image"], "sem_seg": d["sem_seg"],
                           "instances": JaxInstances((h, w), gt_boxes=d["gt_boxes"], gt_classes=d["gt_classes"])})
    want = jax_build_static_batch(jax_images, [[48, 64]], max_instances=5)
    got = {"image": np.zeros((2, 48, 64, 3), np.float32)}
    wsl_data.add_wsl_train_fields(got, per_image, 5)
    for k in ("gt_boxes", "gt_classes", "gt_valid", "gt_sem_seg"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- the gate config: three steps with the full-model clip --------------------


def _gate_train_batch():
    batch = _gate_batch()
    rng = np.random.RandomState(19)
    batch["gt_classes"] = rng.randint(0, 80, (2, 4)).astype(np.int32)
    batch["gt_valid"] = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    batch["gt_boxes"] = np.zeros((2, 4, 4), np.float32)
    batch["gt_sem_seg"] = rng.randint(0, 54, (2, 128, 176)).astype(np.int32)
    batch["gt_sem_seg"][1, 112:] = 255
    return batch


def _gate_cfg():
    jc = _jax_cfg(jtsm_gate_cfg())
    # warmup over the first two updates, then the milestone: three
    # learning rates in three steps
    jc.SOLVER.WARMUP_ITERS = 2
    jc.SOLVER.STEPS = (2,)
    # the gate's BASE_LR 0.01 from a warmup factor of 0.1 (0.01 makes
    # updates of a few float32 ulps of the parameters); at 0.1 the
    # third step's mining turns on near-ties and the two trajectories part
    jc.SOLVER.WARMUP_FACTOR = 0.1
    # the flagship's bias settings (the gate keeps the defaults, 1.0 and
    # WEIGHT_DECAY, where the JAX package's update agrees with detectron2's)
    jc.SOLVER.BIAS_LR_FACTOR = 2.0
    jc.SOLVER.WEIGHT_DECAY_BIAS = 0.0
    return jc


def test_gate_three_steps_match_jax_optax(monkeypatch):
    """The refinery head trains on the base head's prediction thresholded
    at logit 0, so a base logit within rounding of 0 on a counted ROI would
    flip a target between the frameworks; the weights give the mask
    predictors unit gain, and each step asserts that no such logit lies
    within 1e-5 of 0."""
    jc = _gate_cfg()
    assert jc.SOLVER.CLIP_GRADIENTS.CLIP_TYPE == "full_model" and jc.MODEL.BACKBONE.FREEZE_AT == 0
    batch = _gate_train_batch()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = jax_build_model(jc)
    monkeypatch.setattr(test_torch_jtsm, "_GAINS", {"dan1": 0.05, "refine_reg": 0.05})
    variables = _seeded_variables(jm, jb, seed=1)
    jm = _no_dropout(jm)
    cfg, model = _port_model(jc, jax.tree_util.tree_map(np.asarray, variables))
    base_logits = []
    loss = rhj.mask_rcnn_loss

    def spy(logits, cls, targets, ok):
        if logits.shape[1] == 1:  # the class-agnostic base head
            base_logits.append((logits.detach()[:, 0], ok))
        return loss(logits, cls, targets, ok)

    monkeypatch.setattr(rhj, "mask_rcnn_loss", spy)
    model.roi_heads.dan.dropout = 0.0
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))

    params = variables["params"]
    tx = jax_build_optimizer(jc, params)
    opt_state = tx.init(params)
    schedule = jax_build_lr_schedule(jc)
    momentum = jc.SOLVER.MOMENTUM

    def loss_fn(p):
        losses = jm.apply(dict(variables, params=p), jb, train=True,
                          rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(0)})
        return sum(losses.values()), losses

    with jax.default_matmul_precision("highest"):
        grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        update = jax.jit(tx.update)
    names = list(variables_to_state_dict({"params": params}))
    is_bias = {n: param_label(n) == "bias" for n in names}
    assert sum(is_bias.values()) > 10
    bias_buf = {}
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    for step in range(STEPS):
        with jax.default_matmul_precision("highest"):
            (_, losses), grads = grad_fn(params)
            updates, opt_state = update(grads, opt_state, params)
        new = optax.apply_updates(params, updates)
        g = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
        norm = np.sqrt(sum(float((v.double() ** 2).sum()) for v in g.values()))
        if step == 0:
            assert norm > jc.SOLVER.CLIP_GRADIENTS.CLIP_VALUE  # the clip acts
        coef = 1.0 if norm < 1.0 else 1.0 / norm
        want = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, new)})
        old = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, params)})
        # detectron2's bias update: the clipped gradient plus
        # WEIGHT_DECAY_BIAS times the bias, momentum, the learning rate
        # times BIAS_LR_FACTOR
        for n in names:
            if is_bias[n]:
                d_p = g[n].double() * coef + jc.SOLVER.WEIGHT_DECAY_BIAS * old[n].double()
                bias_buf[n] = d_p if step == 0 else momentum * bias_buf[n] + d_p
                want[n] = (old[n].double() - float(schedule(step)) * jc.SOLVER.BIAS_LR_FACTOR * bias_buf[n]).float()

        base_logits.clear()
        metrics = train_step(state, batch)
        (base, ok), = base_logits
        assert ok.any() and float(base[ok].abs().min()) > 1e-5, step
        assert sorted(metrics) == sorted(list(losses) + ["total_loss"]) and len(losses) == 8
        for k in losses:
            assert _rel(float(losses[k]), metrics[k].item()) <= 1e-5, (step, k)
        got = dict(model.named_parameters())
        for n in names:
            # the update, to 1e-5 of its scale plus the float32 rounding of
            # the parameters themselves (one ulp an update on either side)
            moved = (want[n] - start[n]).double().numpy()
            err = np.abs((got[n].detach() - start[n]).double().numpy() - moved)
            ulps = (step + 1) * np.spacing(np.abs(want[n].numpy())).astype(np.float64)
            worst = float((err / (1e-5 * np.abs(moved).max() + ulps)).max())
            assert worst <= 1.0, (step, n, worst)
        # carry the written-out biases into the JAX parameters
        params = _replace_biases(new, {n: want[n].numpy() for n in names if is_bias[n]})


def _replace_biases(params, biases):
    """``params`` with the leaves that ``variables_to_state_dict`` names as
    the keys of ``biases`` replaced by their values (biases convert
    unchanged)."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)]
    )
    where = {n: int(v.reshape(-1)[0]) for n, v in variables_to_state_dict({"params": tagged}).items()}
    leaves = list(leaves)
    for n, v in biases.items():
        assert np.shape(leaves[where[n]]) == v.shape, n
        leaves[where[n]] = jnp.asarray(v)
    return jax.tree_util.tree_unflatten(treedef, leaves)


# -- gradient clipping ---------------------------------------------------------


@pytest.mark.parametrize("kind", ["value", "full_model_clipped", "full_model_unclipped", "norm", "norm_inf"])
def test_clip_types_match_optax(kind):
    rng = np.random.RandomState(20)
    tree = {"a": {"kernel": rng.randn(5, 3), "bias": rng.randn(3)}, "b": {"kernel": rng.randn(4, 4) * 3}}
    tree = jax.tree_util.tree_map(lambda x: x.astype(np.float32), tree)
    if kind == "value":
        jt, fn = optax.clip(0.7), lambda gs: clip_by_value(gs, 0.7)
    elif kind.startswith("full_model"):
        c = 2.0 if kind.endswith("_clipped") else 100.0
        jt, fn = optax.clip_by_global_norm(c), lambda gs: clip_by_global_norm(gs, c)
    else:
        p = float("inf") if kind == "norm_inf" else 2.0
        jt, fn = jax_clip_per_param_norm(1.5, p), lambda gs: clip_per_param_norm(gs, 1.5, p)
    want, _ = jax.jit(jt.update)(tree, jt.init(tree))
    leaves = jax.tree_util.tree_leaves(tree)
    grads = [_t(x.copy()) for x in leaves]
    fn(grads)
    for w, g in zip(jax.tree_util.tree_leaves(want), grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    moved = any(not np.array_equal(g.numpy(), x) for g, x in zip(grads, leaves))
    assert moved == (kind != "full_model_unclipped")


# -- bf16 -------------------------------------------------------------------------


def test_tiny_losses_bf16_match_jax(tiny_run):
    jc = tiny_run["cfg"].clone()
    jc.TPU.COMPUTE_DTYPE = "bfloat16"
    jm = _no_dropout(jax_build_model(jc))
    batch = tiny_run["batch"]
    want = jax.jit(lambda v, b: jm.apply(v, b, train=True, rngs={"dropout": jax.random.key(0),
                                                               "sampling": jax.random.key(0)}))(
        tiny_run["variables"], {k: jnp.asarray(v) for k, v in batch.items()})
    _, model = _port_model(jc, tiny_run["variables"], "bfloat16")
    model.train()
    model.roi_heads.dan.dropout = 0.0
    assert model.roi_heads.dan.dan1.compute_dtype == torch.bfloat16
    with torch.no_grad():
        got = model(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(got) == LOSSES
    for k in LOSSES:
        assert torch.isfinite(got[k]), k
        assert _rel(float(want[k]), got[k].item()) <= BF16_REL[k], (k, float(want[k]), got[k].item())


# measured on the CPU: the refinement branches up to 1.9e-2 (their mined
# PGT and weights follow bf16 scores), the others up to 1.2e-3
BF16_REL = {k: 4e-2 if k.startswith("loss_refine") else 4e-3 for k in LOSSES}
