"""The ops of CSC and WSJDS held against the JAX package on the CPU, from
seeded numpy inputs (float32 on both sides): ``csc_full`` (the CSC weights),
``wsl.ops.csc_constraint``, ``sem_seg_targets_from_cpg``,
``csc_weighted_mil_image_loss``, ``wsl.ops.crf_mean_field``, the ``ASPP``
layer and WSJDS's ``ASPPHead`` (its binary loss, its cross entropy with the
CRF's constraint loss, and its CRF at evaluation).

Tolerances (measured on the CPU in brackets):

* ``csc_full``: within 1e-6 absolute of the JAX weights, which lie in
  [-1, 1] (6.0e-8: XLA divides by the square roots as a product by their
  reciprocal square roots); the rounding half away from zero, the clamps and
  the integral image's sums equal, so every weight's sign agrees;
* ``csc_constraint``: forward and gradient equal;
* ``sem_seg_targets_from_cpg``: targets equal, weights within 1e-7
  relative (0);
* ``csc_weighted_mil_image_loss``: both losses and their gradient in the
  MIL scores within 1e-5 relative (6.1e-7);
* ``crf_mean_field``: within 1e-5 absolute of the JAX probabilities
  (2.4e-7), and the head's CRF at evaluation the same (3.2e-6);
* ``ASPP`` and ``ASPPHead``: outputs, losses and the parameters'
  gradients within 1e-4 of their scale (PR 15's; at most 4.1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.layers import ShapeSpec as JaxShapeSpec
from jtsm_tpu.layers.aspp import ASPP as JaxASPP
from jtsm_tpu.wsl import ops as jax_ops
from jtsm_tpu.wsl.modeling import seg_heads as jax_seg
from jtsm_tpu.wsl.modeling import wsjds as jax_wsjds
from jtsm_tpu.wsl.modeling import wsod_zoo as jax_zoo
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import wsjds_V_16_DC5_cfg
from jtsm_tpu_torch.layers import ASPP, ShapeSpec
from jtsm_tpu_torch.wsl import ops
from jtsm_tpu_torch.wsl.modeling.seg_heads import ASPPHead
from jtsm_tpu_torch.wsl.modeling.wsjds import csc_weighted_mil_image_loss, sem_seg_targets_from_cpg
from jtsm_tpu_torch.wsl.modeling.wsod_zoo import csc_full
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max(initial=0.0) / max(np.abs(want).max(initial=0.0), 1e-30))


def csc_inputs(seed=0, b=2, c=6, h=40, w=56, r=300):
    """Maps with an all-zero class, boxes on integer, half and quarter
    pixels (C round's .5 cases) that cross the map's edges or have no
    extent, padded rows, absent classes and predictions in (0, 1)."""
    rng = np.random.RandomState(seed)
    cpg = rng.rand(b, c, h, w).astype(np.float32) ** 3
    cpg[0, 1] = 0.0
    cpg /= np.maximum(cpg.max(axis=(2, 3), keepdims=True), 1e-20)
    xy = rng.randint(-5, w + 4, (b, r, 2)) + rng.choice([0.0, 0.5, 0.25], (b, r, 2))
    wh = rng.randint(0, 40, (b, r, 2)) + rng.choice([0.0, 0.5], (b, r, 2))
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(b, r) > 0.1
    labels = (rng.rand(b, c) > 0.5).astype(np.float32)
    labels[:, 0] = 1.0
    labels[0, 1] = 1.0  # present, with an all-zero map
    labels[1, 2] = 0.0
    preds = rng.rand(b, c).astype(np.float32)
    return cpg, boxes, valid, labels, preds


_jax_csc = jax.jit(jax.vmap(lambda c, bx, v, lb, p: jax_zoo.csc_full(c, bx, v, lb, p)))


def test_csc_full_matches_jax():
    cpg, boxes, valid, labels, preds = csc_inputs()
    want = np.asarray(_jax_csc(cpg, boxes, valid, labels, preds))
    got = csc_full(*(torch.tensor(a) for a in (cpg, boxes, valid, labels, preds))).numpy()
    err = float(np.abs(want - got).max())
    print("csc_full max_abs_err", err)
    assert err <= 1e-6
    assert np.array_equal(np.sign(want), np.sign(got))
    # the cases are there: both signs in a column, ones for absent classes,
    # padded rows and the all-zero map (whose column blends to 1 - pred + pred)
    assert (want < 0).any() and (want > 0).any()
    assert np.all(want[~valid] == 1.0) and np.all(want[1, :, 2] == 1.0)
    np.testing.assert_allclose(want[0, valid[0], 1], 1.0, atol=1e-6)
    # C round, not half to even: 2.5 -> 3 and -2.5 -> -3
    from jtsm_tpu_torch.wsl.modeling.wsod_zoo import _round_half_away

    assert _round_half_away(torch.tensor([2.5, -2.5, 0.5, 1.49])).tolist() == [3.0, -3.0, 1.0, 1.0]


def test_csc_full_area_form_and_threshold_match_jax():
    cpg, boxes, valid, labels, preds = csc_inputs(seed=1, c=3)
    fn = jax.jit(jax.vmap(lambda c, bx, v, lb, p: jax_zoo.csc_full(c, bx, v, lb, p, 0.3, False, 1.5)))
    want = np.asarray(fn(cpg, boxes, valid, labels, preds))
    got = csc_full(*(torch.tensor(a) for a in (cpg, boxes, valid, labels, preds)), fg_threshold=0.3,
                   area_sqrt=False, context_scale=1.5).numpy()
    assert float(np.abs(want - got).max()) <= 1e-6


def test_csc_constraint_forward_and_gradient_match_jax():
    rng = np.random.RandomState(2)
    x = rng.randn(50, 6).astype(np.float32)
    w = rng.uniform(-1, 1, (50, 6)).astype(np.float32)
    cot = rng.randn(50, 6).astype(np.float32)
    for polar in (True, False):
        want, vjp = jax.vjp(lambda a, b: jax_ops.csc_constraint(a, b, polar), x, w)
        gx, gw = vjp(cot)
        tx, tw = torch.tensor(x, requires_grad=True), torch.tensor(w, requires_grad=True)
        got = ops.csc_constraint(tx, tw, polar)
        got.backward(torch.tensor(cot))
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        np.testing.assert_array_equal(tx.grad.numpy(), np.asarray(gx))
        assert tw.grad is None and not np.asarray(gw).any()


def test_sem_seg_targets_match_jax():
    cpg, _, _, labels, _ = csc_inputs(seed=3)
    want_t, want_w = jax.vmap(lambda c, lb: jax_wsjds.sem_seg_targets_from_cpg(c, lb, 0.7, 0.1))(cpg, labels)
    got_t, got_w = sem_seg_targets_from_cpg(torch.tensor(cpg), torch.tensor(labels), 0.7, 0.1)
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    assert _rel(want_w, got_w.numpy()) <= 1e-7
    assert np.asarray(want_t).any() and not np.asarray(want_w)[0, 1].any()  # the zero map is ignored


@pytest.mark.parametrize("mean_loss", [True, False])
def test_csc_weighted_mil_loss_and_gradient_match_jax(mean_loss):
    cpg, boxes, valid, labels, _ = csc_inputs(seed=4)
    b, r = valid.shape
    c = labels.shape[1]
    rng = np.random.RandomState(5)
    # WSDDN-like scores: the class softmax times the softmax over the rows,
    # class 0's logits (present in both images) raised by 4 so that its image
    # scores pass 0.5, below which no CSC weight can be negative (W = p * n +
    # 1 - p with n >= -1)
    logits = rng.randn(b, r, c).astype(np.float32)
    logits[..., 0] += 4.0
    det = np.where(valid[..., None], rng.randn(b, r, c), -np.inf)
    mil = (np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
           * np.exp(det) / np.exp(det).sum(1, keepdims=True)).astype(np.float32)

    def jax_loss(m):
        pos, neg = jax.vmap(lambda m_, bx, v, lb, cg: jax_wsjds.csc_weighted_mil_image_loss(
            m_, bx, v, lb, cg, c, 0.1, mean_loss))(m, boxes, valid, labels, cpg)
        return pos.mean() + 3.0 * neg.mean(), (pos, neg)

    (_, (want_pos, want_neg)), want_g = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(mil)
    tm = torch.tensor(mil, requires_grad=True)
    pos, neg = csc_weighted_mil_image_loss(tm, torch.tensor(boxes), torch.tensor(valid), torch.tensor(labels),
                                           torch.tensor(cpg), 0.1, mean_loss)
    (pos.mean() + 3.0 * neg.mean()).backward()
    errs = [_rel(want_pos, pos.detach().numpy()), _rel(want_neg, neg.detach().numpy()), _rel(want_g, tm.grad.numpy())]
    print("csc loss rel errs", errs, float(np.asarray(want_neg).min()))
    assert max(errs) <= 1e-5
    assert float(np.asarray(want_neg).min()) > 1e-6  # negative weights: loss_cls_neg above its 1e-20 clip


def test_crf_mean_field_matches_jax():
    rng = np.random.RandomState(6)
    logits = rng.randn(2, 24, 30, 5).astype(np.float32) * 2
    unary = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    image = (rng.rand(2, 24, 30, 3) * 255).astype(np.float32)
    image[1, :, :15] *= 0.2  # two regions of luminance
    want = np.asarray(jax.jit(jax.vmap(jax_ops.crf_mean_field))(unary, image))
    got = ops.crf_mean_field(torch.tensor(unary), torch.tensor(image)).numpy()
    err = float(np.abs(want - got).max())
    print("crf max_abs_err", err)
    assert err <= 1e-5
    assert float(np.abs(want - unary).max()) > 0.1  # the refinement moves the probabilities


def _grads_close(want_grads, module, tol=1e-4):
    want = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want.values())
    worst = 0.0
    for name, p in module.named_parameters():
        w = want[name].numpy()
        err = np.linalg.norm(w - p.grad.numpy()) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= tol, (name, err)
    return worst


@pytest.mark.parametrize("norm", ["", "GN"])
def test_aspp_matches_jax(norm):
    rng = np.random.RandomState(7)
    x = rng.randn(2, 12, 14, 32).astype(np.float32)
    jm = JaxASPP(in_channels=32, out_channels=32, norm=norm)
    variables = _random_variables(jm, jnp.asarray(x))

    def run(params):
        y = jm.apply({"params": params}, x)
        return (y * jnp.cos(y)).sum(), y

    (_, want), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(variables["params"])
    tm = ASPP(32, 32, norm=norm)
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    y = tm(torch.tensor(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    (y * torch.cos(y)).sum().backward()
    assert _rel(want, y.detach().numpy()) <= 1e-4
    print("aspp", norm, _grads_close(grads, tm))


def _aspp_head_cfg(mask_softmax=False):
    cfg = wsjds_V_16_DC5_cfg(narrow=True, crf=True)
    cfg.MODEL.SEM_SEG_HEAD.ASSP_CONVS_DIM = 32
    cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 5
    cfg.MODEL.SEM_SEG_HEAD.MASK_SOFTMAX = mask_softmax
    return cfg


@pytest.mark.parametrize("mask_softmax", [False, True])
def test_aspp_head_losses_and_crf_match_jax(mask_softmax):
    """The binary loss of WSJDS's targets at the image's size, the cross
    entropy of integer targets with the CRF's constraint loss, and the CRF
    at evaluation, with the gradients of the first two."""
    cfg = _aspp_head_cfg(mask_softmax)
    shapes = {"plain5": ShapeSpec(channels=32, stride=8)}
    jm = jax_seg.ASPPHead(**jax_seg.ASPPHead.from_config(_jax_cfg(cfg), {"plain5": JaxShapeSpec(32, stride=8)}))
    rng = np.random.RandomState(8)
    feat = rng.randn(2, 10, 12, 32).astype(np.float32)
    images = (rng.rand(2, 80, 96, 3) * 255).astype(np.float32)
    k = 5 + int(mask_softmax)
    cpg = rng.rand(2, 5, 80, 96).astype(np.float32)
    labels = np.array([[1, 0, 1, 0, 0], [0, 1, 0, 0, 1]], np.float32)
    bt, bw = jax.vmap(lambda c, lb: jax_wsjds.sem_seg_targets_from_cpg(c, lb))(cpg, labels)
    bt, bw = np.asarray(bt), np.asarray(bw)
    sem = rng.randint(0, 5, (2, 80, 96)).astype(np.int32)
    sem[:, :8] = 255
    variables = _random_variables(jm, {"plain5": jnp.asarray(feat)})
    variables = jax.tree_util.tree_map_with_path(  # logits of a few units, where the CRF and the losses bite
        lambda path, a: a * 1000.0 if "predictor" in str(path) and "kernel" in str(path) else a, variables)

    def run(params):
        v = {"params": params}
        _, bin_l = jm.apply(v, {"plain5": feat}, None, train=True, binary_targets=bt, binary_weights=bw)
        logits, ce_l = jm.apply(v, {"plain5": feat}, sem, train=True, targets_stride=1, images=jnp.asarray(images))
        return bin_l["loss_sem_seg"] + ce_l["loss_sem_seg"] + ce_l["loss_constraint"], (bin_l, ce_l, logits)

    (_, (bin_l, ce_l, logits)), grads = jax.jit(jax.value_and_grad(run, has_aux=True))(variables["params"])
    crf_logits, _ = jax.jit(lambda v: jm.apply(v, {"plain5": feat}, None, train=False, images=jnp.asarray(images)))(
        variables)
    head = ASPPHead(cfg, shapes)
    state = {k_[len("sem_seg_head."):] if k_.startswith("sem_seg_head.") else k_: v_
             for k_, v_ in variables_to_state_dict(variables).items()}
    head.load_state_dict(state, strict=True)
    head.train()
    tf = {"plain5": torch.tensor(feat).permute(0, 3, 1, 2)}
    got_logits = head(tf)
    got_bin = head.binary_losses(got_logits, torch.tensor(bt), torch.tensor(bw))
    got_ce = head.losses(got_logits, torch.tensor(sem), 1, torch.tensor(images))
    (got_bin["loss_sem_seg"] + got_ce["loss_sem_seg"] + got_ce["loss_constraint"]).backward()
    assert got_logits.shape == (2, k, 10, 12)
    assert _rel(np.asarray(logits), got_logits.detach().permute(0, 2, 3, 1).numpy()) <= 1e-4
    errs = {name: _rel(float(w), g.item()) for name, w, g in (
        ("binary", bin_l["loss_sem_seg"], got_bin["loss_sem_seg"]), ("ce", ce_l["loss_sem_seg"], got_ce["loss_sem_seg"]),
        ("constraint", ce_l["loss_constraint"], got_ce["loss_constraint"]))}
    print("aspp head losses", errs, {k_: float(v_) for k_, v_ in ce_l.items()})
    assert max(errs.values()) <= 1e-4 and float(ce_l["loss_constraint"]) > 1e-3
    print("aspp head gradients", _grads_close(grads, head))
    head.eval()
    with torch.no_grad():
        got_crf = head(tf, torch.tensor(images)).permute(0, 2, 3, 1).numpy()
    crf_err = float(np.abs(np.exp(np.asarray(crf_logits)) - np.exp(got_crf)).max())
    print("aspp head crf max_abs_err (probabilities)", crf_err)
    assert crf_err <= 1e-5


def test_csc_loss_is_nan_where_a_present_class_saturates_on_both_sides():
    """The CSC loss clips its image scores to [1e-20, 1 - 1e-20], and
    1 - 1e-20 is 1 in float32: where a present class's score reaches 1,
    ``(1 - 1) * log1p(-1)`` is 0 * -inf, and ``loss_cls_pos`` is NaN in
    both packages (ROADMAP §3)."""
    _, boxes, valid, labels, _ = csc_inputs(seed=9, c=3)
    cpg = np.zeros((2, 3, 40, 56), np.float32)  # zero maps: every CSC weight 1 (as under FREEZE_AT 5)
    valid[:, 0] = True
    mil = np.zeros(valid.shape + (3,), np.float32)
    mil[:, 0, 0] = 1.0  # class 0, present in both images, scores 1
    pos, neg = jax.vmap(lambda m, bx, v, lb, cg: jax_wsjds.csc_weighted_mil_image_loss(m, bx, v, lb, cg, 3))(
        mil, boxes, valid, labels, cpg)
    got_pos, got_neg = csc_weighted_mil_image_loss(torch.tensor(mil), torch.tensor(boxes), torch.tensor(valid),
                                                   torch.tensor(labels), torch.tensor(cpg))
    assert np.isnan(np.asarray(pos)).all() and torch.isnan(got_pos).all()
    np.testing.assert_allclose(got_neg.numpy(), np.asarray(neg), rtol=1e-5)
