"""The port's training ops held against the JAX package on the CPU, on the
same numpy inputs: the plain ROIAlign backward (what the CUDA kernel K2 is
held against on the card), the matcher, the samplers, the losses, the mask
targets, the learning-rate schedules and the SGD update.

Random draws: ``jax.random`` and ``torch.Generator`` give different
numbers, so each sampling case computes the JAX package's own uniform
draws from its key and hands them to the port as ``u``; masks and sampled
slots must then be equal.

Tolerances: selections, labels and masks exact. Float results are float32
on both sides (JAX matmul precision "highest"): the ROIAlign backward to
2e-5 of the gradient's scale (sums in another order), losses and targets
to 1e-5 of their scale, the schedules to 1e-6 relative (the JAX package
computes them in float32, the port in float64), the SGD trajectory to 1e-6
of each parameter's scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.layers import ShapeSpec as JaxShapeSpec
from jtsm_tpu.modeling.proposal_generator.rpn import RPN as JaxRPN
from jtsm_tpu.modeling.roi_heads import fast_rcnn as jax_fast_rcnn
from jtsm_tpu.modeling.roi_heads import mask_head as jax_mask_head
from jtsm_tpu.modeling.roi_heads.proposal_sampling import sample_proposals_single
from jtsm_tpu.ops import matcher as jax_matcher
from jtsm_tpu.ops import sampling as jax_sampling
from jtsm_tpu.ops.box_regression import Box2BoxTransform as JaxBox2BoxTransform
from jtsm_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from jtsm_tpu.solver import build as jax_solver
from jtsm_tpu.structures.masks import crop_and_resize_masks as jax_crop_and_resize
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.layers import ShapeSpec
from jtsm_tpu_torch.modeling.proposal_generator.rpn import RPN
from jtsm_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_losses
from jtsm_tpu_torch.modeling.roi_heads.mask_head import mask_rcnn_loss, mask_targets_from_crops
from jtsm_tpu_torch.modeling.roi_heads.proposal_sampling import sample_proposals
from jtsm_tpu_torch.ops import roi_align
from jtsm_tpu_torch.ops.box_regression import Box2BoxTransform
from jtsm_tpu_torch.ops.matcher import Matcher
from jtsm_tpu_torch.ops.sampling import subsample_labels
from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer
from jtsm_tpu_torch.structures.masks import crop_and_resize_masks
from tests.modeling.test_meta_archs import _fpn_tiny
from tests.test_torch_ops import _pyramid, _random_boxes, _roi_cases


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(a, b, rel):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------- ROIAlign backward

_SCALES = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
_HW = [(32, 48), (16, 24), (8, 12), (4, 6)]


def _backward_case(seed, p):
    """Two images, four levels, 60 ROIs: at the adaptive cap, across both
    borders, wholly outside, empty, and ten tiny ROIs on one cell."""
    rng = np.random.RandomState(seed)
    feats = _pyramid(rng, 2, 16, _HW)
    r = 70
    b = np.concatenate([_roi_cases(rng, 60, (128, 192)), np.tile([[40, 40, 41.5, 41.5]], (10, 1))])
    b = b.astype(np.float32)
    levels = rng.randint(0, 4, r).astype(np.int32)
    levels[60:] = 0
    bidx = rng.randint(0, 2, r).astype(np.int32)
    bidx[60:] = 1
    grad = rng.randn(r, p, p, 16).astype(np.float32)
    return feats, b, bidx, levels, grad


@pytest.mark.parametrize(
    "sampling_ratio,aligned,output_size",
    [(0, True, 7), (0, True, 14), (2, True, 7), (0, False, 7)],
)
def test_roi_align_backward_plain_matches_jax_vjp(sampling_ratio, aligned, output_size):
    feats, b, bidx, levels, grad = _backward_case(21, output_size)
    _, vjp = jax.vjp(
        lambda fs: jax_roi_align_multilevel(
            tuple(fs), _SCALES, jnp.asarray(b), jnp.asarray(bidx), jnp.asarray(levels),
            output_size, sampling_ratio, aligned,
        ),
        [jnp.asarray(f) for f in feats],
    )
    (want,) = vjp(jnp.asarray(grad))
    got = roi_align.roi_align_multilevel_backward_plain(
        _t(grad), [f.shape for f in feats], _SCALES, _t(b), _t(bidx), _t(levels),
        output_size, sampling_ratio, aligned,
    )
    assert len(got) == 4
    for g, w, f in zip(got, want, feats):
        assert g.shape == f.shape and g.dtype == torch.float32 and g.is_contiguous()
        assert np.abs(np.asarray(w)).max() > 0  # every level receives gradient
        _close(w, g.numpy(), 2e-5)


@pytest.mark.parametrize("output_size", [7, 14])
def test_roi_align_backward_plain_matches_autograd(output_size):
    """The explicit scatter equals autograd through the plain forward, and
    the differentiable entry point on the CPU runs it."""
    feats, b, bidx, levels, grad = _backward_case(22, output_size)
    leaves = [_t(f).requires_grad_() for f in feats]
    out = roi_align.roi_align_multilevel_plain(leaves, _SCALES, _t(b), _t(bidx), _t(levels), output_size)
    out.backward(_t(grad))
    got = roi_align.roi_align_multilevel_backward_plain(
        _t(grad), [f.shape for f in feats], _SCALES, _t(b), _t(bidx), _t(levels), output_size
    )
    leaves2 = [_t(f).requires_grad_() for f in feats]
    out2 = roi_align.roi_align_multilevel(leaves2, _SCALES, _t(b), _t(bidx), _t(levels), output_size)
    torch.testing.assert_close(out2, out, rtol=0, atol=0)
    out2.backward(_t(grad))
    for g, a, c in zip(got, leaves, leaves2):
        _close(a.grad.numpy(), g.numpy(), 2e-5)
        np.testing.assert_array_equal(c.grad.numpy(), g.numpy())


def test_roi_align_backward_plain_bfloat16_sums_in_float32():
    feats, b, bidx, levels, grad = _backward_case(23, 7)
    g16 = _t(grad).to(torch.bfloat16)
    args = ([f.shape for f in feats], _SCALES, _t(b), _t(bidx), _t(levels), 7)
    got = roi_align.roi_align_multilevel_backward_plain(g16, *args)
    want = roi_align.roi_align_multilevel_backward_plain(g16.float(), *args)
    for g, w in zip(got, want):
        assert g.dtype == torch.bfloat16
        torch.testing.assert_close(g, w.to(torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------- matcher

def _match_quality(rng, m, n):
    q = rng.rand(m, n).astype(np.float32)
    q[q < 0.4] = 0.0  # many predictions touch no ground truth
    q[0, :5] = q[1, :5] = 0.65  # ties between rows: the first wins
    q[2, 10:14] = q[2, 10]  # one row's best shared by several predictions
    return q


@pytest.mark.parametrize(
    "thresholds,labels,low_quality",
    [([0.3, 0.7], [0, -1, 1], True), ([0.5], [0, 1], False), ([0.4, 0.5], [0, -1, 1], True)],
)
def test_matcher_matches_jax(thresholds, labels, low_quality):
    rng = np.random.RandomState(31)
    b, m, n = 3, 6, 80
    q = np.stack([_match_quality(rng, m, n) for _ in range(b)])
    valid = np.ones((b, m), bool)
    valid[0, -2:] = False  # padded ground truth rows
    valid[2, :] = False  # an image without ground truth
    jm = jax_matcher.Matcher(thresholds, labels, low_quality)
    got_idx, got_lbl = Matcher(thresholds, labels, low_quality)(_t(q), _t(valid))
    assert got_lbl.dtype == torch.int8
    for i in range(b):
        want_idx, want_lbl = jm(jnp.asarray(q[i]), jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(want_idx))
        np.testing.assert_array_equal(got_lbl[i].numpy(), np.asarray(want_lbl))
    assert (got_lbl[2] == labels[0]).all()


# ---------------------------------------------------------------- sampling

def _jax_uniform_pair(key, n):
    k_pos, k_neg = jax.random.split(key)
    return np.asarray(jax.random.uniform(k_pos, (n,))), np.asarray(jax.random.uniform(k_neg, (n,)))


@pytest.mark.parametrize("num_samples,fraction", [(64, 0.25), (256, 0.5), (400, 1.0), (16, 0.0)])
def test_subsample_labels_matches_jax_with_its_uniforms(num_samples, fraction):
    rng = np.random.RandomState(num_samples)
    n = 300
    labels = rng.choice([-1, 0, 1, 3], size=n, p=[0.3, 0.5, 0.1, 0.1]).astype(np.int32)
    key = jax.random.key(num_samples)
    want_pos, want_neg = jax_sampling.subsample_labels(key, jnp.asarray(labels), num_samples, fraction, 0)
    u_pos, u_neg = _jax_uniform_pair(key, n)
    got_pos, got_neg = subsample_labels(_t(labels), num_samples, fraction, 0, _t(u_pos), _t(u_neg))
    np.testing.assert_array_equal(got_pos.numpy(), np.asarray(want_pos))
    np.testing.assert_array_equal(got_neg.numpy(), np.asarray(want_neg))
    assert got_pos.sum() + got_neg.sum() == min(num_samples, int((labels != -1).sum()))


def _proposal_case(rng, b, k, g):
    gt = _random_boxes(rng, b * g, extent=120, size=50).reshape(b, g, 4)
    props = np.concatenate(
        [gt[:, rng.randint(0, g, k // 2)] + rng.randn(b, k // 2, 4).astype(np.float32) * 4,
         _random_boxes(rng, b * (k - k // 2), extent=150, size=60).reshape(b, -1, 4)], axis=1
    ).astype(np.float32)
    scores = rng.randn(b, k).astype(np.float32)
    scores[:, -7:] = -np.inf  # padding
    classes = rng.randint(0, 5, (b, g)).astype(np.int32)
    valid = np.ones((b, g), bool)
    valid[1, -2:] = False
    return props, scores, gt, classes, valid


@pytest.mark.parametrize("batch_size,fraction,append_gt", [(64, 0.25, True), (48, 0.5, False)])
def test_sample_proposals_matches_jax_with_its_uniforms(batch_size, fraction, append_gt):
    rng = np.random.RandomState(41)
    b, k, g = 2, 90, 6
    props, scores, gt, classes, valid = _proposal_case(rng, b, k, g)
    n = k + g if append_gt else k
    kw = dict(num_classes=5, batch_size_per_image=batch_size, positive_fraction=fraction,
              append_gt=append_gt)
    jm = jax_matcher.Matcher([0.5], [0, 1], False)
    keys = jax.random.split(jax.random.key(5), b)
    us, wants = [], []
    for i in range(b):
        wants.append(sample_proposals_single(
            keys[i], jnp.asarray(props[i]), jnp.asarray(scores[i]), jnp.asarray(gt[i]),
            jnp.asarray(classes[i]), jnp.asarray(valid[i]), matcher=jm, **kw,
        ))
        rng_sub, rng_tie = jax.random.split(keys[i])
        us.append((*_jax_uniform_pair(rng_sub, n), np.asarray(jax.random.uniform(rng_tie, (n,)))))
    u_pos, u_neg, u_tie = (_t(np.stack([u[j] for u in us])) for j in range(3))
    got = sample_proposals(
        _t(props), _t(scores), _t(gt), _t(classes), _t(valid), u_pos, u_neg, u_tie,
        matcher=Matcher([0.5], [0, 1], False), **kw,
    )
    for i in range(b):
        for key in ("boxes", "gt_classes", "gt_boxes", "matched_idx", "valid", "fg"):
            np.testing.assert_array_equal(got[key][i].numpy(), np.asarray(wants[i][key]), err_msg=key)
    assert got["fg"].any() and got["valid"].any()


# ---------------------------------------------------------------- RPN losses

@pytest.mark.parametrize("boundary_thresh", [-1, 0])
def test_rpn_losses_match_jax(boundary_thresh):
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.RPN.BOUNDARY_THRESH = boundary_thresh
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 64
    jrpn = JaxRPN(**JaxRPN.from_config(
        cfg, {f"p{i}": JaxShapeSpec(channels=64, stride=2**i) for i in range(2, 7)}
    ))
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    trpn = RPN(tcfg, {f"p{i}": ShapeSpec(channels=64, stride=2**i) for i in range(2, 7)})
    rng = np.random.RandomState(51)
    b, n, g = 2, 500, 5
    anchors = _random_boxes(rng, n, extent=110, size=60) - 10
    logits = rng.randn(b, n).astype(np.float32) * 2
    deltas = rng.randn(b, n, 4).astype(np.float32) * 0.3
    gt = _random_boxes(rng, b * g, extent=80, size=40).reshape(b, g, 4)
    valid = np.ones((b, g), bool)
    valid[0, -1] = False
    sizes = np.array([[100, 90], [96, 100]], np.int32)
    key = jax.random.key(7)
    want = jrpn._losses(key, jnp.asarray(anchors), jnp.asarray(logits), jnp.asarray(deltas),
                        jnp.asarray(gt), jnp.asarray(valid), jnp.asarray(sizes))
    u = [_jax_uniform_pair(k, n) for k in jax.random.split(key, b)]
    got = trpn.losses(_t(anchors), _t(logits), _t(deltas), _t(gt), _t(valid), _t(sizes),
                      _t(np.stack([x[0] for x in u])), _t(np.stack([x[1] for x in u])))
    assert sorted(got) == sorted(want) == ["loss_rpn_cls", "loss_rpn_loc"]
    for k in want:
        assert float(want[k]) > 0
        _close(want[k], got[k].numpy(), 1e-5)


# ---------------------------------------------------------------- Fast R-CNN and mask losses

@pytest.mark.parametrize("agnostic,beta", [(False, 0.0), (True, 0.5)])
def test_fast_rcnn_losses_match_jax(agnostic, beta):
    rng = np.random.RandomState(61)
    n, k = 80, 5
    scores = rng.randn(n, k + 1).astype(np.float32) * 3
    deltas = rng.randn(n, 4 if agnostic else 4 * k).astype(np.float32)
    props = _random_boxes(rng, n)
    gt = props + rng.randn(n, 4).astype(np.float32) * 3
    classes = rng.randint(0, k + 1, n).astype(np.int32)  # k is background
    valid = rng.rand(n) > 0.2
    weights = (10.0, 10.0, 5.0, 5.0)
    want = jax_fast_rcnn.fast_rcnn_losses(
        jnp.asarray(scores), jnp.asarray(deltas), jnp.asarray(props), jnp.asarray(classes),
        jnp.asarray(gt), jnp.asarray(valid), JaxBox2BoxTransform(weights), k, beta,
    )
    got = fast_rcnn_losses(_t(scores), _t(deltas), _t(props), _t(classes), _t(gt), _t(valid),
                           Box2BoxTransform(weights), k, beta)
    for key in ("loss_cls", "loss_box_reg"):
        assert float(want[key]) > 0
        _close(want[key], got[key].numpy(), 1e-5)


def test_crop_and_resize_masks_matches_jax():
    rng = np.random.RandomState(71)
    masks = (rng.rand(12, 40, 36) > 0.5).astype(np.float32)
    boxes = np.concatenate([rng.rand(12, 2) * 30 - 5, rng.rand(12, 2) * 30 + 10], 1).astype(np.float32)
    boxes[:, 2:] += boxes[:, :2]
    want = jax_crop_and_resize(jnp.asarray(masks), jnp.asarray(boxes), 28)
    got = crop_and_resize_masks(_t(masks), _t(boxes), 28)
    assert got.shape == (12, 28, 28)
    _close(want, got.numpy(), 1e-5)


def test_mask_targets_and_loss_match_jax():
    rng = np.random.RandomState(72)
    b, g, n, m, s, k = 2, 5, 24, 56, 28, 4
    crops = rng.rand(b, g, m, m) > 0.5
    gt = _random_boxes(rng, b * g, extent=100, size=50).reshape(b, g, 4)
    matched = rng.randint(0, g, (b, n)).astype(np.int32)
    props = np.take_along_axis(gt, matched[..., None].astype(np.int64), 1)
    props = (props + rng.randn(b, n, 4) * 5).astype(np.float32)
    want_t = np.stack([
        np.asarray(jax_mask_head.mask_targets_from_crops(
            jnp.asarray(crops[i]), jnp.asarray(gt[i]), jnp.asarray(matched[i]), jnp.asarray(props[i]), s
        )) for i in range(b)
    ])
    got_t = mask_targets_from_crops(_t(crops), _t(gt), _t(matched), _t(props), s)
    _close(want_t, got_t.numpy(), 1e-5)

    logits = rng.randn(b * n, k, s, s).astype(np.float32) * 2  # the port's (N, K, S, S)
    classes = rng.randint(0, k, b * n).astype(np.int32)
    fg = rng.rand(b * n) > 0.3
    targets = want_t.reshape(b * n, s, s)
    want = jax_mask_head.mask_rcnn_loss(
        jnp.asarray(logits.transpose(0, 2, 3, 1)), jnp.asarray(classes), jnp.asarray(targets), jnp.asarray(fg)
    )
    got = mask_rcnn_loss(_t(logits), _t(classes), _t(targets), _t(fg))
    _close(want, got.numpy(), 1e-5)


# ---------------------------------------------------------------- solver

@pytest.mark.parametrize(
    "name,method", [("WarmupMultiStepLR", "linear"), ("WarmupMultiStepLR", "constant"), ("WarmupCosineLR", "linear")]
)
def test_lr_schedule_matches_jax(name, method):
    cfg = jax_get_cfg()
    cfg.SOLVER.LR_SCHEDULER_NAME = name
    cfg.SOLVER.WARMUP_METHOD = method
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.WARMUP_ITERS = 100
    cfg.SOLVER.STEPS = (300, 500)
    cfg.SOLVER.MAX_ITER = 600
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    want, got = jax_solver.build_lr_schedule(cfg), build_lr_schedule(tcfg)
    for step in (0, 1, 50, 99, 100, 101, 299, 300, 499, 500, 600, 700):
        np.testing.assert_allclose(got(step), float(want(jnp.asarray(step))), rtol=1e-6, err_msg=str(step))
    assert got(0) == pytest.approx(0.02 * 0.001)


class _Toy(torch.nn.Module):
    """A parameter tree with each of the three groups: ``block`` (regular
    weight and a bias) and ``out_norm`` (a norm's scale and shift)."""

    def __init__(self, w, b, scale, shift):
        super().__init__()
        self.block = torch.nn.Linear(w.shape[1], w.shape[0])
        self.out_norm = torch.nn.LayerNorm(scale.shape[0])
        with torch.no_grad():
            self.block.weight.copy_(_t(w))
            self.block.bias.copy_(_t(b))
            self.out_norm.weight.copy_(_t(scale))
            self.out_norm.bias.copy_(_t(shift))


@pytest.mark.parametrize("nesterov", [False, True])
def test_sgd_three_steps_match_the_optax_chain(nesterov):
    """Three updates of a toy tree, with the schedule's warmup and a
    milestone, against ``jtsm_tpu.solver.build_optimizer``. The bias group
    keeps the default BIAS_LR_FACTOR and WEIGHT_DECAY_BIAS: the JAX
    package's label function never finds a bias (it compares the str of a
    path key, "['bias']", with "bias"), so only at the defaults, where the
    bias group equals the regular one, do the two agree."""
    rng = np.random.RandomState(81)
    w, b = rng.randn(6, 5).astype(np.float32), rng.randn(6).astype(np.float32)
    scale, shift = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
    cfg = jax_get_cfg()
    s = cfg.SOLVER
    s.BASE_LR, s.WARMUP_ITERS, s.STEPS, s.NESTEROV = 0.1, 2, (2,), nesterov
    s.WEIGHT_DECAY, s.WEIGHT_DECAY_BIAS, s.WEIGHT_DECAY_NORM = 0.01, 0.01, 0.003
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)

    # the JAX package's tree: (in, out) kernels, flax names
    params = {"block": {"kernel": jnp.asarray(w.T), "bias": jnp.asarray(b)},
              "out_norm": {"scale": jnp.asarray(scale), "bias": jnp.asarray(shift)}}
    tx = jax_solver.build_optimizer(cfg, params)
    opt_state = tx.init(params)
    toy = _Toy(w, b, scale, shift)
    opt = build_optimizer(tcfg, toy)
    groups = {gr["label"]: gr for gr in opt.param_groups}
    assert sorted(groups) == ["bias", "norm", "regular"]
    assert groups["norm"]["weight_decay"] == 0.003 and groups["bias"]["lr_factor"] == 1.0
    schedule = build_lr_schedule(tcfg)
    for step in range(3):
        gw, gb = rng.randn(6, 5).astype(np.float32), rng.randn(6).astype(np.float32)
        gs, gh = rng.randn(6).astype(np.float32), rng.randn(6).astype(np.float32)
        grads = {"block": {"kernel": jnp.asarray(gw.T), "bias": jnp.asarray(gb)},
                 "out_norm": {"scale": jnp.asarray(gs), "bias": jnp.asarray(gh)}}
        updates, opt_state = tx.update(grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)
        for p, g in ((toy.block.weight, gw), (toy.block.bias, gb), (toy.out_norm.weight, gs),
                     (toy.out_norm.bias, gh)):
            p.grad = _t(g)
        for group in opt.param_groups:
            group["lr"] = schedule(step) * group["lr_factor"]
        opt.step()
    for got, want in ((toy.block.weight, params["block"]["kernel"].T), (toy.block.bias, params["block"]["bias"]),
                      (toy.out_norm.weight, params["out_norm"]["scale"]),
                      (toy.out_norm.bias, params["out_norm"]["bias"])):
        _close(want, got.detach().numpy(), 1e-6)


def test_optimizer_groups_follow_the_config():
    cfg = get_cfg()
    cfg.SOLVER.BIAS_LR_FACTOR, cfg.SOLVER.WEIGHT_DECAY_BIAS = 2.0, 0.0
    rng = np.random.RandomState(82)
    toy = _Toy(*(rng.randn(*shape).astype(np.float32) for shape in ((3, 2), (3,), (3,), (3,))))
    groups = {gr["label"]: gr for gr in build_optimizer(cfg, toy).param_groups}
    assert [len(groups[k]["params"]) for k in ("regular", "bias", "norm")] == [1, 1, 2]
    assert (groups["bias"]["lr_factor"], groups["bias"]["weight_decay"]) == (2.0, 0.0)
    assert groups["regular"]["weight_decay"] == cfg.SOLVER.WEIGHT_DECAY
    assert build_optimizer(cfg, toy).clip is None
    # the clip types are ported: each builds an in-place clip, any other
    # type raises
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    for kind in ("value", "full_model", "norm"):
        cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = kind
        assert callable(build_optimizer(cfg, toy).clip)
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "agc"
    with pytest.raises(ValueError):
        build_optimizer(cfg, toy)
