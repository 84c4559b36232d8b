"""``TPU.COMPUTE_DTYPE`` in the port, held against the JAX package on the CPU.

With ``bfloat16`` both sides keep float32 parameters and compute in bf16.
The tiny FPN Mask R-CNN (``_fpn_tiny`` with MASK_ON) runs on each side from
the same weights, carried across by ``variables_to_state_dict``, on the same
numpy inputs. The two frameworks round at other places (XLA's CPU
convolutions and matrix products against PyTorch's, a bias added after the
rounded product in the JAX layers and inside the product in PyTorch's), so
each check states its tolerance beside the largest gap measured on the CPU
(max abs difference over the largest magnitude of the JAX side; 2^-7 is
one bf16 step in the value's binade):

==========================================  =========  =========
check                                       measured   tolerance
==========================================  =========  =========
backbone + FPN maps p2-p6                   9.5e-3     2e-2
RPN head logits and deltas                  0          2^-7
box head + predictor scores and deltas      0          2^-7
mask head logits                            2.0e-3     2^-7
multilevel ROIAlign, bf16 features          9.3e-3     2e-2
train step losses (relative)                1.4e-2     3e-2
==========================================  =========  =========

Gradients are compared by their normwise gap ||port - JAX|| / ||JAX||, which
one cancelling entry cannot dominate, against JAX's bf16 step, and read two
ways:

- each of six gradients (FPN lateral, RPN conv, box fc1, box predictor,
  mask predictor, res3 conv) within 1.5e-1; measured 9.1e-3 to 1.08e-1
  (the mask predictor), and the same step in float32 (the port's, which the
  float32 tests hold to JAX's float32 step) lies 1.0e-2 to 2.4e-1 from it;
- nearer JAX's bf16 gradients than the float32 ones are: for at least 3/4
  of the parameters (measured 41 of 49), and for the box predictor's deltas
  at under 1/4 of the float32 gap (measured 1.65e-2 against 2.39e-1). A
  port computing in float32 would fail both.

Every loss takes its logits and deltas in float32 (checked on the inputs
of each loss function), and every conv and linear layer computes in bf16.

ROIAlign: the JAX formulation interpolates and sums in bf16
(``jtsm_tpu/ops/roi_align.py:155-174``); the port (and its kernel K1) sums
in float32 and rounds once, so the port is the closer of the two to the
exact value and the gap is the JAX side's rounding.

The train step's losses and gradients pass through proposal selection
(top-k and NMS on bf16-rounded logits), where near-ties can flip; the
configuration is the deterministic one of ``test_torch_train_step.py``, and
the losses are sums over slots, so a flipped proposal moves them by a
little, not rank for rank. Final detections are not compared in bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.ops.roi_align import roi_align_multilevel as jax_roi_align_multilevel
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.engine import create_train_state, make_train_step
from jtsm_tpu_torch.layers import Conv2d, ConvTranspose2d, Linear
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.proposal_generator import rpn as rpn_module
from jtsm_tpu_torch.modeling.roi_heads import mask_head as mask_head_module
from jtsm_tpu_torch.modeling.roi_heads import roi_heads as roi_heads_module
from jtsm_tpu_torch.ops import roi_align
from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer
from tests.modeling.test_meta_archs import _batch, _fpn_tiny


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

BF16_STEP = 2.0**-7
TOL_FPN = 2e-2
TOL_RPN = BF16_STEP
TOL_BOX = BF16_STEP
TOL_MASK = BF16_STEP
TOL_ROI = 2e-2
TOL_LOSS = 3e-2
TOL_GRAD = 1.5e-1
TOL_NEARER = 0.75
TOL_BBOX_VS_F32 = 0.25
GRAD_CHECKED = (
    "backbone.fpn_lateral3.weight",
    "proposal_generator.rpn_head.conv.weight",
    "roi_heads.box_head.fc1.weight",
    "roi_heads.box_predictor.bbox_pred.weight",
    "roi_heads.mask_head.predictor.weight",
    "backbone.bottom_up.res3.0.conv1.weight",
)
LOSSES = ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"]


def _gap(want, got):
    """Max abs difference over the largest magnitude of ``want``."""
    want = np.asarray(jnp.asarray(want, jnp.float32), np.float64)
    got = np.asarray(got.float() if isinstance(got, torch.Tensor) else got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    assert np.isfinite(got).all() and np.isfinite(want).all()
    return float(np.abs(want - got).max() / np.abs(want).max())


def _cfg(dtype="bfloat16"):
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.MASK_ON = True
    cfg.TPU.COMPUTE_DTYPE = dtype
    # the deterministic sampling of test_torch_train_step.py
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 1024
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 36
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    return cfg


def _torch_model(cfg, variables):
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    model = build_model(tcfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return tcfg, model


@pytest.fixture(scope="module")
def pair():
    """The JAX model in bf16, its variables (float32) and the port's model
    with them, built from the same config."""
    cfg = _cfg()
    batch = {k: np.array(v) for k, v in _batch(masks=True).items()}
    jm = jax_build_model(cfg)
    variables = jax.jit(lambda k: jm.init({"params": k, "sampling": k}, batch, train=True))(
        jax.random.key(0)
    )
    variables = jax.tree_util.tree_map(np.asarray, variables)
    tcfg, tm = _torch_model(cfg, variables)
    return dict(cfg=cfg, tcfg=tcfg, batch=batch, jm=jm, variables=variables, tm=tm)


def _apply(pair, fn, *args):
    with jax.default_matmul_precision("highest"):
        return jax.jit(lambda v, *a: pair["jm"].apply(v, *a, method=fn))(pair["variables"], *args)


def test_bf16_parameters_stay_float32_and_activations_are_bf16(pair):
    tm = pair["tm"]
    assert tm.compute_dtype == torch.bfloat16
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    assert {b.dtype for b in tm.buffers()} == {torch.float32}
    # every conv and linear layer, down to the box and mask predictors
    layers = [m for m in tm.modules() if isinstance(m, (Conv2d, ConvTranspose2d, Linear))]
    assert len(layers) > 30 and {m.compute_dtype for m in layers} == {torch.bfloat16}
    feats, _ = tm._features(pair["batch"])
    assert {f.dtype for f in feats.values()} == {torch.bfloat16}
    # the maps stay channels-last, so the poolers read them without a copy
    assert all(f.is_contiguous(memory_format=torch.channels_last) for f in feats.values())


def test_float32_config_computes_float32():
    cfg = _cfg("float32")
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    tm = build_model(tcfg, device="cpu")
    assert tm.compute_dtype == torch.float32
    assert {p.dtype for p in tm.parameters()} == {torch.float32}
    batch = {k: np.array(v) for k, v in _batch(masks=True).items()}
    feats, _ = tm._features(batch)
    assert {f.dtype for f in feats.values()} == {torch.float32}
    logits, deltas = tm.proposal_generator.rpn_head([feats["p3"]])
    assert logits[0].dtype == deltas[0].dtype == torch.float32
    pooled = torch.randn(3, 7, 7, 64)
    scores, box_deltas = tm.roi_heads.box_predictor(tm.roi_heads.box_head(pooled))
    assert tm.roi_heads.box_head(pooled).dtype == scores.dtype == torch.float32
    assert tm.roi_heads.mask_head(torch.randn(3, 14, 14, 64)).dtype == torch.float32


def test_float32_turns_tf32_off_and_restores_the_flags(monkeypatch):
    """Inference and the train step of a float32 model run with TF32 off
    and hand the caller's flags back; a bf16 model leaves them alone."""
    from jtsm_tpu_torch.modeling.meta_arch import rcnn

    seen = []
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    routed = rcnn.detector_postprocess_batched

    def spy(*args):
        seen.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return routed(*args)

    monkeypatch.setattr(rcnn, "detector_postprocess_batched", spy)
    batch = {k: np.array(v) for k, v in _batch(masks=True).items()}
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        for dtype, inside in (("float32", (False, False)), ("bfloat16", (True, True))):
            tcfg = get_cfg()
            tcfg.merge_from_other_cfg(_cfg(dtype))
            tm = build_model(tcfg, device="cpu")
            tm.inference(batch)
            assert seen[-1] == inside, dtype
            assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
        tcfg = get_cfg()
        tcfg.merge_from_other_cfg(_cfg("float32"))
        tm = build_model(tcfg, device="cpu")
        hooked = []
        tm.backbone.register_forward_hook(
            lambda *_: hooked.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        )
        opt = build_optimizer(tcfg, tm)
        make_train_step(tm, opt, build_lr_schedule(tcfg))(create_train_state(tm, opt, seed=0), batch)
        assert hooked == [(False, False)]
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == (True, True)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def test_bf16_backbone_fpn_matches_jax(pair):
    jm, tm = pair["jm"], pair["tm"]
    images = pair["batch"]["image"]
    mean = jnp.asarray(jm.pixel_mean, jnp.float32)
    std = jnp.asarray(jm.pixel_std, jnp.float32)
    want = _apply(pair, lambda m, x: m.backbone(x), (jnp.asarray(images) - mean) / std)
    with torch.no_grad():
        got, _ = tm._features(pair["batch"])
    assert sorted(got) == sorted(want) == ["p2", "p3", "p4", "p5", "p6"]
    for k in want:
        assert want[k].dtype == jnp.bfloat16 and got[k].dtype == torch.bfloat16
        gap = _gap(want[k], got[k].permute(0, 2, 3, 1))
        assert gap <= TOL_FPN, k


def test_bf16_rpn_head_matches_jax(pair):
    tm = pair["tm"]
    rng = np.random.RandomState(5)
    feats = [rng.randn(2, s, s, 64).astype(np.float32) for s in (16, 8, 4)]
    jfeats = [jnp.asarray(f, jnp.bfloat16) for f in feats]
    want_l, want_d = _apply(pair, lambda m, f: m.proposal_generator.head(f), jfeats)
    with torch.no_grad():
        got_l, got_d = tm.proposal_generator.rpn_head(
            [torch.from_numpy(np.array(f.astype(jnp.float32))).to(torch.bfloat16).permute(0, 3, 1, 2)
             for f in jfeats]
        )
    for w, g in zip(list(want_l) + list(want_d), list(got_l) + list(got_d)):
        assert w.dtype == jnp.bfloat16 and g.dtype == torch.bfloat16
        gap = _gap(w, g.permute(0, 2, 3, 1))
        assert gap <= TOL_RPN


def test_bf16_box_head_and_predictor_match_jax(pair):
    tm = pair["tm"]
    x = np.random.RandomState(1).randn(30, 7, 7, 64).astype(np.float32)
    js, jd = _apply(pair, lambda m, x: m.roi_heads.box_predictor(m.roi_heads.box_head(x)), x)
    with torch.no_grad():
        h = tm.roi_heads.box_head(torch.from_numpy(x))
        ts, td = tm.roi_heads.box_predictor(h)
    assert h.dtype == torch.bfloat16 and ts.dtype == td.dtype == torch.float32
    for w, g in ((js, ts), (jd, td)):
        gap = _gap(w, g)
        assert gap <= TOL_BOX


def test_bf16_mask_head_matches_jax(pair):
    tm = pair["tm"]
    x = np.random.RandomState(2).randn(12, 14, 14, 64).astype(np.float32)
    want = _apply(pair, lambda m, x: m.roi_heads.mask_head(x), x)  # (N, 28, 28, K)
    with torch.no_grad():
        got = tm.roi_heads.mask_head(torch.from_numpy(x))  # (N, K, 28, 28)
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    gap = _gap(want, got.permute(0, 2, 3, 1))
    assert gap <= TOL_MASK


@pytest.mark.parametrize("output_size", [7, 14])
def test_bf16_roi_align_matches_jax(output_size):
    rng = np.random.RandomState(11)
    hw = [(32, 48), (16, 24), (8, 12), (4, 6)]
    feats = [rng.randn(2, h, w, 16).astype(np.float32) for h, w in hw]
    r = 60
    xy = rng.rand(r, 2) * 160
    boxes = np.concatenate([xy, xy + rng.rand(r, 2) * 90 + 1], -1).astype(np.float32)
    levels = rng.randint(0, 4, r).astype(np.int32)
    bidx = rng.randint(0, 2, r).astype(np.int32)
    scales = (1 / 4, 1 / 8, 1 / 16, 1 / 32)
    jfeats = tuple(jnp.asarray(f, jnp.bfloat16) for f in feats)
    want = jax_roi_align_multilevel(
        jfeats, scales, jnp.asarray(boxes), jnp.asarray(bidx), jnp.asarray(levels), output_size, 0, True,
    )
    got = roi_align.roi_align_multilevel(
        [torch.from_numpy(np.array(f.astype(jnp.float32))).to(torch.bfloat16) for f in jfeats],
        scales, torch.from_numpy(boxes), torch.from_numpy(bidx), torch.from_numpy(levels),
        output_size, 0, True,
    )
    assert want.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    assert _gap(want, got) <= TOL_ROI
    # the same bf16 values pooled in float32: the port rounds that once
    exact = roi_align.roi_align_multilevel(
        [torch.from_numpy(np.array(f.astype(jnp.float32))) for f in jfeats],
        scales, torch.from_numpy(boxes), torch.from_numpy(bidx), torch.from_numpy(levels),
        output_size, 0, True,
    )
    assert _gap(exact, got) <= BF16_STEP / 2
    assert _gap(exact, got) < _gap(exact, torch.from_numpy(np.array(want.astype(jnp.float32))))


@pytest.fixture(scope="module")
def jax_train(pair):
    """The JAX side's loss dict and gradients of one bf16 train step."""
    jm, variables, batch = pair["jm"], pair["variables"], pair["batch"]

    def loss_fn(params):
        losses = jm.apply(
            {"params": params, "frozen": variables["frozen"]}, batch, train=True,
            rngs={"sampling": jax.random.key(1)},
        )
        return sum(losses.values()), losses

    with jax.default_matmul_precision("highest"):
        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
    return {k: float(v) for k, v in losses.items()}, jax.tree_util.tree_map(np.asarray, grads)


def _normwise(got, want):
    """||got - want|| / ||want||: a gradient's gap as a whole, which one
    cancelling entry cannot dominate."""
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _train_grads(pair, dtype):
    _, model = _torch_model(_cfg(dtype), pair["variables"])
    model.train()
    losses = model(pair["batch"], generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    return losses, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


def test_bf16_train_step_losses_and_gradients_match_jax(pair, jax_train, monkeypatch):
    want_losses, want_grads = jax_train
    # every loss takes its logits and deltas in float32, as in JAX
    # (rpn.py:349, fast_rcnn.py:55, mask_head.py:139)
    seen = []

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kwargs):
            dtypes = {a.dtype for a in args if isinstance(a, torch.Tensor) and a.is_floating_point()}
            seen.append((module.__name__.rsplit(".", 1)[-1], name, frozenset(dtypes)))
            return fn(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapped)

    spy(rpn_module, "binary_cross_entropy_with_logits")
    spy(rpn_module, "smooth_l1_loss")
    spy(roi_heads_module, "fast_rcnn_losses")
    spy(mask_head_module, "binary_cross_entropy_with_logits")
    losses, grads = _train_grads(pair, "bfloat16")
    assert len({s[:2] for s in seen}) == 4 and {s[2] for s in seen} == {frozenset([torch.float32])}, seen
    assert sorted(losses) == sorted(want_losses) == LOSSES
    for k in LOSSES:
        assert losses[k].dtype == torch.float32
        gap = abs(losses[k].item() - want_losses[k]) / max(abs(want_losses[k]), 1e-30)
        assert gap <= TOL_LOSS, k
    want = {n: g.numpy() for n, g in variables_to_state_dict({"params": want_grads}).items()}
    assert {g.dtype for g in grads.values()} == {torch.float32}
    for name in GRAD_CHECKED:
        assert _normwise(grads[name].numpy(), want[name]) <= TOL_GRAD, name
    # the same step in float32 (exact arithmetic, which the float32 tests
    # hold to JAX's float32 step): the port's bf16 gradients must lie
    # nearer JAX's bf16 ones than float32 gradients do, for most parameters
    # and on the box predictor, whose gradient float32 moves the most
    _, exact = _train_grads(pair, "float32")
    live = [n for n in grads if np.linalg.norm(want[n]) > 0]
    assert sorted(grads) == sorted(exact) and len(live) > 40

    nearer = [_normwise(grads[n].numpy(), want[n]) < _normwise(exact[n].numpy(), want[n]) for n in live]
    assert np.mean(nearer) >= TOL_NEARER
    name = "roi_heads.box_predictor.bbox_pred.weight"
    assert _normwise(grads[name].numpy(), want[name]) <= TOL_BBOX_VS_F32 * _normwise(exact[name].numpy(), want[name])
