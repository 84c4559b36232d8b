"""Trident OICR on the multi-rate WS-ResNet, the multi-rate heads, Faster
R-CNN on the WS-ResNet-50 FPN and the DC5 family in the port, held against
the JAX package on the CPU from seeded weights (carried across by
``checkpoint.variables_to_state_dict``):

* the ResNet blocks' call-time dilation (basic: both 3x3 convolutions;
  bottleneck: its 3x3 only), values and gradients;
* ``MRRPWSLResNet`` on basic (WSR-18) and bottleneck (WSR-50) blocks: the
  branches folded branch-major, the gradient of FREEZE_AT 0 summed over the
  branches into the shared weights, none under FREEZE_AT 5;
* ``TridentOICRROIHeads`` (``oicr_TRD_WSR_18_DC5_cfg(narrow=True)``), the
  same heads under ``MRRPOICRROIHeads``, and ``MRRPWSDDNROIHeads`` (no yaml
  names it: ``mrrp_wsddn_WSR_18_DC5_cfg(narrow=True)``): detections, losses
  and every gradient;
* ``faster_rcnn_WSR_50_FPN_cfg(narrow=True)``, and the two whole-model DC5
  cases: Faster R-CNN R-50 DC5 (``faster_rcnn_R_50_DC5_1x.yaml`` under
  ``c4_narrow``) and OICR on WSR-50 DC5 (``oicr_WSR_50_DC5_cfg(narrow=True)``):
  serving and one train step, as ``tests/test_torch_c4.py`` holds its
  models (its deterministic sampling and tolerances);
* the WSL mask heads ``MaskRCNNUpsampleWSLHead`` and ``MaskRCNNWSLHead``
  under the JTSM gate's mask head settings: both packages build the
  conv-upsample WSL head at ROI_MASK_HEAD.NUM_CONV (JAX
  ``mask_head_wsl.py:41-50`` overrides the first's ``num_conv`` 0).

Tolerances (float32 on both sides, JAX matmul precision "highest";
measured on the CPU in brackets): blocks and trunks within 1e-5 of the
output's scale (at most 1.2e-6) and each gradient within 1e-4 of its norm
(at most 1.4e-6); the WSOD models as ``tests/test_torch_wsod.py`` (boxes
1e-3 px, scores 1e-4 of scale, losses 1e-4 relative, gradients 1e-4 of
their norm; measured at most 4.6e-5 px, 1.1e-5, 2.7e-6 and 3.9e-5); the
supervised models as ``tests/test_torch_c4.py`` (boxes at most 8.4e-4 px,
the DC5 Faster R-CNN's, scores 1.9e-5, losses 3.2e-7, gradients 1.5e-6);
the mask heads' logits and features within 1e-5 of scale. The DAN's dropout is off on both
sides (``tests/test_torch_wsod.py`` sets out how).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.modeling.backbone import resnet as jax_resnet
from jtsm_tpu.modeling.roi_heads.mask_head import build_mask_head as jax_build_mask_head
from jtsm_tpu.wsl.modeling.resnet_wsl import build_mrrp_wsl_resnet_backbone as jax_build_mrrp
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import (
    c4_narrow,
    faster_rcnn_WSR_50_FPN_cfg,
    get_cfg,
    jtsm_gate_cfg,
    mrrp_wsddn_WSR_18_DC5_cfg,
    oicr_TRD_WSR_18_DC5_cfg,
    oicr_TRD_WSR_50_DC5_cfg,
    oicr_WSR_50_DC5_cfg,
)
from jtsm_tpu_torch.layers import ShapeSpec
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.backbone.resnet import BasicBlock, BottleneckBlock
from jtsm_tpu_torch.modeling.roi_heads.mask_head import build_mask_head
from jtsm_tpu_torch.wsl.modeling.resnet_wsl import build_mrrp_wsl_resnet_backbone
from tests.test_torch_c4 import check_supervised_model, deterministic_sampling, train_batch
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables
from tests.test_torch_wsod import _close, _jax_dan_without_dropout, _np, _request  # noqa: F401  (the fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_OUT = 1e-5
TOL_REL = 1e-4
TOL_PX = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _grad_gaps(want_grads, module, prefix=""):
    """The worst of each parameter's gradient gap over its JAX norm, a
    norm below 1e-2 of the largest held relative to that 1e-2 (the MIL
    ``det`` bias's is zero in exact arithmetic)."""
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst = 0.0
    for name, p in module.named_parameters():
        w = want_grads[prefix + name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        worst = max(worst, np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale))
    return worst


# -- the blocks' call-time dilation ---------------------------------------------------


@pytest.mark.parametrize("kind", ["basic", "bottleneck"])
@pytest.mark.parametrize("dilation", [1, 3])
def test_block_call_time_dilation_matches_jax(kind, dilation):
    """One block's weights at a call-time dilation that replaces its own
    (the bottleneck built at dilation 2, as DC5's res5)."""
    rng = np.random.RandomState(dilation)
    x = rng.randn(2, 12, 14, 16).astype(np.float32)
    if kind == "basic":
        jm, tm = jax_resnet.BasicBlock(in_channels=16, out_channels=16), BasicBlock(16, 16)
    else:
        jm = jax_resnet.BottleneckBlock(in_channels=16, out_channels=32, bottleneck_channels=8, dilation=2)
        tm = BottleneckBlock(16, 32, 8, dilation=2)
    variables = _random_variables(jm, jnp.asarray(x), seed=dilation)
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    cot = rng.randn(*jax.eval_shape(lambda v: jm.apply(v, jnp.asarray(x)), variables).shape).astype(np.float32)

    def loss(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(x), dilation=dilation)
        return (out * cot).sum(), out

    with jax.default_matmul_precision("highest"):
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    got = tm(torch.tensor(x).permute(0, 3, 1, 2), dilation)
    (got.permute(0, 2, 3, 1) * torch.tensor(cot)).sum().backward()
    assert _close(np.asarray(want), got.permute(0, 2, 3, 1).detach().numpy(), TOL_OUT) <= TOL_OUT
    gap = _grad_gaps(variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)}), tm)
    print(kind, dilation, "gradients", gap)
    assert gap <= TOL_REL


# -- the multi-rate trunk ------------------------------------------------------------


@pytest.mark.parametrize("depth", [18, 50])
@pytest.mark.parametrize("freeze_at", [0, 5])
def test_mrrp_trunk_matches_jax(depth, freeze_at):
    cfg = (oicr_TRD_WSR_18_DC5_cfg if depth == 18 else oicr_TRD_WSR_50_DC5_cfg)(narrow=True)
    cfg.MODEL.BACKBONE.FREEZE_AT = freeze_at
    rng = np.random.RandomState(depth)
    x = rng.randn(2, 64, 80, 3).astype(np.float32)
    jm = jax_build_mrrp(_jax_cfg(cfg), None)
    variables = _random_variables(jm, jnp.asarray(x), seed=depth)
    tm = build_mrrp_wsl_resnet_backbone(cfg)
    tm.load_state_dict({k[len("backbone."):]: v for k, v in variables_to_state_dict(
        {c: {"backbone": variables[c]} for c in variables}).items()}, strict=True)
    shape = jax.eval_shape(lambda v: jm.apply(v, jnp.asarray(x)), variables)["res5"].shape
    cot = rng.randn(*shape).astype(np.float32)

    def loss(params):
        out = jm.apply({**variables, "params": params}, jnp.asarray(x))["res5"]
        return (out * cot).sum(), out

    with jax.default_matmul_precision("highest"):
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    got = tm(torch.tensor(x).permute(0, 3, 1, 2))["res5"]
    assert shape == (6, 4, 5, 8 * cfg.MODEL.RESNETS.RES2_OUT_CHANNELS)  # 3 branches x 2 images, stride 16
    assert tm.output_shape()["res5"].stride == 16
    print(depth, freeze_at, "res5", _close(np.asarray(want), got.permute(0, 2, 3, 1).detach().numpy(), TOL_OUT))
    # branch-major: rows 2k and 2k + 1 are branch k's images, at dilation k + 1
    with torch.no_grad():
        stem_to_res4 = torch.tensor(x).permute(0, 3, 1, 2)
        for stage in ("stem", "res2", "res3", "res4"):
            stem_to_res4 = getattr(tm, stage)(stem_to_res4)
        for k, d in enumerate((1, 2, 3)):
            y = stem_to_res4
            for block in tm.res5:
                y = block(y, d)
            np.testing.assert_allclose(y.numpy(), got[2 * k: 2 * k + 2].numpy(), rtol=0, atol=1e-5)
    if freeze_at == 5:
        assert not got.requires_grad
        assert all(not np.any(np.asarray(g)) for g in jax.tree_util.tree_leaves(grads))
        return
    (got.permute(0, 2, 3, 1) * torch.tensor(cot)).sum().backward()
    want_grads = variables_to_state_dict({"params": {"backbone": jax.tree_util.tree_map(np.asarray, grads)}})
    gap = _grad_gaps(want_grads, tm, "backbone.")
    print(depth, "gradients", gap)
    assert gap <= TOL_REL
    assert float(tm.res5[0].conv2.weight.grad.abs().max()) > 0


# -- the multi-rate heads ------------------------------------------------------------

HEAD_CASES = {  # case -> (builder, options)
    "trident_oicr": (oicr_TRD_WSR_18_DC5_cfg, []),
    "mrrp_oicr": (oicr_TRD_WSR_18_DC5_cfg, ["MODEL.ROI_HEADS.NAME", "MRRPOICRROIHeads"]),
    "mrrp_wsddn": (mrrp_wsddn_WSR_18_DC5_cfg, []),
}


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_mrrp_heads_match_jax(case):
    """The narrow Trident OICR (FREEZE_AT 0, 2 regressing branches), the
    same under ``MRRPOICRROIHeads``, and the narrow multi-rate WSDDN (the
    builder ``mrrp_wsddn_WSR_18_DC5_cfg``): the heads average the three
    branches' res5 before K1, so the gradient reaches the trunk's shared
    res5 weights through the mean."""
    builder, opts = HEAD_CASES[case]
    cfg = builder(narrow=True)
    cfg.merge_from_list(opts)
    jm = jax_build_model(_jax_cfg(cfg))
    batch = _request()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=0, train=False)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 0.01 if "refine_reg" in str(path) else a, variables)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    assert type(tm.roi_heads).__name__ == cfg.MODEL.ROI_HEADS.NAME and tm.roi_heads.mrrp_num_branch == 3

    def run(params):
        def loss(p):
            out = jm.apply({**variables, "params": p}, jb, train=True,
                           rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(0)})
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return jm.apply({**variables, "params": params}, jb, train=False), losses, grads

    with jax.default_matmul_precision("highest"):
        want, want_losses, grads = jax.jit(run)(variables["params"])
    got = tm.inference(batch)
    assert sorted(got) == sorted(want)
    for k in ("valid", "classes", "prop_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    px = np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).max()
    print(case, "boxes px", px)
    assert px <= TOL_PX
    for k in ("scores", "proposal_class_scores"):
        print(case, k, _close(np.asarray(want[k]), _np(got[k])))

    tm.train()
    tm.roi_heads.dan.dropout = 0.0
    losses = tm(batch)
    assert sorted(losses) == sorted(want_losses)
    print(case, "losses", max(_close(float(want_losses[k]), losses[k].item()) for k in want_losses))
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= TOL_REL, (name, err)
    print(case, "gradients", worst)
    assert float(tm.backbone.res5[1].conv2.weight.grad.abs().max()) > 0


# -- the supervised FPN and DC5 models, and WSR-50 OICR ---------------------------------


def test_wsr_50_fpn_serves_and_trains_as_jax():
    cfg = deterministic_sampling(faster_rcnn_WSR_50_FPN_cfg(narrow=True))
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192  # the anchors of p2-p6
    losses, _, tm = check_supervised_model(cfg, train_batch(seed=2, masks=False), seed=2)
    assert sorted(losses) == ["loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc"]
    bottom_up = tm.backbone.bottom_up
    assert type(bottom_up.stem).__name__ == "WSLStem" and bottom_up.res5_dilation == 1
    assert bottom_up.out_features == ("res2", "res3", "res4", "res5")


def test_faster_rcnn_r50_dc5_serves_and_trains_as_jax():
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, "configs/COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml"))
    cfg = deterministic_sampling(c4_narrow(cfg))
    _, _, tm = check_supervised_model(cfg, train_batch(seed=3, masks=False), seed=3)
    assert tm.backbone.res5[0].conv2.dilation == (2, 2) and tm.backbone.output_shape()["res5"].stride == 16


def test_oicr_wsr_50_dc5_matches_jax():
    """OICR on the narrow WSR-50 DC5 (bottleneck res5 dilated, FREEZE_AT 0):
    detections, losses and every gradient."""
    cfg = oicr_WSR_50_DC5_cfg(narrow=True)
    jm = jax_build_model(_jax_cfg(cfg))
    batch = _request(seed=1)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=1, train=False)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)

    def run(params):
        def loss(p):
            out = jm.apply({**variables, "params": p}, jb, train=True, rngs={"dropout": jax.random.key(0)})
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return jm.apply({**variables, "params": params}, jb, train=False), losses, grads

    with jax.default_matmul_precision("highest"):
        want, want_losses, grads = jax.jit(run)(variables["params"])
    got = tm.inference(batch)
    for k in ("valid", "classes", "prop_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    print("scores", _close(np.asarray(want["scores"]), _np(got["scores"])))
    tm.train()
    tm.roi_heads.dan.dropout = 0.0
    losses = tm(batch)
    print("losses", max(_close(float(want_losses[k]), losses[k].item()) for k in want_losses))
    sum(losses.values()).backward()
    gap = _grad_gaps(variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)}), tm)
    print("gradients", gap)
    assert gap <= TOL_REL
    assert tm.backbone.res5[0].conv2.dilation == (2, 2)


# -- the WSL mask heads' other names ---------------------------------------------------


@pytest.mark.parametrize("name", ["MaskRCNNUpsampleWSLHead", "MaskRCNNWSLHead"])
def test_wsl_mask_head_names_build_the_conv_upsample_head(name):
    cfg = jtsm_gate_cfg()
    cfg.MODEL.ROI_MASK_HEAD.NAME = name
    shape = ShapeSpec(channels=24, height=14, width=14)
    jcfg = jax_get_cfg()
    jcfg.merge_from_other_cfg(_jax_cfg(cfg))
    jm = jax_build_mask_head(jcfg, shape)
    assert jm.num_conv == cfg.MODEL.ROI_MASK_HEAD.NUM_CONV > 0
    x = np.random.RandomState(0).randn(3, 14, 14, 24).astype(np.float32)
    variables = _random_variables(jm, jnp.asarray(x))
    with jax.default_matmul_precision("highest"):
        want_logits, want_feats = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = build_mask_head(cfg, shape)
    assert type(tm).__name__ == "MaskRCNNConvUpsampleWSLHead" and len(tm.conv_norm_relus) == jm.num_conv
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    logits, feats = tm(torch.tensor(x))
    _close(np.asarray(want_logits), logits.permute(0, 2, 3, 1).detach().numpy(), TOL_OUT)
    _close(np.asarray(want_feats), feats.permute(0, 2, 3, 1).detach().numpy(), TOL_OUT)
