"""UWSOD on the multi-rate VGG16 (``uwsod_V_16_DC5_1x.yaml``, its narrow
form) held against the JAX package on the CPU, as
``tests/test_torch_wsod.py`` holds the baselines (its tolerances, its
``_request``, the DAN's dropout off on both sides): ``MRRPVGG`` (the shared
plain5 kernels at dilations 2, 4 and 8, the branches folded into the
batch) and its gradient, ``RPNWSL``'s proposals over the branches as
levels, the detections of serving, and one train step's losses (the
heads' and the RPN's, which train on the boxes the heads mine) with the
parameters' gradients. The RPN samples every anchor that the matcher
labels (BATCH_SIZE_PER_IMAGE past the anchors' count at POSITIVE_FRACTION
1.0), so that no draw decides a loss, as ``docs/notes/reference_parity.md``
pins the core RPN; the model's RPN loss is smooth near 0 (see
``uwsod_models``), its yaml's L1 held on the RPN alone. Then the four WSR
yamls, which fail on both sides, and the weights' round trips through both
converters (MRRP's shared kernels, the RPN under ``RPNWSL``, WSJDS's ASPP
head).

Tolerances (PR 15's; measured on the CPU in brackets): ``plain5`` within
1e-4 of its scale (1.7e-6), its input's gradient within 3e-3 of its norm
(2.4e-6); proposals in the same slots, boxes within 1e-3 px (1.5e-5) and
logits within 1e-4 of the largest (9.4e-7), the deferred losses within 1e-4
relative and their gradients within 1e-4 of the largest; detections equal
in class, validity and source proposal, boxes within 1e-3 px (6.1e-5),
scores within 1e-4 (8.4e-7); losses within 1e-4 relative (4.8e-7);
gradients within 1e-4 of each parameter's norm (the heads and the RPN
train, FREEZE_AT 5 detaches plain5; 6.3e-7).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.layers import ShapeSpec as JaxShapeSpec
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.wsl.modeling import rpn_wsl as jax_rpn_wsl
from jtsm_tpu.wsl.modeling import vgg as jax_vgg
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import uwsod_V_16_DC5_cfg, wsjds_V_16_DC5_cfg, wsl_cfg
from jtsm_tpu_torch.layers import ShapeSpec
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.wsl.modeling.rpn_wsl import RPNWSL
from jtsm_tpu_torch.wsl.modeling.vgg import build_mrrp_vgg_backbone
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables
from tests.test_torch_wsod import (  # noqa: F401  (the fixtures)
    TOL_PX,
    TOL_REL,
    VOC_DET,
    _close,
    _jax_dan_without_dropout,
    _np,
    _request,
    _two_torch_threads,
)


def narrow_cfg():
    """The narrow UWSOD with every labelled anchor sampled."""
    cfg = uwsod_V_16_DC5_cfg(narrow=True)
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192  # 16 x 22 cells x 6 anchors x 3 branches = 6336 an image
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    return cfg


def test_mrrp_vgg_and_its_gradient_match_jax():
    cfg = narrow_cfg()
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    jb = jax_vgg.build_mrrp_vgg_backbone(_jax_cfg(cfg), JaxShapeSpec(channels=3))
    x = (np.random.RandomState(0).randn(2, 64, 80, 3)).astype(np.float32)
    variables = _random_variables(jb, jnp.asarray(x))
    cot = np.random.RandomState(1).randn(6, 8, 10, 512).astype(np.float32)

    def run(inp):
        out = jb.apply(variables, inp)["plain5"]
        return (out * cot).sum(), out

    (_, want), want_g = jax.jit(jax.value_and_grad(run, has_aux=True))(x)
    tb = build_mrrp_vgg_backbone(cfg)
    tb.load_state_dict({k[len("backbone."):]: v for k, v in
                        variables_to_state_dict({"params": {"backbone": variables["params"]}}).items()}, strict=True)
    assert tb.output_shape()["plain5"].stride == 8 and tb.conv5_1.dilations == (2, 4, 8)
    tx = torch.tensor(x).permute(0, 3, 1, 2).requires_grad_()
    got = tb(tx)["plain5"]
    (got.permute(0, 2, 3, 1) * torch.tensor(cot)).sum().backward()
    assert got.shape == (6, 512, 8, 10)  # three branches of two images, branch-major
    err = _close(np.asarray(want), got.detach().permute(0, 2, 3, 1).numpy())
    g_err = float(np.linalg.norm(np.asarray(want_g) - tx.grad.permute(0, 2, 3, 1).numpy())
                  / np.linalg.norm(np.asarray(want_g)))
    print("mrrp vgg", err, g_err)
    assert g_err <= 3e-3
    # the branches differ (their dilations), the shared kernel is one parameter
    assert not torch.allclose(got[:2], got[2:4])
    assert sum(1 for n, _ in tb.named_parameters() if n.startswith("conv5_1.")) == 2


@pytest.mark.parametrize("train", [False, True])
def test_rpn_wsl_proposals_match_jax(train):
    """The branches as three levels of one RPN, in serving (the test top-k)
    and training (the train top-k, the losses deferred)."""
    cfg = narrow_cfg()
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 48  # serving's own top-k
    shapes = {"plain5": ShapeSpec(channels=512, stride=8)}
    jr = jax_rpn_wsl.RPNWSL(**jax_rpn_wsl.RPNWSL.from_config(_jax_cfg(cfg), {"plain5": JaxShapeSpec(512, stride=8)}))
    rng = np.random.RandomState(2)
    feat = np.maximum(rng.randn(6, 16, 22, 512), 0).astype(np.float32)
    sizes = np.array([[128, 176], [112, 144]], np.int32)
    variables = _random_variables(jr, jnp.asarray(sizes), {"plain5": jnp.asarray(feat)})
    want_p, want_s, want_aux = jax.jit(lambda v: jr.apply(v, jnp.asarray(sizes), {"plain5": jnp.asarray(feat)},
                                                          train=train, defer_losses=True))(variables)
    tr = RPNWSL(cfg, shapes)
    state = variables_to_state_dict({"params": {"proposal_generator": variables["params"]}})
    tr.load_state_dict({k[len("proposal_generator."):]: v for k, v in state.items()}, strict=True)
    tr.train(train)
    with torch.no_grad():
        got_p, got_s, aux = tr(torch.tensor(sizes), {"plain5": torch.tensor(feat).permute(0, 3, 1, 2)},
                               defer_losses=True)
    k = 64 if train else 48
    assert got_p.shape == (2, k, 4) and ("_deferred" in aux) == train == ("_deferred" in want_aux)
    want_s, got_s = np.asarray(want_s), got_s.numpy()
    np.testing.assert_array_equal(np.isfinite(got_s), np.isfinite(want_s))
    fin = np.isfinite(want_s)
    px = float(np.abs(np.asarray(want_p)[fin] - got_p.numpy()[fin]).max())
    print("rpn_wsl", train, "boxes px", px, "logits", _close(want_s[fin], got_s[fin]), int(fin.sum()))
    assert px <= TOL_PX and fin.sum() > k
    if not train:
        return
    # the deferred losses against boxes known afterwards (two of three
    # valid), and their gradients in the deferred logits and deltas
    gt = np.array([[[20, 30, 90, 100], [10, 10, 60, 50], [0, 0, 0, 0]],
                   [[40, 20, 130, 100], [5, 5, 170, 120], [0, 0, 0, 0]]], np.float32)
    gv = np.array([[1, 1, 0], [1, 1, 0]], bool)
    d = want_aux["_deferred"]

    def jax_losses(deltas, logits):
        out = jr.apply(variables, jax.random.key(0), dict(d, deltas=deltas, logits=logits), jnp.asarray(gt),
                       jnp.asarray(gv), method=jr.get_losses)
        return out["loss_rpn_cls"] + out["loss_rpn_loc"], out

    (_, want_l), (gd, gl) = jax.value_and_grad(jax_losses, argnums=(0, 1), has_aux=True)(d["deltas"], d["logits"])
    anchors, _, _, dsizes = aux["_deferred"]
    td = torch.tensor(np.asarray(d["deltas"]), requires_grad=True)
    tl = torch.tensor(np.asarray(d["logits"]), requires_grad=True)
    got_l = tr.get_losses((anchors, tl, td, dsizes), torch.tensor(gt), torch.tensor(gv),
                          torch.Generator().manual_seed(0))
    sum(got_l.values()).backward()
    assert sorted(got_l) == sorted(want_l) == ["loss_rpn_cls", "loss_rpn_loc"]
    for k_ in got_l:
        _close(float(want_l[k_]), got_l[k_].item())
    assert _close(np.asarray(gd), td.grad.numpy()) <= TOL_REL and _close(np.asarray(gl), tl.grad.numpy()) <= TOL_REL


def uwsod_models(seed=0):
    cfg = narrow_cfg()
    # the RPN's regression loss smooth below 1/9: at the yaml's L1 (beta 0)
    # the anchor whose decoded box the heads mine as a PGT box regresses to
    # its own prediction, so that the sign of its L1 gradient is a rounding
    # difference's (one anchor, 12% of the norm of loss_rpn_loc's gradient
    # in anchor_deltas, measured); test_rpn_wsl_proposals_match_jax holds
    # the L1 form on boxes without that tie
    cfg.MODEL.RPN.SMOOTH_L1_BETA = 1.0 / 9
    jm = jax_build_model(_jax_cfg(cfg))
    batch = _request()
    for k in ("proposals", "proposal_scores"):
        del batch[k]  # the RPN proposes
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=seed, train=False)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 0.01 if "refine_reg" in str(path) else a, variables)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return cfg, jm, variables, tm, batch, jb


def test_uwsod_serving_losses_and_gradients_match_jax():
    cfg, jm, variables, tm, batch, jb = uwsod_models()

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
    assert sorted(got) == sorted(want) == ["boxes", "classes", "prop_idx", "scores", "valid"]
    for k in ("valid", "classes", "prop_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    px = float(np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).max())
    print("uwsod boxes px", px, "scores", _close(np.asarray(want["scores"]), _np(got["scores"])))
    assert px <= TOL_PX and np.asarray(want["valid"]).sum(axis=1).min() > 0

    tm.train()
    tm.roi_heads.dan.dropout = 0.0
    losses = tm(batch, generator=torch.Generator().manual_seed(0))
    expected = {"loss_mil", "loss_rpn_cls", "loss_rpn_loc"} | {f"loss_refine_{t}{k}" for t in ("cls", "reg")
                                                               for k in range(2)}
    assert set(losses) == set(want_losses) == expected
    print("uwsod losses", {k: float(v) for k, v in want_losses.items()},
          max(_close(float(want_losses[k]), losses[k].item()) for k in want_losses))
    assert float(want_losses["loss_rpn_loc"]) > 0 and float(want_losses["loss_refine_reg1"]) > 0
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
    print("uwsod gradients", worst)
    assert tm.backbone.conv5_1.weight.grad is None  # FREEZE_AT 5 detaches plain5
    assert tm.proposal_generator.rpn.rpn_head.conv.weight.grad.abs().max() > 0


@pytest.mark.parametrize("depth", ["18", "50", "101", "18_GT"])
def test_uwsod_wsr_yamls_fail_on_both_sides(depth):
    """``uwsod_WSR_*`` keep MODEL.RPN.IN_FEATURES ["res4"], which the WSL
    ResNet does not output: the port raises a ValueError that says so, the
    JAX package a KeyError (ROADMAP §3)."""
    name = "uwsod_WSR_18_DC5_1x_GT.yaml" if depth == "18_GT" else f"uwsod_WSR_{depth}_DC5_1x.yaml"
    cfg = wsl_cfg()
    cfg.merge_from_file(os.path.join(VOC_DET, name))
    with pytest.raises(ValueError, match=r"MODEL\.RPN\.IN_FEATURES \['res4'\].*outputs: \['res5'\]"):
        build_model(cfg, device="cpu")
    with pytest.raises(KeyError, match="res4"):
        jax_build_model(_jax_cfg(cfg))


@pytest.mark.parametrize("case", ["uwsod", "wsjds"])
def test_checkpoint_round_trip_through_both_converters(case):
    """MRRP's shared plain5 kernels, the RPN under ``RPNWSL`` and WSJDS's
    ASPP head reach the JAX package's tree through its converter and come
    back equal."""
    cfg = narrow_cfg() if case == "uwsod" else wsjds_V_16_DC5_cfg(narrow=True)
    jm = jax_build_model(_jax_cfg(cfg))
    batch = _request()
    if case == "uwsod":
        del batch["proposals"], batch["proposal_scores"]
    variables = _random_variables(jm, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    marker = "proposal_generator.rpn.rpn_head.conv.weight" if case == "uwsod" else \
        "roi_heads.sem_seg_head.aspp.conv1x1.norm.weight"
    assert marker in state and "backbone.conv5_3.weight" in state
    back, matched, unmatched = convert_d2_state_dict_to_variables(state, variables)
    # the JAX package's mapping has no group norm (flax keeps its scale under
    # GroupNorm_0): the ASPP head's norms are checked against the flax
    # leaves directly, as tests/test_torch_jtsm.py checks the JTSM gate's
    assert set(unmatched) == {k for k in state if ".aspp." in k and ".norm." in k}
    assert len(matched) + len(unmatched) == len(state)
    assert len(jax.tree_util.tree_leaves(variables)) == len(state)
    flat_back = dict(jax.tree_util.tree_leaves_with_path(back))
    for path, leaf in jax.tree_util.tree_leaves_with_path(variables):
        names = [p.key for p in path]
        if "GroupNorm_0" in names:
            key = ".".join(names[1:-3] + ["norm", {"scale": "weight"}.get(names[-1], names[-1])])
            np.testing.assert_array_equal(state[key], leaf)
        else:
            np.testing.assert_array_equal(np.asarray(flat_back[path]), leaf)
    again = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, back))
    for k, v in state.items():
        np.testing.assert_array_equal(again[k].numpy(), v, err_msg=k)
