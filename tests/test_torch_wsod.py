"""The port's WSOD baselines (``GeneralizedRCNNWSL`` with
``WSDDNROIHeads``, ``OICRROIHeads`` and ``PCLROIHeads`` on WSR-18 DC5 and
VGG16 DC5) held against the JAX package on the CPU, module by module, from
numpy inputs and weights drawn from a seed (carried across by
``checkpoint.variables_to_state_dict``).

Tolerances (float32 on both sides, JAX matmul precision "highest";
measured on the CPU in brackets):

* detections: classes, validity and source proposals equal, boxes within
  1e-3 px (at most 1.5e-5), scores and each proposal's class scores within
  1e-4 of the largest on the JAX side (at most 1.5e-5);
* losses within 1e-4 relative (at most 5.8e-6);
* the parameters' gradients of one step: each parameter's difference
  within 1e-4 of its L2 norm on WSR-18 (at most 1.3e-5), and 3e-3 through
  VGG16 (at most 4.8e-4): at random weights its thirteen ReLUs meet many
  near-zero activations, where float32 rounding alone moves the early
  layers' gradients, on either side. A norm below 1e-2 of the
  largest (the MIL ``det`` bias, zero in exact arithmetic: the softmax over
  the proposals ignores it) is held relative to that 1e-2 instead;
* VGG16 DC5 alone: ``plain5`` within 1e-4 of its scale (1.3e-6), the
  gradients within 3e-3 of each norm (3.0e-6);
* ``build_proposal_clusters``: every field equal; ``pcl_losses``: value
  and gradient within 1e-5 relative (0).

The DAN's dropout is off on both sides (as in ``tests/test_torch_jtsm_train.py``):
the JAX heads build their DAN with a rate of 0.5 that no config reaches,
so the JAX side is given a DAN of rate 0 in its modules' namespace for the
test's duration; the port's is set to 0.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.modeling.test_time_augmentation import GeneralizedRCNNWithTTAAVG as JaxTTAAVG
from jtsm_tpu.wsl import ops as jax_wsl_ops
from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw
from jtsm_tpu.wsl.modeling import vgg as jax_vgg
from jtsm_tpu.wsl.modeling import wsod_zoo as jax_zoo
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import (
    WSOD_HEADS,
    faster_rcnn_R_50_C4_cfg,
    uwsod_V_16_DC5_cfg,
    wsl_cfg,
    wsod_V_16_DC5_cfg,
    wsod_V_16_narrow_cfg,
    wsod_WSR_18_DC5_cfg,
    wsod_WSR_18_narrow_cfg,
)
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.test_time_augmentation import GeneralizedRCNNWithTTAAVG
from jtsm_tpu_torch.solver import build_optimizer
from jtsm_tpu_torch.wsl import ops as wsl_ops
from jtsm_tpu_torch.wsl.modeling.vgg import VGG
from jtsm_tpu_torch.wsl.modeling.wsod_zoo import build_proposal_clusters
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_DET = os.path.join(ROOT, "projects", "WSL", "configs", "PascalVOC-Detection")
TOL_REL = 1e-4
TOL_PX = 1e-3


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _jax_dan_without_dropout():
    """The JAX heads' DAN at dropout 0 while this file runs."""
    dan = jax_rhw.DiscriminativeAdaptionNeck
    no_dropout = functools.partial(dan, dropout=0.0)
    jax_rhw.DiscriminativeAdaptionNeck = jax_zoo.DiscriminativeAdaptionNeck = no_dropout
    yield
    jax_rhw.DiscriminativeAdaptionNeck = jax_zoo.DiscriminativeAdaptionNeck = dan


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(want, got, rel=TOL_REL):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1e-30, float(np.abs(a).max(initial=0.0)))
    err = float(np.abs(a - b).max(initial=0.0)) / scale
    assert err <= rel, (err, rel)
    return err


def _request(seed=0, h=128, w=176, r=64):
    """Two requests of the narrow configs' bucket: 64 proposals each (the
    last five of the second padding), image labels for training."""
    rng = np.random.RandomState(seed)
    xy = rng.rand(2, r, 2) * [w - 30, h - 30]
    boxes = np.concatenate([xy, xy + rng.rand(2, r, 2) * 60 + 10], -1).astype(np.float32)
    scores = rng.rand(2, r).astype(np.float32)
    scores[1, -5:] = -np.inf
    return {
        "image": (rng.rand(2, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "proposals": boxes,
        "proposal_scores": scores,
        "gt_classes": np.array([[3, 7, 0], [12, 0, 0]], np.int32),
        "gt_valid": np.array([[1, 1, 0], [1, 0, 0]], bool),
        "gt_boxes": np.zeros((2, 3, 4), np.float32),
    }


# -- configurations ---------------------------------------------------------


@pytest.mark.parametrize("head", sorted(WSOD_HEADS))
@pytest.mark.parametrize("backbone", ["WSR_18", "V_16"])
def test_python_configs_equal_their_yamls(head, backbone):
    fn = {"WSR_18": wsod_WSR_18_DC5_cfg, "V_16": wsod_V_16_DC5_cfg}[backbone]
    cfg = wsl_cfg()
    cfg.merge_from_file(os.path.join(VOC_DET, f"{WSOD_HEADS[head]}_{backbone}_DC5_1x.yaml"))
    assert fn(head).to_dict() == cfg.to_dict()
    assert _jax_cfg(cfg).to_dict() == cfg.to_dict()
    narrow = {"WSR_18": wsod_WSR_18_narrow_cfg, "V_16": wsod_V_16_narrow_cfg}[backbone](head)
    assert (narrow.MODEL.META_ARCHITECTURE, narrow.MODEL.ROI_HEADS.NAME) == ("GeneralizedRCNNWSL", head)
    assert narrow.WSL.MEAN_LOSS == (head != "WSDDNROIHeads")


# -- VGG16 DC5 ----------------------------------------------------------------


def _vgg_case(freeze_at, out_features=("plain5",), h=64, w=96):
    rng = np.random.RandomState(0)
    x = rng.randn(1, h, w, 3).astype(np.float32)
    jm = jax_vgg.VGG(depth=16, conv5_dilation=2, out_features=out_features, freeze_at=freeze_at)
    variables = _random_variables(jm, jnp.asarray(x))
    tm = VGG(16, 2, out_features, freeze_at)
    tm.load_state_dict({k[len("backbone."):]: v for k, v in
                        variables_to_state_dict({"params": {"backbone": variables["params"]}}).items()})
    cot = {f: rng.randn(*jax.eval_shape(lambda v: jm.apply(v, jnp.asarray(x)), variables)[f].shape)
           .astype(np.float32) for f in out_features}

    def loss(params):
        out = jm.apply({"params": params}, jnp.asarray(x))
        return sum((out[f] * cot[f]).sum() for f in out_features), out

    with jax.default_matmul_precision("highest"):
        (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    got = tm(torch.tensor(x).permute(0, 3, 1, 2))
    total = sum((got[f].permute(0, 2, 3, 1) * torch.tensor(cot[f])).sum() for f in out_features)
    if total.requires_grad:  # FREEZE_AT 5 detaches plain5
        total.backward()
    want_grads = variables_to_state_dict({"params": {"backbone": jax.tree_util.tree_map(np.asarray, grads)}})
    return want, got, want_grads, tm


def test_vgg_dc5_matches_jax_and_trains_conv1_at_freeze_at_2():
    """The JAX package's FREEZE_AT stops the gradient at the outputs dict
    only: with OUT_FEATURES ["plain5"] and FREEZE_AT 2 every convolution
    trains (the reference would freeze conv1 and conv2; ROADMAP §3). The
    port does as the JAX package does."""
    want, got, want_grads, tm = _vgg_case(freeze_at=2)
    assert got["plain5"].shape == (1, 512, 8, 12)  # stride 8: no pool before the dilated conv5
    assert tm.output_shape()["plain5"].stride == 8
    print("plain5", _close(np.asarray(want["plain5"]), got["plain5"].permute(0, 2, 3, 1).detach().numpy()))
    worst = 0.0
    for name, p in tm.named_parameters():
        w, g = want_grads[f"backbone.{name}"].numpy(), p.grad.numpy()
        worst = max(worst, np.linalg.norm(w - g) / np.linalg.norm(w))
    print("VGG gradients", worst)
    assert worst <= 3e-3
    for name in ("conv1_1.weight", "conv2_2.weight"):
        assert np.abs(dict(tm.named_parameters())[name].grad.numpy()).max() > 0, name


def test_vgg_freeze_detaches_only_the_outputs_at_or_below_it():
    """FREEZE_AT 5 detaches ``plain5`` (no gradient anywhere); FREEZE_AT 2
    with ``plain2`` among the outputs detaches that entry, and conv1 still
    trains through ``plain5``, on both sides."""
    _, _, want_grads, tm = _vgg_case(freeze_at=5, h=32, w=48)
    assert all(p.grad is None for p in tm.parameters())
    assert all(not np.any(g.numpy()) for g in want_grads.values())
    _, got, want_grads, tm = _vgg_case(freeze_at=2, out_features=("plain2", "plain5"), h=32, w=48)
    assert not got["plain2"].requires_grad and got["plain5"].requires_grad
    g = dict(tm.named_parameters())["conv1_1.weight"].grad.numpy()
    _close(want_grads["backbone.conv1_1.weight"].numpy(), g, 3e-3)


# -- the heads and the model ---------------------------------------------------------

HEAD_CASES = {
    "wsddn": (wsod_WSR_18_narrow_cfg, "WSDDNROIHeads", []),
    "oicr": (wsod_WSR_18_narrow_cfg, "OICRROIHeads", []),
    "oicr_reg": (wsod_WSR_18_narrow_cfg, "OICRROIHeads", ["WSL.REFINE_REG", "[True, True]"]),
    "oicr_mist": (wsod_WSR_18_narrow_cfg, "OICRROIHeads", ["WSL.REFINE_MIST", "True"]),
    "pcl": (wsod_WSR_18_narrow_cfg, "PCLROIHeads", []),
    "vgg_oicr": (wsod_V_16_narrow_cfg, "OICRROIHeads", []),
}


def _case_models(case, seed=0):
    fn, head, opts = HEAD_CASES[case]
    cfg = fn(head)
    cfg.merge_from_list(opts)
    jm = jax_build_model(_jax_cfg(cfg))
    batch = _request()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=seed, train=False)
    # box deltas near zero, as the JAX package initialises refine_reg (std
    # 0.001), so that the decoded boxes stay near their proposals
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 0.01 if "refine_reg" in str(path) else a, variables)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return cfg, jm, variables, tm, batch, jb


@pytest.mark.parametrize("case", sorted(HEAD_CASES))
def test_heads_detections_losses_and_gradients_match_jax(case):
    cfg, jm, variables, tm, batch, jb = _case_models(case)

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
    assert ("proposal_class_scores" in got) == (case != "pcl")
    for k in ("valid", "classes", "prop_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).max() <= TOL_PX
    print(case, "boxes px", np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).max())
    for k in ("scores", "proposal_class_scores"):
        if k in want:
            print(case, k, _close(np.asarray(want[k]), _np(got[k])))
    assert np.asarray(want["valid"]).sum(axis=1).min() > 0

    tm.train()
    tm.roi_heads.dan.dropout = 0.0
    losses = tm(batch)
    assert sorted(losses) == sorted(want_losses)
    print(case, "losses", max(_close(float(want_losses[k]), losses[k].item()) for k in want_losses))
    if case == "oicr_reg":
        assert {"loss_refine_reg0", "loss_refine_reg1"} <= set(losses)
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    tol = 3e-3 if case == "vgg_oicr" else TOL_REL
    worst = 0.0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= tol, (name, err)
    print(case, "gradients", worst)


def test_model_state_dict_reaches_the_jax_tree_through_d2_names():
    """The port's detectron2 names load into the JAX package's tree through
    its converter (every key matched), and back."""
    for case in ("oicr_reg", "pcl", "vgg_oicr"):
        _, _, variables, tm, _, _ = _case_models(case)
        state = {k: v.numpy() for k, v in tm.state_dict().items()}
        back, matched, unmatched = convert_d2_state_dict_to_variables(state, variables)
        assert not unmatched and len(matched) == len(state)
        assert len(jax.tree_util.tree_leaves(variables)) == len(state)
        again = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, back))
        for k, v in state.items():
            np.testing.assert_array_equal(again[k].numpy(), v, err_msg=k)


def test_wsr_solver_doubles_the_bias_rate_without_decay():
    """BIAS_LR_FACTOR 2.0 and WEIGHT_DECAY_BIAS 0.0 of ``Base-WSL-WSR.yaml``
    reach the biases (detectron2's grouping, ROADMAP §3)."""
    cfg = wsod_WSR_18_narrow_cfg("OICRROIHeads")
    full = wsod_WSR_18_DC5_cfg("OICRROIHeads")
    cfg.SOLVER = full.SOLVER.clone()
    model = build_model(cfg, device="cpu").train()
    opt = build_optimizer(cfg, model)
    by_id = {id(p): n for n, p in model.named_parameters()}
    for group in opt.param_groups:
        names = [by_id[id(p)] for p in group["params"]]
        if all(n.endswith(".bias") for n in names):
            assert (group["lr_factor"], group["weight_decay"]) == (2.0, 0.0), names
        else:
            assert not any(n.endswith(".bias") for n in names)
            assert (group.get("lr_factor", 1.0), group["weight_decay"]) == (1.0, 0.0005), names


def test_unported_pieces_raise():
    """The pieces that stay unported say so at build: the rotated anchor
    generator (ROADMAP queue 1 item 7e) and an MRRP stage plain1 of the
    multi-rate VGG16."""
    for builder, opts, what in (
            (faster_rcnn_R_50_C4_cfg, ["MODEL.ANCHOR_GENERATOR.NAME", "RotatedAnchorGenerator"],
             "anchor generator 'RotatedAnchorGenerator' is"),
            (uwsod_V_16_DC5_cfg, ["MODEL.MRRP.MRRP_STAGE", "plain1"], "plain1")):
        cfg = builder(narrow=True)
        cfg.merge_from_list(opts)
        with pytest.raises(NotImplementedError, match=f"{what}.* not ported yet"):
            build_model(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(wsod_WSR_18_narrow_cfg("WSDDNROIHeads"))


def test_pcl_under_tta_avg_fails_on_both_sides():
    """PCL returns no ``proposal_class_scores``: the JAX TTA-AVG fails with
    a KeyError, the port's with a ValueError that says why (ROADMAP §3)."""
    cfg, jm, variables, tm, batch, _ = _case_models("pcl")
    image = batch["image"][0, :96, :128]
    boxes, logits = batch["proposals"][0], batch["proposal_scores"][0]
    args = dict(min_sizes=(112,), max_size=176, flip=True, buckets=[(128, 176), (176, 176)])
    with pytest.raises(ValueError, match="proposal_class_scores"):
        GeneralizedRCNNWithTTAAVG(tm.inference, device=tm.device, **args)(
            image, boxes, logits, tm.inference, 1e-5, 0.3, 100)
    predict = jax.jit(lambda b: jm.apply(variables, b, train=False))
    with pytest.raises(KeyError, match="proposal_class_scores"):
        JaxTTAAVG(lambda b: predict({k: jnp.asarray(v) for k, v in b.items()}), **args)(
            image, boxes, logits, lambda b: predict({k: jnp.asarray(v) for k, v in b.items()}), 1e-5, 0.3, 100)


# -- PCL's clusters and loss ---------------------------------------------------


def _cluster_inputs(seed=0, r=24, c=4):
    """Proposals with duplicated boxes and tied scores, one absent class,
    and the padding of the second image."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 60, (2, r, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.randint(8, 40, (2, r, 2))], -1).astype(np.float32)
    boxes[:, 5] = boxes[:, 2]  # a duplicate box
    scores = np.round(rng.rand(2, r, c), 1).astype(np.float32)  # ties
    scores[:, 7] = scores[:, 3]
    valid = np.ones((2, r), bool)
    valid[1, -4:] = False
    labels = np.array([[1, 0, 1, 1], [0, 1, 0, 1]], np.float32)
    return boxes, scores, valid, labels


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_proposal_clusters_with_ties_match_jax(seed):
    boxes, scores, valid, labels = _cluster_inputs(seed)
    got = build_proposal_clusters(*(torch.tensor(a) for a in (boxes, scores, valid, labels)))
    want = jax.jit(jax.vmap(jax_zoo.build_proposal_clusters))(*(jnp.asarray(a) for a in (boxes, scores, valid, labels)))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    assert (_np(got["pc_count"]) == 0).any()  # empty clusters occur


def test_pcl_losses_value_and_gradient_match_jax():
    """From the clusters of ``_cluster_inputs``, with an absent class and
    empty clusters among them: the value and its gradient in the
    probabilities, against ``jax.grad`` of the JAX function."""
    boxes, scores, valid, labels = _cluster_inputs(3)
    clusters = build_proposal_clusters(*(torch.tensor(a) for a in (boxes, scores, valid, labels)))
    rng = np.random.RandomState(0)
    logits = rng.randn(2, boxes.shape[1], scores.shape[2] + 1).astype(np.float32)
    probs = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    im_labels = np.concatenate([np.ones((2, 1), np.float32), labels], 1)
    keys = ("labels_ref", "weights_ref", "assignment_ref", "pc_labels", "pc_count", "img_cls_loss_weights")
    fields = [_np(clusters[k]) for k in keys]
    p = torch.tensor(probs, requires_grad=True)
    loss = wsl_ops.pcl_losses(p, *(torch.tensor(f) for f in fields), torch.tensor(im_labels))
    loss.sum().backward()
    value, grad = jax.jit(jax.vmap(jax.value_and_grad(jax_wsl_ops.pcl_losses)))(
        jnp.asarray(probs), *(jnp.asarray(a) for a in fields), jnp.asarray(im_labels))
    print("pcl_losses value", _close(np.asarray(value), _np(loss), 1e-5), "gradient",
          _close(np.asarray(grad), p.grad.numpy(), 1e-5))
    assert (np.asarray(value) > 0).all()
