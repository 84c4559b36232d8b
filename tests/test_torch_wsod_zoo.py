"""The WSOD zoo's further heads held against the JAX package on the CPU, as
``tests/test_torch_wsod.py`` holds the baselines (its tolerances, its
``_request``, the DAN's dropout off on both sides): PCL with the guided
attention module (``reg_last/pcl_WSR_18_DC5_1x.yaml``), OICR with
per-branch sampling (``reg_all/oicr_SP_WSR_18_DC5_1x.yaml``) and CMIL
(``cmil_WSR_18_DC5_1x.yaml``) on the narrow WSR-18 DC5 here; Cascade OICR
and ContextLocNet on it in ``tests/test_torch_wsod_zoo_cascade.py``;
ContextLocNet and CMIL on the narrow VGG16 DC5 in
``tests/test_torch_wsod_zoo_vgg.py`` (one file each for the parallel test
run's sake). Each case: the detections of both packages' inference, then
one train step's losses and the parameters' gradients against
``apply(train=True)``.

The cases and what they need:

* PCL with GAM: the MIL and refinement layers' seeded weights scaled by
  0.1. At the seed's full scale the attended map saturates the class
  softmax, an image score reaches the MIL loss's clamp at 1 - 1e-6, and
  the two frameworks' float32 roundings fall on its two sides there (a
  gradient of 1 against 0: 1.3e-3 of ``mil.det``'s norm); scaled, the
  gradients agree within 1.8e-5;
* OICR-SP: the yaml's sampling (BATCH_SIZE_PER_IMAGE 4096, POSITIVE_FRACTION
  1.0) keeps every labelled proposal of the 64, so that its draws select
  nothing away and both packages' losses are deterministic;
* CMIL: four exact duplicates of a proposal in each image (the merges of
  lambda 1.0, the threshold both packages' train step uses) and the second
  branch regressing (WSL.REFINE_REG [False, True]: the regression loss and
  the last branch's decoded boxes); the MIL and refinement layers' weights
  scaled by 0.1 as for PCL with GAM: at full scale the branches' softmax
  saturates, half the detections score 0.5 (one branch at 1, the other at
  0) and the order of those ties turns on the last float32 bit;
* ContextLocNet: ``roi_loop_pool`` takes hard maxima, so where the
  backbone's float32 rounding moves two near-tied pixels of a window past
  each other the two packages route that bin's gradient to different
  pixels: its backbone gradients are held within 1e-3 of their norms
  (measured 3.7e-4; the op itself agrees with ``jax.grad`` to 1e-6 with
  exact ties, ``tests/test_torch_wsod_zoo_ops.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.modeling.test_time_augmentation import GeneralizedRCNNWithTTAAVG as JaxTTAAVG
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import WSOD_ZOO
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.test_time_augmentation import GeneralizedRCNNWithTTAAVG
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables
from tests.test_torch_wsod import (  # noqa: F401  (the fixtures)
    TOL_PX,
    TOL_REL,
    _close,
    _jax_dan_without_dropout,
    _np,
    _request,
    _two_torch_threads,
)

# case -> (WSOD_ZOO entry, config options, scale of the MIL and refinement
# layers' seeded weights, the gradients' tolerance)
ZOO_CASES = {
    "pcl_gam": ("pcl_gam_WSR_18", [], 0.1, TOL_REL),
    "oicr_sp": ("oicr_SP_WSR_18", [], None, TOL_REL),
    "cmil": ("cmil_WSR_18", ["WSL.REFINE_REG", "[False, True]"], 0.1, TOL_REL),
    "oicr_ca": ("oicr_CA_WSR_18", [], None, TOL_REL),
    "contextlocnet": ("contextlocnet_WSR_18", [], None, 1e-3),
    "contextlocnet_vgg": ("contextlocnet_V_16", [], None, 3e-3),
    "cmil_vgg": ("cmil_V_16", [], None, 3e-3),
}
NO_CLASS_SCORES = ("pcl_gam", "contextlocnet", "contextlocnet_vgg", "cmil", "cmil_vgg")


def zoo_request(case):
    """``tests/test_torch_wsod.py``'s two requests; CMIL's with proposals
    10-13 of each image copies of proposal 3."""
    batch = _request()
    if case.startswith("cmil"):
        batch["proposals"][:, 10:14] = batch["proposals"][:, 3:4]
    return batch


def zoo_models(case, seed=0):
    """The narrow configuration of ``case``, the JAX model and its seeded
    variables, the port's model with them, and the request."""
    name, opts, head_scale, _ = ZOO_CASES[case]
    cfg = WSOD_ZOO[name][1](narrow=True)
    cfg.merge_from_list(opts)
    jm = jax_build_model(_jax_cfg(cfg))
    batch = zoo_request(case)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=seed, train=False)
    variables = jax.tree_util.tree_map_with_path(
        lambda path, a: a * 0.01 if "refine_reg" in str(path) else a, variables)
    if head_scale is not None:
        variables = jax.tree_util.tree_map_with_path(
            lambda path, a: a * head_scale if ("'mil'" in str(path) or "'refine" in str(path)) else a, variables)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return cfg, jm, variables, tm, batch, jb


def check_head_case(case):
    """The detections of both packages' inference, then the losses and
    gradients of one train step (see the module docstring)."""
    cfg, jm, variables, tm, batch, jb = zoo_models(case)
    tol = ZOO_CASES[case][3]

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
    assert ("proposal_class_scores" in got) == (case not in NO_CLASS_SCORES)
    for k in ("valid", "classes", "prop_idx"):
        np.testing.assert_array_equal(_np(got[k]), np.asarray(want[k]), err_msg=k)
    px = np.abs(_np(got["boxes"]) - np.asarray(want["boxes"])).max()
    print(case, "boxes px", px)
    assert px <= TOL_PX
    for k in ("scores", "proposal_class_scores"):
        if k in want:
            print(case, k, _close(np.asarray(want[k]), _np(got[k])))
    assert np.asarray(want["valid"]).sum(axis=1).min() > 0

    tm.train()
    tm.roi_heads.dan.dropout = 0.0
    losses = tm(batch)
    assert sorted(losses) == sorted(want_losses)
    print(case, "losses", {k: round(float(v), 6) for k, v in want_losses.items()},
          max(_close(float(want_losses[k]), losses[k].item()) for k in want_losses))
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= tol, (name, err)
    print(case, "gradients", worst)
    return want_losses, tm


@pytest.mark.parametrize("case", ["pcl_gam", "oicr_sp", "cmil"])
def test_heads_detections_losses_and_gradients_match_jax(case):
    want_losses, tm = check_head_case(case)
    expected = {"pcl_gam": {"loss_gam"}, "oicr_sp": {"loss_refine_reg0", "loss_refine_reg1"},
                "cmil": {"loss_refine_reg1"}}[case]
    assert expected <= set(want_losses)
    if case == "pcl_gam":
        # GAM attends the pooled map: its conv6 trains, through K1's
        # backward on the card
        assert tm.roi_heads.gam.conv6.weight.grad.abs().max() > 0
    if case == "oicr_sp":
        assert tm.roi_heads.sampling[1][:2] == ((0.4,), (0, 1))


def test_cmil_merges_duplicates_at_lambda_one():
    """The request's duplicates form cliques at lambda 1.0 (the train
    step's threshold): their members share one cluster row. Duplicates have
    the same features, so the same objectness, and stand side by side in
    its order."""
    from jtsm_tpu_torch.wsl.modeling.wsod_zoo import roi_merge_ids

    batch = zoo_request("cmil")
    obj = torch.tensor(batch["proposal_scores"])
    obj[:, 10:14] = obj[:, 3:4]
    ids = roi_merge_ids(obj, torch.tensor(batch["proposals"]), 1.0)
    for b in range(2):
        assert len(set(ids[b, [3, 10, 11, 12, 13]].tolist())) == 1
        assert len(set(ids[b].tolist())) == 64 - 4


@pytest.mark.parametrize("case", ["pcl_gam", "cmil"])
def test_checkpoint_round_trip_through_both_converters(case):
    """GAM's ``conv6`` and ``conv7`` and CMIL's ``refine{k}`` (with its
    deltas) reach the JAX package's tree through its converter (every key
    matched) and come back equal."""
    _, _, variables, tm, _, _ = zoo_models(case)
    state = {k: v.numpy() for k, v in tm.state_dict().items()}
    assert any(k.startswith("roi_heads.gam.conv7") if case == "pcl_gam" else k.startswith("roi_heads.refine1.refine_reg")
               for k in state)
    back, matched, unmatched = convert_d2_state_dict_to_variables(state, variables)
    assert not unmatched and len(matched) == len(state)
    assert len(jax.tree_util.tree_leaves(variables)) == len(state)
    again = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, back))
    for k, v in state.items():
        np.testing.assert_array_equal(again[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("case", ["contextlocnet", "cmil"])
def test_tta_avg_raises_for_heads_without_class_scores(case):
    """ContextLocNet and CMIL return no ``proposal_class_scores``: the
    port's TTA-AVG raises a ValueError that names the head and says how to
    score it; the JAX package's fails with a KeyError (ROADMAP §3)."""
    name, opts, _, _ = ZOO_CASES[case]
    cfg = WSOD_ZOO[name][1](narrow=True)
    cfg.merge_from_list(opts)
    tm = build_model(cfg, device="cpu")
    batch = zoo_request(case)
    image = batch["image"][0, :96, :128]
    boxes, logits = batch["proposals"][0], batch["proposal_scores"][0]
    args = dict(min_sizes=(112,), max_size=176, flip=True, buckets=[(128, 176), (176, 176)])
    head = type(tm.roi_heads).__name__
    with pytest.raises(ValueError, match=f"{head} returns none.*TEST.AUG.ENABLED False"):
        GeneralizedRCNNWithTTAAVG(tm.inference, device=tm.device, **args)(
            image, boxes, logits, tm.inference, 1e-5, 0.3, 100)
    jm = jax_build_model(_jax_cfg(cfg))
    variables = _random_variables(jm, {k: jnp.asarray(v) for k, v in batch.items()}, train=False)
    predict = jax.jit(lambda b: jm.apply(variables, b, train=False))

    def jax_predict(b):
        return predict({k: jnp.asarray(v) for k, v in b.items()})

    with pytest.raises(KeyError, match="proposal_class_scores"):
        JaxTTAAVG(jax_predict, **args)(image, boxes, logits, jax_predict, 1e-5, 0.3, 100)


def test_zoo_training_keeps_the_dan_dropout_and_sampling_draws_on_the_generator():
    """In train mode with dropout on, the DAN's draws and the sampling's
    come from the step's generator: the same seed gives the same losses,
    another seed others (OICR-SP and Cascade OICR)."""
    for name in ("oicr_SP_WSR_18", "oicr_CA_WSR_18"):
        cfg = WSOD_ZOO[name][1](narrow=True)
        cfg.WSL.SAMPLING.BATCH_SIZE_PER_IMAGE = [8, 8, 8, 8]  # fewer than the labelled proposals
        tm = build_model(cfg, device="cpu").train()
        batch = zoo_request(name)

        def losses(seed):
            with torch.no_grad():
                return {k: v.item() for k, v in tm(batch, generator=torch.Generator().manual_seed(seed)).items()}

        a, b, c = losses(0), losses(0), losses(1)
        assert a == b and a != c, name
