"""The small pieces of the port (``layers/blocks.py``, the RPN head of
several convs, ``ops/paste_masks.py`` ``paste_masks_in_image``) held
against the JAX package on the CPU, each from the same seeded weights and
inputs (weights carried JAX -> port by ``variables_to_state_dict``):

* ``DepthwiseSeparableConv2d`` with and without GN and activations:
  outputs within 1e-5 of the largest (measured in the test's output);
  ``CNNBlockBase`` keeps its three attributes;
* ``StandardRPNHead`` with MODEL.RPN.CONV_DIMS of two and three entries
  (``conv0``, ``conv1``, ... under the JAX package's names): objectness
  logits and deltas within 1e-5; the narrow Mask R-CNN with CONV_DIMS
  [32, 32] served and trained at ``tests/test_torch_cascade.py``'s rule,
  its gradients held together within the larger of 1e-4 and 3x the port's
  own float32-to-float64 gap (measured 5.9e-5 against 5.9e-5: behind the
  deeper head the stem's gradient alone moves 8.3e-4 from JAX's in
  float32);
* ``paste_masks_in_image``: probabilities within 1e-6 and the thresholded
  masks equal, for boxes inside, across and outside the image, and a box
  of zero width.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from jtsm_tpu.layers.blocks import DepthwiseSeparableConv2d as JaxDepthwise
from jtsm_tpu.modeling.proposal_generator.rpn import StandardRPNHead as JaxRPNHead
from jtsm_tpu.ops.paste_masks import paste_masks_in_image as jax_paste
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import cascade_narrow, mask_rcnn_R_50_FPN_cfg
from jtsm_tpu_torch.layers import CNNBlockBase, DepthwiseSeparableConv2d
from jtsm_tpu_torch.modeling.proposal_generator.rpn import StandardRPNHead
from jtsm_tpu_torch.ops.paste_masks import paste_masks_in_image
from tests.test_torch_c4 import _rel
from tests.test_torch_cascade import batch_of, check_model, deterministic
from tests.test_torch_meta_archs import _random_variables

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _nchw(x):
    return torch.as_tensor(np.ascontiguousarray(np.transpose(x, (0, 3, 1, 2))))


@pytest.mark.parametrize("norm,act", [("", None), ("GN", "relu")])
def test_depthwise_separable_conv_equals_jax(norm, act):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 16, 32)).astype(np.float32)
    act_j, act_t = (jax.nn.relu, F.relu) if act else (None, None)
    jm = JaxDepthwise(32, 64, norm1=norm or None, activation1=act_j, norm2=norm or None, activation2=act_j)
    variables = _random_variables(jm, jnp.asarray(x), seed=1)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jm.apply(variables, jnp.asarray(x)))
    tm = DepthwiseSeparableConv2d(32, 64, norm1=norm or None, activation1=act_t, norm2=norm or None,
                                  activation2=act_t)
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    assert tm.depthwise.groups == 32 and (tm.depthwise.bias is None) == bool(norm)
    got = tm(_nchw(x)).permute(0, 2, 3, 1).detach().numpy()
    err = _rel(want, got)
    print(norm, act, err)
    assert err <= TOL


def test_cnn_block_base_attributes():
    b = CNNBlockBase(16, 32, 2)
    assert (b.in_channels, b.out_channels, b.stride) == (16, 32, 2)


@pytest.mark.parametrize("conv_dims", [(32, 32), (-1, 16, 24)])
def test_rpn_head_of_several_convs_equals_jax(conv_dims):
    rng = np.random.default_rng(2)
    feats = [rng.normal(size=(2, s, s + 4, 32)).astype(np.float32) for s in (16, 8)]
    jm = JaxRPNHead(in_channels=32, num_anchors=3, conv_dims=conv_dims)
    variables = _random_variables(jm, [jnp.asarray(f) for f in feats], seed=3)
    with jax.default_matmul_precision("highest"):
        want = jm.apply(variables, [jnp.asarray(f) for f in feats])
    tm = StandardRPNHead(32, 3, conv_dims=conv_dims)
    state = variables_to_state_dict(variables)
    assert sorted({k.split(".")[0] for k in state}) == sorted(
        [f"conv{i}" for i in range(len(conv_dims))] + ["anchor_deltas", "objectness_logits"])
    tm.load_state_dict(state, strict=True)
    got = tm([_nchw(f) for f in feats])
    for w_list, g_list in zip(want, got):
        for w, g in zip(w_list, g_list):
            err = _rel(np.asarray(w), g.permute(0, 2, 3, 1).detach().numpy())
            assert err <= TOL, err


def test_single_conv_rpn_head_keeps_detectron2_names():
    assert sorted(k.split(".")[0] for k in StandardRPNHead(32, 3).state_dict()) == [
        "anchor_deltas", "anchor_deltas", "conv", "conv", "objectness_logits", "objectness_logits"]


def test_narrow_mask_rcnn_with_a_two_conv_rpn_head_as_jax():
    cfg = cascade_narrow(mask_rcnn_R_50_FPN_cfg())
    cfg.MODEL.RPN.CONV_DIMS = [32, 32]
    deterministic(cfg)
    _, tm = check_model(cfg, batch_of(cfg, seed=4), seed=4, f64_noise=True)
    assert hasattr(tm.proposal_generator.rpn_head, "conv1") and not hasattr(tm.proposal_generator.rpn_head, "conv")


def test_paste_masks_in_image_equals_jax():
    rng = np.random.default_rng(5)
    masks = rng.uniform(0, 1, (6, 28, 28)).astype(np.float32)
    boxes = np.asarray([[10.5, 20.25, 60.0, 70.0], [-15.0, -8.0, 30.0, 25.0], [70.0, 50.0, 140.0, 130.0],
                        [5.0, 5.0, 5.0, 40.0], [0.0, 0.0, 120.0, 96.0], [33.3, 12.7, 34.1, 13.9]], np.float32)
    for threshold in (-1.0, 0.5):
        want = np.asarray(jax_paste(jnp.asarray(masks), jnp.asarray(boxes), (96, 120), threshold))
        got = paste_masks_in_image(torch.as_tensor(masks), torch.as_tensor(boxes), (96, 120), threshold).numpy()
        assert got.shape == want.shape == (6, 96, 120) and got.dtype == want.dtype
        if threshold < 0:
            err = float(np.abs(want - got).max())
            print("paste", err)
            assert err <= 1e-6
        else:
            np.testing.assert_array_equal(got, want)
    assert paste_masks_in_image(torch.as_tensor(masks), torch.as_tensor(boxes), (96, 120))[1, 0, 0]  # edge kept
