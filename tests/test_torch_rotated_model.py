"""The rotated modules and the narrow rotated Faster R-CNN in the port held
against the JAX package on the CPU: the whole narrow model
(``rotated_faster_rcnn_R_50_cfg(narrow=True)``, the model of
``tests/modeling/test_rotated.py``) serving, its train losses and every
gradient, and its bf16 losses (``tests/test_torch_rotated_heads.py`` holds
``RRPN`` and ``RROIHeads`` alone), with seeded weights carried across by
``checkpoint.variables_to_state_dict`` (the box classifier's, the box
regressor's and the RRPN's delta kernels scaled by 0.05 on both sides,
``seeded_models``).

Sampling is deterministic on both sides: an RRPN slot for every anchor
and an ROI slot for every proposal (RROIHeads appends no ground truth), at
positive fraction 1.0.

Tolerances (float32 on both sides, JAX matmul precision "highest"; the
largest gap measured on the CPU in brackets):

* detections matched by class and box (``match_rotated``): boxes within
  1e-3 px of the network's input or the original image, angles within 1e-3
  degrees, scores within 1e-4 of the largest (3.1e-5 and 1.6e-6);
* losses within 1e-5 relative (8.2e-7), each parameter's gradient within
  1e-4 of its L2 norm (1.1e-6; a norm below 1e-2 of the largest held
  relative to that 1e-2), as ``tests/test_torch_cascade.py``;
* bfloat16: each loss within 3e-2 relative (2.1e-3;
  ``tests/test_torch_compute_dtype.py``'s bound for a train step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.modeling.proposal_generator.rrpn  # noqa: F401  (registers RRPN)
import jtsm_tpu.modeling.roi_heads.rotated_fast_rcnn  # noqa: F401  (registers RROIHeads)
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import rotated_faster_rcnn_R_50_cfg
from jtsm_tpu_torch.modeling import build_model
from tests.test_torch_c4 import _rel, _scaled
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables

TOL_PX = 1e-3
TOL_SCORE = 1e-4
TOL_LOSS = 1e-5
TOL_GRAD = 1e-4
TOL_BF16_LOSS = 3e-2
GAINS = ("cls_score", "bbox_pred", "anchor_deltas")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def narrow_cfg():
    """The narrow model with deterministic sampling: every anchor an RRPN
    slot, every proposal an ROI slot, at positive fraction 1.0."""
    cfg = rotated_faster_rcnn_R_50_cfg(narrow=True)
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 8192
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    return cfg


def rotated_batch(seed=0, b=2, g=3, hw=(64, 64)):
    """``tests/modeling/test_rotated.py``'s batch (seed 0 gives its own),
    the second image's last ground truth row unused, the first image
    served at twice its height (an anisotropic rescale)."""
    rng = np.random.RandomState(seed)
    h, w = hw
    gtb = np.zeros((b, g, 5), np.float32)
    gtb[..., 0] = rng.rand(b, g) * (w - 24) + 10
    gtb[..., 1] = rng.rand(b, g) * (h - 24) + 10
    gtb[..., 2] = rng.rand(b, g) * 15 + 5
    gtb[..., 3] = rng.rand(b, g) * 15 + 5
    gtb[..., 4] = rng.rand(b, g) * 90 - 45
    valid = np.ones((b, g), bool)
    valid[1, -1] = False
    return {
        "image": (rng.rand(b, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.tile(np.array([[h, w]], np.int32), (b, 1)),
        "orig_sizes": np.array([[2 * h, w]] + [[h, w]] * (b - 1), np.int32),
        "gt_boxes": gtb,
        "gt_classes": rng.randint(0, 3, (b, g)).astype(np.int32),
        "gt_valid": valid,
    }


def seeded_models(cfg, batch, seed=0):
    """Both packages' models from the same seeded weights, the box
    classifier's, the box regressor's and the RRPN's delta kernels scaled
    by 0.05 (``GAINS``), as ``tests/test_torch_cascade.py`` scales the
    first two: a saturated softmax ties, and the unscaled deltas of the
    seeded ResNet's unnormalised res4 reach the scale clamp, so proposals
    and detections span hundreds of pixels (a 927 px box, whose float32
    rounding alone passed 1e-3 px)."""
    jm = jax_build_model(_jax_cfg(cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _scaled(_random_variables(jm, jb, seed=seed, train=False), GAINS, 0.05)
    tm = build_model(cfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    return jm, jb, variables, tm


def match_rotated(want, got, tol_px=TOL_PX, tol_score=TOL_SCORE):
    """Each image's valid detections matched one to one by class and box:
    the same count, boxes (centre, size, and the angle in degrees modulo
    360) within ``tol_px``, scores within ``tol_score`` of the largest.
    Returns the gaps and the number matched."""
    wb, ws, wc, wv = (np.asarray(want[k]) for k in ("boxes", "scores", "classes", "valid"))
    gb, gs, gc, gv = (got[k].detach().numpy() for k in ("boxes", "scores", "classes", "valid"))
    scale = max(float(np.abs(ws).max()), 1e-30)
    worst_px, worst_score, n = 0.0, 0.0, 0
    for i in range(wb.shape[0]):
        assert wv[i].sum() == gv[i].sum(), (i, wv[i].sum(), gv[i].sum())
        free = set(np.nonzero(gv[i])[0].tolist())
        for j in np.nonzero(wv[i])[0]:
            cands = [k for k in free if gc[i, k] == wc[i, j]]
            assert cands, (i, j)

            def gap(k):
                d = np.abs(gb[i, k] - wb[i, j]).astype(np.float64)
                d[4] = abs((gb[i, k, 4] - wb[i, j, 4] + 180.0) % 360.0 - 180.0)
                return float(d.max())

            k = min(cands, key=gap)
            free.remove(k)
            worst_px = max(worst_px, gap(k))
            worst_score = max(worst_score, abs(float(gs[i, k] - ws[i, j])) / scale)
            n += 1
    assert worst_px <= tol_px and worst_score <= tol_score, (worst_px, worst_score)
    return worst_px, worst_score, n


def test_narrow_model_serves_and_trains_as_jax():
    """The whole narrow model on ``tests/modeling/test_rotated.py``'s batch
    (the first image served at twice its height): the detections in the
    original images (the rotated rescale), the four losses, every
    parameter's gradient."""
    cfg = narrow_cfg()
    batch = rotated_batch()
    jm, jb, variables, tm = seeded_models(cfg, batch)

    def run(params):
        def loss(p):
            out = jm.apply({**variables, "params": p}, jb, train=True, rngs={"sampling": jax.random.key(1)})
            return sum(out.values()), out

        (_, losses), grads = jax.value_and_grad(loss, has_aux=True)(params)
        return jm.apply({**variables, "params": params}, jb, train=False), losses, grads

    with jax.default_matmul_precision("highest"):
        want, want_losses, want_grads = jax.jit(run)(variables["params"])
    got = tm.inference({k: v for k, v in batch.items() if not k.startswith("gt_")})
    assert sorted(got) == sorted(want) == ["boxes", "classes", "scores", "valid"]
    assert got["boxes"].shape == (2, 100, 5)
    px, score, n = match_rotated(want, got)
    print("detections", px, score, n)
    assert n > 20
    tm.train()
    losses = tm(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == sorted(want_losses) == ["loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc"]
    worst = max(_rel(float(want_losses[k]), losses[k].item()) for k in want_losses)
    print("losses", worst, {k: float(v) for k, v in want_losses.items()})
    assert worst <= TOL_LOSS and all(float(want_losses[k]) > 0 for k in ("loss_cls", "loss_rpn_cls", "loss_rpn_loc"))
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, want_grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    worst = 0.0
    for name, p in tm.named_parameters():
        w = want_grads[name].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        err = np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale)
        worst = max(worst, err)
        assert err <= TOL_GRAD, (name, err)
    print("gradients", worst)


def test_narrow_model_bf16_losses_as_jax():
    cfg = narrow_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    batch = rotated_batch(seed=1)
    jm, jb, variables, tm = seeded_models(cfg, batch, seed=1)
    want = jax.jit(lambda v: jm.apply(v, jb, train=True, rngs={"sampling": jax.random.key(1)}))(variables)
    tm.train()
    got = tm(batch, generator=torch.Generator().manual_seed(0))
    assert sorted(got) == sorted(want)
    worst = max(_rel(float(want[k]), got[k].item()) for k in want)
    print("bf16 losses", worst)
    assert worst <= TOL_BF16_LOSS
