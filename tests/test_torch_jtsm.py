"""The port's JTSM serving path (``jtsm_tpu_torch.wsl``) held against the
JAX package on the CPU, module by module and end to end, on the same numpy
inputs and the same weights (carried across by ``variables_to_state_dict``).

Tolerances, each beside the largest gap measured on the CPU (max abs
difference over the largest magnitude of the JAX side, floored at 1):

=============================================  ==========  =========
check                                          measured    tolerance
=============================================  ==========  =========
MOIPool (both modes), exact MOIPool, RoIPool   0           equal
membership grids, oh_labels, batch fields      0           equal
WSL ResNet res5 (tiny, gate)                   2.5e-6      1e-4
DAN, MIL and OICR layers                       3.4e-9      1e-4
wsl_inference boxes and scores (ties)          0           1e-4
SemSegFPNHead logits (gate weights)            1.2e-6      1e-4
bilinear upsampling                            0           1e-6
slice, float32: boxes                          8.7e-8      1e-4
slice, float32: scores, masks, stuff logits    2.6e-6      1e-4
bf16 (tiny): proposal class scores             6.2e-3      2e-2
bf16 (tiny): stuff logits                      5.3e-3      2e-2
bf16 (tiny): masks on the same boxes           1.5e-2      2e-2
=============================================  ==========  =========

Classes, validity, ``prop_idx``, ``sem_seg``, the no-paste masks and every
integer output must be equal. MOIPool reads features by nearest neighbour
and superpixels at cell centres, so equal inputs give equal outputs: the
test uses random box coordinates, which never land on a rounding tie.
In bf16 the two frameworks round convolutions and products at other
places (the backbone's maps differ by about 1e-2 of scale, as in
``test_torch_compute_dtype.py``, and the JAX ROIAlign sums in bf16), and a
near-tie in NMS or in the stuff argmax can then flip, so the bf16 slice is
compared before NMS (every proposal's class scores), on the stuff logits,
and on the mask branch over the same boxes.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from __graft_entry__ import _jtsm_batch, _jtsm_cfg_tiny
from jtsm_tpu.checkpoint.c2_model_loading import convert_d2_state_dict_to_variables
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.layers.wrappers import interpolate_bilinear as jax_interpolate_bilinear
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.modeling.backbone.build import build_backbone as jax_build_backbone
from jtsm_tpu.wsl import add_wsl_config as jax_add_wsl_config
from jtsm_tpu.wsl import data as jax_wsl_data
from jtsm_tpu.wsl import ops as jax_wsl_ops
from jtsm_tpu.wsl.modeling import mil_heads as jax_mil
from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw
from jtsm_tpu.wsl.modeling.seg_heads import TwoClassHead as JaxTwoClassHead
from jtsm_tpu_torch.checkpoint import load_gate_ckpt, random_state_dict, variables_to_state_dict
from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg, wsl_cfg
from jtsm_tpu_torch.engine import Predictor
from jtsm_tpu_torch.layers import interpolate_bilinear
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling.backbone import build_backbone
from jtsm_tpu_torch.wsl import data as wsl_data
from jtsm_tpu_torch.wsl import ops as wsl_ops
from jtsm_tpu_torch.wsl.modeling.mil_heads import MILOutputLayers, OICROutputLayers, wsddn_scores
from jtsm_tpu_torch.wsl.modeling.roi_heads_wsl import DiscriminativeAdaptionNeck, wsl_inference
from jtsm_tpu_torch.wsl.modeling.seg_heads import TwoClassHead


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_CKPT = os.path.join(ROOT, "tests", "fixtures", "gate_ckpts", "jtsm.ckpt.gz")
FLAGSHIP_YAML = "projects/WSL/configs/PascalVOC-PanopticSegmentation/jtsm_WSR_18_DC5_1x.yaml"
GATE_YAML = "projects/WSL/configs/quick_schedules/jtsm_synthetic_inference_acc_test.yaml"


def _close(want, got, rel=1e-4):
    a, b = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max(initial=0.0)))
    np.testing.assert_allclose(b, a, rtol=0, atol=rel * scale)


def _np(t):
    return t.numpy() if torch.is_tensor(t) else np.asarray(t)


def _jax_cfg(cfg):
    jc = jax_get_cfg()
    jax_add_wsl_config(jc)
    jc.merge_from_other_cfg(cfg)
    return jc


# kernel std over 1/sqrt(fan_in) where the default would saturate: the
# pooled features reach 50-100x the backbone's (the mask-area and
# objectness rescale), and the box deltas and mask logits feed exp and
# sigmoid
_GAINS = {"dan1": 0.05, "refine_reg": 0.05, "predictor": 0.1}


def _seeded_variables(jm, batch, seed):
    """Flax variables of ``jm`` filled from a numpy seed: kernels normal
    with std ``_GAINS``/sqrt(fan_in), biases normal 0.1, norms near
    identity. The model's own initialisers leave the heads' logits near
    zero, so that class scores nearly tie and NMS turns on rounding."""
    shapes = jax.eval_shape(
        lambda: jm.init({"params": jax.random.key(0), "dropout": jax.random.key(0),
                         "sampling": jax.random.key(0)}, batch, train=True)
    )
    rng = np.random.default_rng(seed)

    def fill(path, s):
        names = [getattr(p, "key", "") for p in path]
        leaf = names[-1]
        if leaf == "running_var":
            a = rng.uniform(0.5, 2.0, s.shape)
        elif leaf in ("scale", "weight"):
            a = rng.normal(1.0, 0.1, s.shape)
        elif leaf in ("bias", "running_mean"):
            a = rng.normal(0.0, 0.1, s.shape)
        else:
            gain = next((g for n, g in _GAINS.items() if n in names), 1.0)
            a = rng.normal(0.0, gain / np.sqrt(np.prod(s.shape[:-1])), s.shape)
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _tiny_batch():
    b = {k: np.array(v) for k, v in _jtsm_batch(2).items() if not k.startswith("gt_")}
    b["proposal_scores"][1, -3:] = -np.inf  # padding
    b["image_sizes"] = np.array([[56, 60], [64, 64]], np.int32)
    b["orig_sizes"] = np.array([[112, 120], [64, 64]], np.int32)
    return b


def _scene(h, w, seed):
    """Gray canvas with two stuff bands and a few saturated rectangles."""
    rng = np.random.RandomState(seed)
    img = np.full((h, w, 3), 128.0, np.float32)
    img[: h // 2] = [205, 115, 95]
    img[h // 2 :] = [95, 175, 95]
    for _ in range(4):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        img[y0 : y0 + rng.randint(20, 60), x0 : x0 + rng.randint(20, 60)] = rng.randint(55, 255, 3)
    return img + rng.randn(h, w, 3).astype(np.float32) * 3


def _gate_batch():
    """Two seeded 128x176 requests of the gate's size: 64 proposals each
    (the last five of the second padding), superpixels of
    ``compute_superpixels_grid`` and the membership of their centroids."""
    h, w, r = 128, 176, 64
    rng = np.random.RandomState(0)
    xy = rng.rand(2, r, 2) * [w - 30, h - 30]
    boxes = np.concatenate([xy, xy + rng.rand(2, r, 2) * 60 + 10], -1).astype(np.float32)
    scores = rng.rand(2, r).astype(np.float32)
    scores[1, -5:] = -np.inf
    sp = wsl_data.compute_superpixels_grid(h, w)
    return {
        "image": np.stack([_scene(h, w, 1), _scene(h, w, 2)]),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "proposals": boxes,
        "proposal_scores": scores,
        "superpixels": np.stack([sp, sp]).astype(np.int32),
        "oh_labels": np.stack([wsl_data.oh_labels_from_boxes(boxes[i], sp, 512) for i in range(2)]),
    }


_CACHE = {}


def _models(name, dtype="float32", no_paste=False):
    """(JAX config, JAX model, flax variables, the port's model with them)."""
    key = (name, dtype, no_paste)
    if key not in _CACHE:
        if name == "tiny":
            jc = _jtsm_cfg_tiny()
            if "variables" not in _CACHE:
                _CACHE["variables"] = _seeded_variables(jax_build_model(jc), _jtsm_batch(2), seed=0)
            variables = _CACHE["variables"]
        else:
            jc = _jax_cfg(jtsm_gate_cfg())
            variables = load_gate_ckpt(GATE_CKPT)
        jc.TPU.COMPUTE_DTYPE = dtype
        jc.WSL.TEST_NO_PASTE = no_paste
        cfg = wsl_cfg()
        cfg.merge_from_other_cfg(jc)
        tm = build_model(cfg, device="cpu")
        tm.load_state_dict(variables_to_state_dict(variables), strict=True)
        _CACHE[key] = (jc, jax_build_model(jc), variables, tm)
    return _CACHE[key]


def _run_jax(jm, variables, batch):
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
            variables, {k: jnp.asarray(v) for k, v in batch.items()}
        )
    return {k: np.asarray(v) for k, v in out.items()}


def _compare_slice(want, got):
    assert sorted(got) == sorted(want)
    for k in ("valid", "classes", "prop_idx", "sem_seg", "masks_full", "no_paste"):
        if k in want:
            np.testing.assert_array_equal(_np(got[k]), want[k], err_msg=k)
    for k in ("boxes", "scores", "masks", "proposal_class_scores", "sem_seg_logits"):
        if k in want:
            _close(want[k], _np(got[k]))
    assert want["valid"].sum(axis=1).min() > 0


# -- configuration ---------------------------------------------------------


@pytest.mark.parametrize("fn,path", [(jtsm_WSR_18_DC5_cfg, FLAGSHIP_YAML), (jtsm_gate_cfg, GATE_YAML)])
def test_python_configs_equal_merged_yamls(fn, path):
    cfg = wsl_cfg()
    cfg.merge_from_file(os.path.join(ROOT, path))
    assert fn().to_dict() == cfg.to_dict()
    jc = jax_get_cfg()
    jax_add_wsl_config(jc)
    jc.merge_from_file(os.path.join(ROOT, path))
    jc.MODEL.DEVICE = "cuda"
    assert jc.to_dict() == cfg.to_dict()


# -- backbone --------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "gate"])
def test_wsl_resnet_matches_jax(name):
    jc, _, variables, _ = _models(name)
    cfg = wsl_cfg()
    cfg.merge_from_other_cfg(jc)
    jb = jax_build_backbone(jc)
    tb = build_backbone(cfg)
    sub = {c: variables[c]["backbone"] for c in ("params", "frozen") if "backbone" in variables.get(c, {})}
    tb.load_state_dict(variables_to_state_dict(sub), strict=True)
    x = np.random.RandomState(3).randn(2, 72, 100, 3).astype(np.float32)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(jb.apply)(sub, jnp.asarray(x))["res5"]
    with torch.no_grad():
        got = tb(torch.from_numpy(x).permute(0, 3, 1, 2))["res5"].permute(0, 2, 3, 1)
    assert got.shape == (2, 5, 7, 512)  # stride 16: the DC5 res5 and the 2x2 stem pool
    _close(want, got.numpy())
    assert tb.output_shape()["res5"].stride == jb.output_shape()["res5"].stride == 16


# -- WSL ops ---------------------------------------------------------------


def _pool_inputs(seed, nonneg=True):
    """A 10x13 map at stride 4 over a 40x52 image, 12 superpixels, and 14
    ROIs: inside, across every border, outside the map, degenerate, and one
    with no member superpixel."""
    rng = np.random.RandomState(seed)
    h, w, c, s = 10, 13, 8, 12
    feat = rng.randn(h, w, c).astype(np.float32)
    if nonneg:
        feat = np.maximum(feat, 0)
    blocks = rng.randint(0, s, (5, 7))
    sp = np.kron(blocks, np.ones((8, 8), np.int64))[:40, :52].astype(np.int32)
    xy = rng.rand(14, 2) * [40, 30]
    boxes = np.concatenate([xy, xy + rng.rand(14, 2) * 25 + 1], 1)
    boxes[0] = [-9.3, -5.7, 20.2, 18.9]
    boxes[1] = [30.1, 25.3, 61.7, 49.2]
    boxes[2] = [70.4, 60.2, 90.6, 80.3]  # outside the map
    boxes[3] = [-30.2, -20.7, -12.1, -6.6]
    boxes[4] = [12.3, 9.1, 12.3, 9.1]  # zero area
    oh = rng.rand(14, s) > 0.4
    oh[5] = False  # no member superpixel
    return feat, boxes.astype(np.float32), sp, oh


@pytest.mark.parametrize("nonneg,ratio,grid", [(True, 1, 4), (True, 2, 1), (False, 1, 4), (False, 2, 2)])
def test_moi_pool_equals_jax(nonneg, ratio, grid):
    feat, boxes, sp, oh = _pool_inputs(1, nonneg)
    args = dict(spatial_scale=0.25, output_size=7, sampling_ratio=ratio, sp_grid_stride=grid,
                nonneg_features=nonneg)
    want = jax_wsl_ops.moi_pool(jnp.asarray(feat), jnp.asarray(boxes), jnp.asarray(sp), jnp.asarray(oh), **args)
    got = wsl_ops.moi_pool(torch.from_numpy(feat), torch.from_numpy(boxes), torch.from_numpy(sp),
                           torch.from_numpy(oh), **args)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    frac = got[1].numpy()
    assert (frac[5] == 0).all() and (frac[2] == 0).all() and 0 < frac.mean() < 1


def test_moi_pool_exact_and_roi_pool_equal_jax():
    # 4x4 bins: the JAX formulation unrolls a loop over the bins, which
    # takes XLA seconds to compile at 7x7
    feat, boxes, sp, oh = _pool_inputs(2, nonneg=False)
    j = [jnp.asarray(a) for a in (feat, boxes, sp, oh)]
    t = [torch.from_numpy(a) for a in (feat, boxes, sp, oh)]
    want = jax.jit(jax_wsl_ops.moi_pool_exact, static_argnums=(4, 5))(*j, 0.25, 4)
    got = wsl_ops.moi_pool_exact(*t, 0.25, 4)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[1].any() and not got[1].all()
    want = jax.jit(jax_wsl_ops.roi_pool, static_argnums=(2, 3))(j[0], j[1], 0.25, 7)
    got = wsl_ops.roi_pool(t[0], t[1], 0.25, 7)
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert got[1].any() and not got[1].all()


def test_membership_grids_equal_jax():
    rng = np.random.RandomState(4)
    sp = rng.randint(0, 14, (41, 53)).astype(np.int32)  # ids 12 and 13 lie outside S = 12
    oh = rng.rand(6, 12) > 0.5
    want = jax.jit(jax_wsl_ops.superpixel_membership_grid, static_argnums=2)(jnp.asarray(sp), jnp.asarray(oh), 4)
    got = wsl_ops.superpixel_membership_grid(torch.from_numpy(sp), torch.from_numpy(oh), 4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    gy = rng.randint(-2, 14, (6, 9))
    gx = rng.randint(-2, 16, (6, 7))
    y_ok, x_ok = rng.rand(6, 9) > 0.2, rng.rand(6, 7) > 0.2
    want = jax.jit(jax_wsl_ops.sample_membership_grid)(want, *map(jnp.asarray, (gy, gx, y_ok, x_ok)))
    got = wsl_ops.sample_membership_grid(got, *map(torch.from_numpy, (gy, gx, y_ok, x_ok)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- heads -----------------------------------------------------------------


def test_dan_mil_oicr_match_jax():
    rng = np.random.RandomState(5)
    x = rng.rand(10, 7, 7, 32).astype(np.float32)
    key = jax.random.key(2)
    dan = jax_rhw.DiscriminativeAdaptionNeck(dims=(48, 24))
    v_dan = jax.jit(dan.init)(key, jnp.asarray(x))
    h = np.asarray(jax.jit(dan.apply)(v_dan, jnp.asarray(x)))
    mil = jax_mil.MILOutputLayers(num_classes=9)
    v_mil = jax.jit(mil.init)(key, jnp.asarray(h))
    oicr = jax_mil.OICROutputLayers(num_classes=8, with_reg=True, reg_classes=8)
    v_oicr = jax.jit(oicr.init)(key, jnp.asarray(h))

    t_dan = DiscriminativeAdaptionNeck(7 * 7 * 32, (48, 24)).eval()
    t_dan.load_state_dict(variables_to_state_dict(v_dan), strict=True)
    t_mil = MILOutputLayers(24, 9)
    t_mil.load_state_dict(variables_to_state_dict(v_mil), strict=True)
    t_oicr = OICROutputLayers(24, 8, with_reg=True, reg_classes=8)
    t_oicr.load_state_dict(variables_to_state_dict(v_oicr), strict=True)
    with torch.no_grad():
        got_h = t_dan(torch.from_numpy(x))
        _close(h, got_h.numpy())
        th = torch.from_numpy(h.copy())
        cls_t, det_t = t_mil(th)
        logits_t, deltas_t = t_oicr(th)
    cls_j, det_j = jax.jit(mil.apply)(v_mil, jnp.asarray(h))
    logits_j, deltas_j = jax.jit(oicr.apply)(v_oicr, jnp.asarray(h))
    for a, b in ((cls_j, cls_t), (det_j, det_t), (logits_j, logits_t), (deltas_j, deltas_t)):
        _close(a, b.numpy())
    valid = np.arange(10) % 4 != 3
    want = jax.jit(jax_mil.wsddn_scores)(cls_j, det_j, jnp.asarray(valid))
    got = wsddn_scores(torch.tensor(np.asarray(cls_j)), torch.tensor(np.asarray(det_j)), torch.from_numpy(valid))
    _close(want, got.numpy())
    assert (got.numpy()[~valid] == 0).all()


@pytest.mark.parametrize("candidates", [1024, 20])
def test_wsl_inference_with_ties_matches_jax(candidates):
    rng = np.random.RandomState(6)
    b, r, c = 2, 12, 5
    scores = rng.choice([0.1, 0.2, 0.3], (b, r, c)).astype(np.float32)  # many ties
    xy = rng.rand(b, r, c, 2) * 40
    boxes = np.concatenate([xy, xy + rng.rand(b, r, c, 2) * 30 + 2], -1).astype(np.float32)
    boxes[:, 1] = boxes[:, 0]  # identical boxes
    valid = rng.rand(b, r) > 0.2
    sizes = np.array([[48, 60], [60, 48]], np.int32)
    args = (0.15, 0.3, 40, candidates)
    want = jax.jit(jax.vmap(lambda bx, sc, v, sz: jax_rhw.wsl_inference_single(bx, sc, v, sz, *args)))(
        *map(jnp.asarray, (boxes, scores, valid, sizes))
    )
    got = wsl_inference(*map(torch.from_numpy, (boxes, scores, valid, sizes)), *args)
    assert sorted(got) == sorted(want)
    for k in ("classes", "valid", "prop_idx"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    _close(want["boxes"], got["boxes"].numpy())
    _close(want["scores"], got["scores"].numpy())
    assert got["valid"].any() and not got["valid"].all()


def test_stuff_heads_and_bilinear_match_jax():
    rng = np.random.RandomState(7)
    feats = rng.rand(2, 8, 11, 512).astype(np.float32)
    want, _ = JaxTwoClassHead().apply({}, {"res5": jnp.asarray(feats)})
    got = TwoClassHead()({"res5": torch.from_numpy(feats).permute(0, 3, 1, 2)})
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))

    jc, jm, variables, tm = _models("gate")
    sem = {"params": variables["params"]["sem_seg_head"]}
    with jax.default_matmul_precision("highest"):
        want, _ = jax.jit(jm.sem_seg_head.clone(parent=None).apply)(sem, {"res5": jnp.asarray(feats)})
    with torch.no_grad():
        got = tm.sem_seg_head({"res5": torch.from_numpy(feats).permute(0, 3, 1, 2)})
    assert got.shape == (2, 54, 32, 44)  # the common stride 4 from stride 16
    _close(want, got.permute(0, 2, 3, 1).numpy())

    # the gate's and the flagship's ratios, and a downscale
    for (h, w), (oh, ow), ch in (((32, 44), (128, 176), 54), ((64, 64), (1024, 1024), 2), ((9, 7), (4, 5), 3)):
        x = rng.randn(1, h, w, ch).astype(np.float32)
        want = jax.jit(jax_interpolate_bilinear, static_argnums=1)(jnp.asarray(x), (oh, ow))
        got = interpolate_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), (oh, ow))
        _close(want, got.permute(0, 2, 3, 1).numpy(), 1e-6)


def test_request_helpers_equal_jax():
    rng = np.random.RandomState(8)
    sp = wsl_data.compute_superpixels_grid(70, 90, cell=12)
    np.testing.assert_array_equal(sp, jax_wsl_data.compute_superpixels_grid(70, 90, cell=12))
    xy = rng.rand(9, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(9, 2) * 40], 1).astype(np.float32)
    for cap in (64, 20):  # room for every id; fewer slots than ids
        np.testing.assert_array_equal(wsl_data.oh_labels_from_boxes(boxes, sp, cap),
                                      jax_wsl_data.oh_labels_from_boxes(boxes, sp, cap))

    def batch():
        return {"image": np.zeros((3, 80, 96, 3), np.float32), "proposals": np.zeros((3, 12, 4), np.float32)}

    per_image = [
        {"image": np.zeros((70, 90, 3)), "proposals": {"boxes": boxes}},
        {"image": np.zeros((64, 80, 3)),
         "proposals": {"superpixels": sp[:64, :80] + 40, "oh_labels": rng.rand(15, 70) > 0.5}},
        {"image": np.zeros((60, 60, 3)), "proposals": {}},
    ]
    want, got = batch(), batch()
    jax_wsl_data.add_wsl_batch_fields(want, per_image, 48)
    wsl_data.add_wsl_batch_fields(got, per_image, 48)
    for k in ("superpixels", "oh_labels"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["oh_labels"].any()


# -- the slice ---------------------------------------------------------------


@pytest.mark.parametrize("name", ["tiny", "gate"])
def test_variables_round_trip_every_key(name):
    jc, _, variables, tm = _models(name)
    state = variables_to_state_dict(variables)
    assert set(state) == set(tm.state_dict())
    back, matched, unmatched = convert_d2_state_dict_to_variables(
        {k: v.numpy() for k, v in state.items()}, variables
    )
    # the JAX package's mapping has no group norm (flax keeps its scale under
    # GroupNorm_0); those keys are checked against the flax leaves directly
    assert set(unmatched) == {k for k in state if k.startswith("sem_seg_head.") and ".norm." in k}
    assert len(matched) + len(unmatched) == len(state)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert len(leaves) == len(state)
    for path, leaf in leaves:
        names = [p.key for p in path]
        if "GroupNorm_0" in names:
            key = ".".join(names[1:-3] + ["norm", {"scale": "weight"}.get(names[-1], names[-1])])
            np.testing.assert_array_equal(state[key].numpy(), leaf)
        else:
            np.testing.assert_array_equal(np.asarray(flat_b[path]), leaf)


def test_tiny_slice_random_weights_matches_jax():
    _, jm, variables, tm = _models("tiny")
    batch = _tiny_batch()
    want = _run_jax(jm, variables, batch)
    got = tm.inference(batch)
    _compare_slice(want, got)
    assert got["masks"].shape == (2, 100, 28, 28)
    assert got["sem_seg_logits"].shape == (2, 64, 64, 54)


@pytest.mark.parametrize("no_paste", [False, True])
def test_gate_checkpoint_slice_matches_jax(no_paste):
    _, jm, variables, tm = _models("gate", no_paste=no_paste)
    batch = _gate_batch()
    want = _run_jax(jm, variables, batch)
    got = tm.inference(batch)
    _compare_slice(want, got)
    if no_paste:
        assert got["masks_full"].shape == (2, 100, 128, 176) and got["masks_full"].any()


def test_mask_branch_on_given_boxes_matches_jax():
    _, jm, variables, tm = _models("gate")
    batch = _gate_batch()
    rng = np.random.RandomState(9)
    xy = rng.rand(2, 6, 2) * 100
    batch["detected_boxes"] = np.concatenate([xy, xy + rng.rand(2, 6, 2) * 60 + 4], -1).astype(np.float32)
    batch["detected_classes"] = rng.randint(0, 80, (2, 6)).astype(np.int32)
    want = _run_jax(jm, variables, batch)
    got = tm.inference(batch)
    assert sorted(got) == sorted(want) == ["boxes", "classes", "masks", "scores", "valid"]
    _close(want["masks"], got["masks"].numpy())


def test_tiny_slice_bf16_matches_jax():
    _, jm, variables, tm = _models("tiny", dtype="bfloat16")
    assert tm.roi_heads.dan.dan1.compute_dtype == torch.bfloat16
    batch = _tiny_batch()
    want = _run_jax(jm, variables, batch)
    got = tm.inference(batch)
    _close(want["proposal_class_scores"], got["proposal_class_scores"].numpy(), 2e-2)
    _close(want["sem_seg_logits"], got["sem_seg_logits"].numpy(), 2e-2)
    given = dict(batch, detected_boxes=want["boxes"], detected_classes=want["classes"])
    want_m = _run_jax(jm, variables, given)
    got_m = tm.inference(given)
    _close(want_m["masks"], got_m["masks"].numpy(), 2e-2)


def test_predictor_serves_jtsm_requests():
    cfg = jtsm_gate_cfg()
    model = build_model(cfg, device="cpu")
    predictor = Predictor(cfg, random_state_dict(model, seed=0), device="cpu")
    out = predictor(_gate_batch())
    assert out["boxes"].shape == (2, 100, 4) and out["masks"].shape == (2, 100, 28, 28)
    assert out["sem_seg"].shape == (2, 128, 176) and out["valid"].any()
    for v in out.values():
        assert torch.isfinite(v.float()).all()
