"""The port's test-time augmentation on the CPU against the JAX package:
Pillow's float ``BILINEAR`` resize written out, the index forms of NMS, the
given-boxes branch of ``GeneralizedRCNN``, the cases of ``tests/test_tta.py``
run through both packages' wrappers, the Mask R-CNN gate checkpoint through
both ``test_with_TTA`` (TTA-UNION), and the JTSM gate checkpoint through both
WSL ``test_with_TTA`` (TTA-AVG with the mask re-run, the panoptic fusion and
the COCO, sem-seg and panoptic evaluators). The last stands in for the JAX
package's ``tests/test_wsl_tta_eval.py``, whose VGG backbone the port does
not have yet: the same flow on the port's WSL ResNet.

Tolerances: the float resize equal to Pillow bit for bit (it is: every
pair of the sweeps); NMS indices equal; the given-boxes masks within 1e-4
of scale; merged detections matched by class and box (boxes within 1e-3
px, scores within 1e-5: float32 on both sides, different summation orders,
and the JTSM gate's WSDDN-scale scores tie to float noise), mask
probabilities within 1e-5, pasted masks equal but for pixels within float
noise of 0.5, the merged sem-seg logits within 1e-5, every printed number
within 1e-4.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import jtsm_tpu.modeling.test_time_augmentation as jax_tta
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.ops.nms import batched_nms as jax_batched_nms
from jtsm_tpu.ops.nms import nms as jax_nms
from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg, wsl_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data.transforms import ResizeTransform, resize_bilinear_float, resize_nearest
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.modeling import test_time_augmentation as tta
from jtsm_tpu_torch.ops.nms import batched_nms, nms
from tests.modeling.test_meta_archs import _fpn_tiny
from tests.test_torch_jtsm_scoring import _assert_same_results


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
JTSM_YAML = os.path.join(ROOT, "projects/WSL/configs/quick_schedules/jtsm_synthetic_inference_acc_test.yaml")
MRCNN_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml")
# the gate scenes (240-320 x 320-400) at short sides 112 and 128 with the long
# side at most 176 all fit the gates' buckets [[128, 176], [176, 176]]
GATE_AUG = {"MIN_SIZES": (112, 128), "MAX_SIZE": 176}
FLAGSHIP_SIZES = (480, 576, 688, 864, 1200)


def _close(want, got, atol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), rtol=0, atol=atol)


# (a) Pillow's F-mode bilinear resize


def _pillow_float(img, h, w):
    """The JAX package's float resize: each channel in ``F`` mode."""
    chans = img[..., None] if img.ndim == 2 else img
    out = [np.asarray(Image.fromarray(chans[..., c].astype(np.float32), mode="F").resize((w, h), Image.BILINEAR))
           for c in range(chans.shape[-1])]
    return np.stack(out, -1).reshape((h, w) + img.shape[2:])


def test_float_resize_equals_pillow_on_every_pair_to_40():
    rng = np.random.default_rng(0)
    for a in range(1, 41):
        src_h = (rng.standard_normal((a, 3)) * 100).astype(np.float32)
        src_w = (rng.standard_normal((3, a)) * 100).astype(np.float32)
        for b in range(1, 41):
            np.testing.assert_array_equal(resize_bilinear_float(src_h, b, 3), _pillow_float(src_h, b, 3), (a, b))
            np.testing.assert_array_equal(resize_bilinear_float(src_w, 3, b), _pillow_float(src_w, 3, b), (a, b))


def test_float_resize_equals_pillow_on_seeded_pairs():
    rng = np.random.default_rng(1)
    for _ in range(300):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 160, 4))
        img = (rng.standard_normal((h, w)) * rng.choice([1.0, 300.0])).astype(np.float32)
        np.testing.assert_array_equal(resize_bilinear_float(img, nh, nw), _pillow_float(img, nh, nw), (h, w, nh, nw))


@pytest.mark.parametrize("short", FLAGSHIP_SIZES)
def test_float_resize_of_a_voc_image_to_each_flagship_view_and_back(short):
    """A 375x500 image to the view ``short`` gives it (the image, three
    channels, upscaled) and back (two logit maps, downscaled), both
    through ``ResizeTransform`` as the TTA calls it."""
    from jtsm_tpu_torch.data.transforms import ResizeShortestEdge

    rng = np.random.default_rng(short)
    img = rng.uniform(0, 255, (375, 500, 3)).astype(np.float32)
    nh, nw = ResizeShortestEdge.get_output_shape(375, 500, short, 4000)
    up = ResizeTransform(375, 500, nh, nw).apply_image(img)
    np.testing.assert_array_equal(up, _pillow_float(img, nh, nw))
    logits = (rng.standard_normal((nh, nw, 2)) * 5).astype(np.float32)
    np.testing.assert_array_equal(resize_bilinear_float(logits, 375, 500), _pillow_float(logits, 375, 500))


def test_nearest_resize_of_int32_ids_equals_pillow_i_mode():
    rng = np.random.default_rng(2)
    for _ in range(100):
        h, w, nh, nw = (int(v) for v in rng.integers(1, 120, 4))
        ids = rng.integers(0, 1 << 20, (h, w)).astype(np.int32)
        got = resize_nearest(ids, nh, nw)
        want = np.asarray(Image.fromarray(ids, mode="I").resize((nw, nh), Image.NEAREST), np.int32)
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got, want)


# (b) the index forms of NMS


@pytest.mark.parametrize("max_out", [None, 5, 24, 40])
def test_nms_and_batched_nms_indices_equal_jax(max_out):
    """Scores quantised to a few values (ties), -inf padding, overlapping
    boxes of three classes; ``max_out`` below, at and above N (one N, so
    that the JAX package compiles once)."""
    rng = np.random.default_rng(3)
    n = 24
    for _ in range(10):
        xy = rng.uniform(0, 50, (n, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(5, 30, (n, 2))], 1).astype(np.float32)
        scores = (rng.integers(0, 4, n) / 4.0).astype(np.float32)
        scores[rng.random(n) < 0.2] = -np.inf
        classes = rng.integers(0, 3, n).astype(np.int32)
        want = np.asarray(jax_nms(jnp.asarray(boxes), jnp.asarray(scores), 0.5, max_out=max_out))
        got = nms(torch.as_tensor(boxes), torch.as_tensor(scores), 0.5, max_out=max_out)
        np.testing.assert_array_equal(got.numpy(), want)
        want = np.asarray(jax_batched_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes), 0.5,
                                          max_out=max_out))
        got = batched_nms(torch.as_tensor(boxes), torch.as_tensor(scores), torch.as_tensor(classes), 0.5,
                          max_out=max_out)
        np.testing.assert_array_equal(got.numpy(), want)


# (c) the given-boxes branch on the tiny config


def test_given_boxes_branch_equals_jax_on_the_tiny_config():
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    rng = np.random.RandomState(0)
    h, w, d = 64, 96, 6
    batch = {
        "image": (rng.rand(1, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h - 8, w - 20]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w]], np.int32),
    }
    jm = jax_build_model(cfg)
    variables = jax.jit(lambda k, x: jm.init({"params": k}, x, train=False))(
        jax.random.key(0), {k: jnp.asarray(v) for k, v in batch.items()})
    variables = jax.tree_util.tree_map(np.asarray, variables)
    xy = rng.rand(d, 2) * [w - 40, h - 30]
    given = dict(batch, detected_boxes=np.concatenate([xy, xy + rng.rand(d, 2) * 30 + 4], 1)[None].astype(np.float32),
                 detected_classes=rng.randint(0, 5, (1, d)).astype(np.int32),
                 detected_valid=np.array([[True] * (d - 1) + [False]]))
    with jax.default_matmul_precision("highest"):
        want = jax.jit(lambda v, b: jm.apply(v, b, train=False))(
            variables, {k: jnp.asarray(v) for k, v in given.items()})
    tcfg = get_cfg()
    tcfg.merge_from_other_cfg(cfg)
    tm = build_model(tcfg, device="cpu")
    tm.load_state_dict(variables_to_state_dict(variables), strict=True)
    got = tm.inference(given)
    assert sorted(got) == sorted(want) == ["boxes", "classes", "masks", "scores", "valid"]
    np.testing.assert_array_equal(got["boxes"].numpy(), given["detected_boxes"])  # network-input coordinates
    np.testing.assert_array_equal(got["valid"].numpy(), np.asarray(want["valid"]))
    assert got["masks"].shape == (1, d, 28, 28)
    _close(np.asarray(want["masks"]), got["masks"].numpy(), 1e-4)


# (d) the cases of tests/test_tta.py through both packages' wrappers


def _image(h=96, w=128):
    img = np.zeros((h, w, 3), np.float32)
    img[40:50, 60:70] = 255.0  # a bright patch: box (60, 40, 70, 50)
    return img


def _patch_detector(masks=False):
    """Finds the bright patch in each view; boxes mapped to the original."""
    def predict(batch):
        if "detected_boxes" in batch:
            d = batch["detected_boxes"].shape[1]
            grad = np.tile(np.linspace(0, 1, 8, dtype=np.float32), (8, 1))
            # the patch's centre lies right of the image's (x 65 of 128),
            # and left of it in a flipped view
            flipped = batch["detected_boxes"][0, 0, 0] + batch["detected_boxes"][0, 0, 2] < batch["image_sizes"][0][1]
            m = grad[::-1, ::-1] if flipped else grad
            return {"masks": np.tile(m[None, None], (1, d, 1, 1)), "boxes": batch["detected_boxes"]}
        im = batch["image"][0]
        hh, ww = (int(v) for v in batch["image_sizes"][0])
        oh, ow = (int(v) for v in batch["orig_sizes"][0])
        ys, xs = np.nonzero(im[..., 0] > 128)
        sx, sy = ow / ww, oh / hh
        box = np.asarray([[xs.min() * sx, ys.min() * sy, (xs.max() + 1) * sx, (ys.max() + 1) * sy]], np.float32)
        out = {"boxes": box[None], "scores": np.asarray([[0.9]], np.float32), "classes": np.asarray([[2]], np.int32),
               "valid": np.asarray([[True]])}
        if masks:
            out["masks"] = np.zeros((1, 1, 8, 8), np.float32)
        return out
    return predict


def _union(predict, min_sizes, buckets, image, **kw):
    """The merged result of both packages' UNION wrappers."""
    args = dict(min_sizes=min_sizes, max_size=200, flip=True, buckets=buckets)
    return (jax_tta.GeneralizedRCNNWithTTAUNION(predict, **args)(image, **kw),
            tta.GeneralizedRCNNWithTTAUNION(predict, device="cpu", **args)(image, **kw))


def _same(want, got):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


def test_union_maps_boxes_back_to_the_original():
    want, got = _union(_patch_detector(), (64, 96), ((256, 256),), _image(), topk=10, nms_thresh=0.5)
    _same(want, got)
    assert len(got["boxes"]) >= 1 and got["classes"][0] == 2
    for b in got["boxes"]:
        assert np.allclose(b, [60, 40, 70, 50], atol=2.5), b


def test_union_equals_brute_force_union_then_nms():
    h0, w0 = 40, 60
    img = np.zeros((h0, w0, 3), np.float32)
    img[0, 0, 0] = 255.0  # the view is unflipped iff pixel (0, 0) is hot
    plain = (np.asarray([[0, 0, 10, 10], [20, 5, 30, 15]], np.float32), np.asarray([0.9, 0.8], np.float32),
             np.asarray([0, 1], np.int32))
    mirrored = (np.asarray([[w0 - 12, 0, w0 - 2, 10], [w0 - 50, 20, w0 - 40, 30]], np.float32),
                np.asarray([0.85, 0.7], np.float32), np.asarray([0, 0], np.int32))

    def predict(batch):
        b, s, c = plain if batch["image"][0, 0, 0, 0] > 128 else mirrored
        return {"boxes": b[None], "scores": s[None], "classes": c[None], "valid": np.ones((1, len(b)), bool)}

    want, got = _union(predict, (40,), ((64, 64),), img, topk=10, nms_thresh=0.5)
    _same(want, got)
    ub = np.concatenate([plain[0], np.stack([w0 - mirrored[0][:, 2], mirrored[0][:, 1], w0 - mirrored[0][:, 0],
                                             mirrored[0][:, 3]], 1)])
    us, uc = np.concatenate([plain[1], mirrored[1]]), np.concatenate([plain[2], mirrored[2]])

    def iou(a, b):
        inter = max(0.0, min(a[2], b[2]) - max(a[0], b[0])) * max(0.0, min(a[3], b[3]) - max(a[1], b[1]))
        return inter / ((a[2] - a[0]) * (a[3] - a[1]) + (b[2] - b[0]) * (b[3] - b[1]) - inter)

    keep = []
    for i in np.argsort(-us):
        if all(uc[i] != uc[j] or iou(ub[i], ub[j]) <= 0.5 for j in keep):
            keep.append(int(i))
    order = np.argsort(-got["scores"])
    np.testing.assert_allclose(got["boxes"][order], ub[keep], atol=1e-4)
    np.testing.assert_array_equal(got["classes"][order], uc[keep])
    assert len(got["boxes"]) == 3


def test_union_mask_rerun_averages_unflipped_views():
    want, got = _union(_patch_detector(masks=True), (64,), ((256, 256),), _image(), topk=4, nms_thresh=0.5)
    _same(want, got)
    grad = np.tile(np.linspace(0, 1, 8, dtype=np.float32), (8, 1))
    np.testing.assert_allclose(got["masks"][0], (grad + grad[::-1, ::-1][:, ::-1]) / 2, atol=1e-6)


def _avg(predict, image, proposals, scores, min_sizes=(64, 96), buckets=((256, 256),), **kw):
    args = dict(min_sizes=min_sizes, max_size=200, flip=True, buckets=buckets)
    return (jax_tta.GeneralizedRCNNWithTTAAVG(predict, **args)(image, proposals, scores, predict, **kw),
            tta.GeneralizedRCNNWithTTAAVG(predict, device="cpu", **args)(image, proposals, scores, predict, **kw))


def _same_avg(want, got):
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "detections":
            _same(want[k], got[k])
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_avg_scores_and_detections():
    rng = np.random.RandomState(0)
    r, c = 8, 3
    proposals = np.concatenate([rng.rand(r, 2) * 40, 50 + rng.rand(r, 2) * 40], 1).astype(np.float32)
    scores = np.zeros((r,), np.float32)
    scores[-2:] = -np.inf
    proposals[-2:] = 0

    def predict(batch):
        p = batch["proposals"][0]
        hh, ww = (float(v) for v in batch["image_sizes"][0])
        area = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1]) / (hh * ww)
        return {"proposal_class_scores": np.stack([area * (k + 1) / c for k in range(c)], 1).astype(np.float32)[None]}

    img = _image()
    want, got = _avg(predict, img, proposals, scores, score_thresh=1e-6, nms_thresh=0.3, topk=5)
    _same_avg(want, got)
    area0 = (proposals[:, 2] - proposals[:, 0]) * (proposals[:, 3] - proposals[:, 1]) / (96 * 128)
    assert np.allclose(got["proposal_class_scores"], np.stack([area0 * (k + 1) / c for k in range(c)], 1),
                       rtol=0.05, atol=1e-4)
    assert int(got["detections"]["classes"][0]) == c - 1
    assert np.allclose(got["detections"]["boxes"][0], proposals[np.argmax(area0[:-2])], atol=1e-3)


def test_avg_threads_superpixels_per_view():
    rng = np.random.RandomState(1)
    r, s, h0 = 6, 16, 128
    proposals = np.concatenate([rng.rand(r, 2) * 40, 50 + rng.rand(r, 2) * 40], 1).astype(np.float32)
    sp = np.full((h0, h0), 3, np.int32)
    sp[:, h0 // 2:] = 7
    oh = rng.rand(r, s) > 0.5
    seen = []

    def predict(batch):
        hh, ww = (int(v) for v in batch["image_sizes"][0])
        spv = batch["superpixels"][0]
        assert spv.shape == batch["image"].shape[1:3] and spv.dtype == np.int32
        np.testing.assert_array_equal(batch["oh_labels"][0], oh)
        seen.append(int(spv[hh // 2, 0]))
        assert int(spv[hh // 2, ww - 1]) == (3 if seen[-1] == 7 else 7)
        return {"proposal_class_scores": np.ones((1, r, 2), np.float32)}

    want, got = _avg(predict, np.zeros((h0, h0, 3), np.float32), proposals, np.zeros((r,), np.float32),
                     min_sizes=(64,), buckets=((96, 96),), topk=4, superpixels=sp, oh_labels=oh)
    _same_avg(want, got)
    assert seen == [3, 7, 3, 7]  # each package: the view, then its flip


def test_avg_mask_rerun_averages_unflipped_views():
    r, c, s = 4, 2, 6
    proposals = np.asarray([[10.0, 10, 60, 60], [20.0, 20, 80, 80], [0.0, 0, 30, 30], [5.0, 5, 90, 90]], np.float32)
    base = np.zeros((s, s), np.float32)
    base[:, : s // 2] = 1.0
    calls = []

    def predict(batch):
        hh, ww = (float(v) for v in batch["image_sizes"][0])
        d_boxes = batch.get("detected_boxes")
        if d_boxes is None:
            p = batch["proposals"][0]
            area = (p[:, 2] - p[:, 0]) * (p[:, 3] - p[:, 1]) / (hh * ww)
            scores = np.stack([area * (k + 1) / c for k in range(c)], 1).astype(np.float32)
            return {"proposal_class_scores": scores[None], "masks": np.zeros((1, 1, s, s), np.float32)}
        calls.append(1)
        flipped = d_boxes[0, 0, 0] + d_boxes[0, 0, 2] > ww
        return {"masks": np.tile(base[:, ::-1] if flipped else base, (1, d_boxes.shape[1], 1, 1))}

    want, got = _avg(predict, _image(), proposals, np.zeros((r,), np.float32), min_sizes=(64,),
                     score_thresh=1e-6, nms_thresh=0.3, topk=4)
    _same_avg(want, got)
    assert len(calls) == 4  # two views in each package
    for m in got["detections"]["masks"]:
        np.testing.assert_allclose(m, base, atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_view_mappers_equal_jax(dtype):
    """``DatasetMapperTTA`` and ``DatasetMapperTTAAVG`` (and its UNION
    alias) on a record with proposals and a superpixel map: the same views
    in the same order, key for key (a uint8 image through Pillow's 8-bit
    resize, a float one through its ``F`` mode)."""
    rng = np.random.default_rng(4)
    record = {"image": (rng.random((50, 70, 3)) * 255).astype(dtype), "image_id": 3,
              "proposals": np.asarray([[1.0, 2, 30, 40], [10, 5, 69, 49]], np.float32),
              "superpixels": rng.integers(0, 40, (50, 70)).astype(np.int32)}
    args = dict(min_sizes=(40, 64), max_size=100, flip=True)
    for name in ("DatasetMapperTTA", "DatasetMapperTTAAVG", "DatasetMapperTTAUNION"):
        want = getattr(jax_tta, name)(**args)(record)
        got = getattr(tta, name)(**args)(record)
        assert len(got) == len(want) == 4
        for w, g in zip(want, got):
            assert sorted(g) == sorted(w)
            for k in w:
                np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]), err_msg=(name, k))
                assert np.asarray(g[k]).dtype == np.asarray(w[k]).dtype, (name, k)


# (e) a view that fits no bucket


def test_flagship_1200_view_of_a_voc_image_fits_no_default_bucket():
    """At the default buckets the 1200 view of a 375x500 image is 1200x1600:
    no bucket holds it, and both packages raise. The other four flagship
    views fit, in the same buckets in both (480 in (1024, 1024), the
    smaller area)."""
    img = np.zeros((375, 500, 3), np.float32)
    props, scores = np.asarray([[0.0, 0, 50, 50]], np.float32), np.zeros((1,), np.float32)

    def predict(batch):
        raise AssertionError("no view reaches the model")

    with pytest.raises(ValueError):
        jax_tta.GeneralizedRCNNWithTTAAVG(predict, min_sizes=(1200,), max_size=4000)(img, props, scores, predict)
    with pytest.raises(ValueError, match="1200 view of a 375x500 image is 1200x1600"):
        tta.GeneralizedRCNNWithTTAAVG(predict, min_sizes=(1200,), max_size=4000)(img, props, scores, predict)
    args = dict(min_sizes=FLAGSHIP_SIZES[:4], max_size=4000)
    want, got = ([b["image"].shape for b, _ in pkg.GeneralizedRCNNWithTTA(predict, **args)._augmented_batches(
        img, (375, 500))] for pkg in (jax_tta, tta))
    assert got == want and got[0] == (1, 1024, 1024, 3)


# (f) the gates through both packages' test_with_TTA


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tta") / "datasets"
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8"], check=True, capture_output=True, cwd=ROOT)
    return str(root)


def _subset_json(src, dst, n):
    """The first ``n`` images of a COCO-style json and their annotations."""
    data = json.load(open(src))
    data["images"] = data["images"][:n]
    ids = {im["id"] for im in data["images"]}
    data["annotations"] = [a for a in data["annotations"] if a["image_id"] in ids]
    json.dump(data, open(dst, "w"))
    return dst


def _record(monkeypatch, cls, log):
    call = cls.__call__

    def recording(self, *args, **kwargs):
        log.append(call(self, *args, **kwargs))
        return log[-1]

    monkeypatch.setattr(cls, "__call__", recording)


def _match(want, got, score_tol):
    """Pairs of detections (JAX index, port index): each port detection
    with the free JAX one of its class whose box lies within 1e-3 px and
    score within ``score_tol``."""
    free, pairs = list(range(len(want["boxes"]))), []
    for i in range(len(got["boxes"])):
        for n, j in enumerate(free):
            if (got["classes"][i] == want["classes"][j] and np.abs(got["boxes"][i] - want["boxes"][j]).max() <= 1e-3
                    and abs(got["scores"][i] - want["scores"][j]) <= score_tol):
                pairs.append((j, i))
                free.pop(n)
                break
        else:
            raise AssertionError(f"detection {i} has no match")
    assert not free
    return pairs


def _numbers_equal(want, got):
    assert sorted(got) == sorted(want)
    for task in want:
        assert sorted(got[task]) == sorted(want[task]), task
        for k, w in want[task].items():
            g = got[task][k]
            assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= 1e-4, (task, k, g, w)


def _cleanup(*names):
    for catalog in (JaxDatasetCatalog, DatasetCatalog, JaxMetadataCatalog, MetadataCatalog):
        for n in names:
            catalog.remove(n)


def test_mask_rcnn_gate_tta_equals_jax(tree, tmp_path, monkeypatch):
    """The gate checkpoint on 2 scenes of its tree, 2 sizes and their flips:
    the merged detections and masks of each image and the bbox numbers
    (the JAX package hands the evaluator no masks)."""
    from jtsm_tpu.data.datasets.coco import register_coco_instances as jax_register
    from jtsm_tpu.engine.defaults import DefaultTrainer
    from jtsm_tpu_torch.data.datasets.coco import register_coco_instances
    from jtsm_tpu_torch.engine import test

    name = "torch_test_tta_coco"
    args = (_subset_json(os.path.join(tree, "coco/annotations/instances_val2017_100.json"),
                         str(tmp_path / "instances.json"), 2), os.path.join(tree, "coco/val2017"))
    jax_register(name, {}, *args)
    register_coco_instances(name, {}, *args)
    jcfg, cfg = jax_get_cfg(), get_cfg()
    for c, out in ((jcfg, "jax"), (cfg, "port")):
        c.merge_from_file(MRCNN_YAML)
        c.DATASETS.TEST = (name,)
        c.TEST.AUG.ENABLED = True
        c.TEST.AUG.MIN_SIZES, c.TEST.AUG.MAX_SIZE = GATE_AUG["MIN_SIZES"], GATE_AUG["MAX_SIZE"]
        c.OUTPUT_DIR = str(tmp_path / out)
    variables = load_gate_ckpt(os.path.join(ROOT, cfg.MODEL.WEIGHTS))
    merged = {"jax": [], "port": []}
    _record(monkeypatch, jax_tta.GeneralizedRCNNWithTTA, merged["jax"])
    _record(monkeypatch, tta.GeneralizedRCNNWithTTA, merged["port"])
    try:
        with jax.default_matmul_precision("highest"):
            want = DefaultTrainer.test_with_TTA(jcfg, jax_build_model(jcfg), variables)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(variables_to_state_dict(variables), strict=True)
        got = test(cfg, model)
    finally:
        _cleanup(name)
    _numbers_equal(want, got)
    assert sorted(got) == ["bbox"] and got["bbox"]["AP"] > 10
    assert len(merged["port"]) == len(merged["jax"]) == 2
    for w, g in zip(merged["jax"], merged["port"]):
        assert len(g["boxes"]) > 0
        for j, i in _match(w, g, 1e-5):
            _close(w["masks"][j], g["masks"][i], 1e-5)


def _register_cocovar(tree, tmp_path, name, n):
    """The first ``n`` cocovar scenes as a separated panoptic set in both
    packages (their jsons cut to them)."""
    from jtsm_tpu.data.datasets.builtin import register_coco_panoptic_separated as jax_register
    from jtsm_tpu.data.datasets.builtin_meta import _get_builtin_metadata as jax_meta
    from jtsm_tpu_torch.data.datasets.builtin import register_coco_panoptic_separated
    from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata

    var = os.path.join(tree, "cocovar")
    panoptic = _subset_json(os.path.join(var, "annotations/panoptic_val2017_100.json"), str(tmp_path / "pan.json"), n)
    instances = _subset_json(os.path.join(var, "annotations/instances_val2017_100.json"), str(tmp_path / "ins.json"), n)
    paths = (os.path.join(var, "val2017"), os.path.join(var, "panoptic_val2017_100"), panoptic,
             os.path.join(var, "panoptic_stuff_val2017_100"), instances)
    jax_register(name, jax_meta("coco_panoptic_separated"), *paths)
    register_coco_panoptic_separated(name, _get_builtin_metadata("coco_panoptic_separated"), *paths)
    return name + "_separated", os.path.join(var, "proposals_val2017_100.pkl")


def _jax_wsl_trainer():
    spec = importlib.util.spec_from_file_location("wsl_train_net_torch_tta",
                                                  os.path.join(ROOT, "projects/WSL/tools/train_net.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod.Trainer


def test_jtsm_gate_tta_equals_jax(tree, tmp_path, monkeypatch):
    """The JTSM gate checkpoint on 3 cocovar scenes, 2 sizes and their
    flips, through both WSL ``test_with_TTA``: the merged class scores and
    sem-seg logits, the detections and their re-run masks, the COCO result
    lists and the four tasks' numbers."""
    from jtsm_tpu.wsl import add_wsl_config
    from jtsm_tpu_torch.wsl import train_net

    name, proposals = _register_cocovar(tree, tmp_path, "torch_test_tta_cocovar", 3)
    jcfg, cfg = jax_get_cfg(), wsl_cfg()
    add_wsl_config(jcfg)
    for c, out in ((jcfg, "jax"), (cfg, "port")):
        c.merge_from_file(JTSM_YAML)
        c.DATASETS.TEST = c.DATASETS.TRAIN = (name,)
        c.DATASETS.PROPOSAL_FILES_TEST = (proposals,)
        c.TEST.AUG.ENABLED = True
        c.TEST.AUG.MIN_SIZES, c.TEST.AUG.MAX_SIZE = GATE_AUG["MIN_SIZES"], GATE_AUG["MAX_SIZE"]
        c.OUTPUT_DIR = str(tmp_path / out)
    variables = load_gate_ckpt(os.path.join(ROOT, cfg.MODEL.WEIGHTS))
    merged = {"jax": [], "port": []}
    _record(monkeypatch, jax_tta.GeneralizedRCNNWithTTAAVG, merged["jax"])
    _record(monkeypatch, tta.GeneralizedRCNNWithTTAAVG, merged["port"])
    try:
        with jax.default_matmul_precision("highest"):
            want = _jax_wsl_trainer().test_with_TTA(jcfg, jax_build_model(jcfg), variables)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(variables_to_state_dict(variables), strict=True)
        timings = {}
        got = train_net.test_with_TTA(cfg, model, timings)
    finally:
        _cleanup(name, name.replace("_separated", "_stuffonly"))
    _numbers_equal(want, got)
    assert sorted(got) == ["bbox", "panoptic_seg", "segm", "sem_seg"]
    assert timings["images"] == 3 and timings["tta_rerun"] > 0
    assert len(merged["port"]) == len(merged["jax"]) == 3
    for w, g in zip(merged["jax"], merged["port"]):
        _close(w["proposal_class_scores"], g["proposal_class_scores"], 1e-5)
        _close(w["sem_seg_logits"], g["sem_seg_logits"], 1e-5)
        wd, gd = w["detections"], g["detections"]
        assert len(gd["boxes"]) == 100
        for j, i in _match(wd, gd, 1e-5):
            _close(wd["masks"][j], gd["masks"][i], 1e-5)
    read = [json.load(open(os.path.join(str(tmp_path / k), "inference", "coco_instances_results.json")))
            for k in ("port", "jax")]
    _assert_same_results(*read)


def test_tta_off_scores_through_the_plain_loop(monkeypatch):
    """With TEST.AUG.ENABLED False (the gates') neither ``test_with_TTA``
    runs: the WSL command scores through ``engine.test`` and its loader,
    as in PR 10."""
    from jtsm_tpu_torch.config import jtsm_gate_cfg
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_cocovar
    from jtsm_tpu_torch.engine import defaults as engine_defaults
    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.tools.train_net import load_weights
    from jtsm_tpu_torch.wsl import train_net

    def refuse(*args, **kwargs):
        raise AssertionError("test_with_TTA ran with TEST.AUG.ENABLED False")

    for mod in (train_net, engine_defaults):
        monkeypatch.setattr(mod, "test_with_TTA", refuse)
    name = "torch_test_tta_off"
    cfg = jtsm_gate_cfg()
    assert not cfg.TEST.AUG.ENABLED
    cfg.TEST.EXPECTED_RESULTS = []  # the pins are for the dev script's 12 JPEG scenes
    cfg.DATASETS.TEST = (name,)
    cfg.DATASETS.PROPOSAL_FILES_TEST = (register_synthetic_cocovar(name, num=2),)
    try:
        model = build_model(cfg, device="cpu")
        load_weights(model, os.path.join(ROOT, cfg.MODEL.WEIGHTS))
        want = test(cfg, model, build_test_loader=train_net.build_test_loader,
                    build_evaluator=train_net.build_evaluator)
        monkeypatch.setattr(train_net, "setup", lambda args, cfg_: cfg)
        monkeypatch.setattr(train_net, "build_model", lambda cfg_, device: model)
        monkeypatch.setattr(train_net, "load_weights", lambda *a: None)
        got = train_net.main(train_net.argument_parser().parse_args(["--eval-only", "--device", "cpu"]))
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    _numbers_equal(want, got)
    assert sorted(got) == ["bbox", "panoptic_seg", "segm", "sem_seg"]


# (g) the whole gate runs of both commands


def _jax_cli_results(cli, args, env):
    """The result dict of a JAX package command's ``main`` (its TTA path
    prints no copypaste lines), run as a script would run it."""
    code = ("import json, runpy, sys; sys.argv = sys.argv[1:]; "
            f"mod = runpy.run_path({cli!r}, run_name='cli'); "
            "res = mod['main'](mod['default_argument_parser']().parse_args(sys.argv[1:])); "
            "print('RESULTS ' + json.dumps(res))")
    out = subprocess.run([sys.executable, "-c", code, cli] + args, cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=3000)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(next(ln for ln in out.stdout.splitlines() if ln.startswith("RESULTS "))[8:])


@pytest.mark.slow
@pytest.mark.parametrize("gate", ["mask_rcnn", "jtsm"])
def test_gate_cli_with_tta_equals_the_jax_cli(gate, tmp_path):
    """Each gate's whole tree through both commands with TEST.AUG.ENABLED
    True at short sides 112 and 128 (long side at most 176, the gate's
    buckets, which hold every view) and the flip: every number within 1e-4.
    The pins do not hold under TTA, so EXPECTED_RESULTS is emptied."""
    from tests.test_torch_jtsm_scoring import _copypaste

    root = tmp_path / "datasets"
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8"], check=True, capture_output=True, cwd=ROOT)
    env = dict(os.environ, JTSM_DATASETS=str(root), PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    yaml, port_cli, jax_cli = {
        "mask_rcnn": (MRCNN_YAML, "jtsm_tpu_torch.tools.train_net", "tools/train_net.py"),
        "jtsm": (JTSM_YAML, "jtsm_tpu_torch.wsl.train_net", "projects/WSL/tools/train_net.py"),
    }[gate]
    opts = ["TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", str(GATE_AUG["MIN_SIZES"]), "TEST.AUG.MAX_SIZE",
            str(GATE_AUG["MAX_SIZE"]), "TEST.EXPECTED_RESULTS", "[]"]
    port = subprocess.run([sys.executable, "-m", port_cli, "--eval-only", "--device", "cpu", "--config-file", yaml]
                          + opts + ["OUTPUT_DIR", str(tmp_path / "port")], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=3000)
    assert port.returncode == 0, port.stdout[-4000:] + port.stderr[-4000:]
    got = _copypaste(port.stdout + port.stderr)
    want = _jax_cli_results(os.path.join(ROOT, jax_cli), ["--eval-only", "--config-file", yaml] + opts
                            + ["OUTPUT_DIR", str(tmp_path / "jax")], env)
    assert sorted(got) == sorted(want) == (["bbox"] if gate == "mask_rcnn" else
                                           ["bbox", "panoptic_seg", "segm", "sem_seg"])
    for task, numbers in got.items():
        for k, g in numbers.items():
            w = want[task][k]
            assert (np.isnan(g) and (w is None or np.isnan(w))) or abs(g - w) <= 1e-4, (task, k, g, w)
    print({task: {k: got[task][k] for k in ("AP", "mIoU", "PQ") if k in got[task]} for task in got})
