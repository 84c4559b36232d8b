"""The rotated family's data and evaluation in the port held against the JAX
package on the CPU, on the same records and numbers: ``BoxMode``'s XYWHA
conversions, ``apply_rotated_box`` on the transforms, the XYWHA branch of
``transform_instance_annotations``, ``annotations_to_instances_rotated``,
``filter_empty_instances`` on 5-dim boxes, ``convert_to_coco_dict`` with
5-dim boxes, ``pairwise_iou_rotated_np``, ``RotatedCOCOEval`` and
``RotatedCOCOEvaluator`` through ``inference_on_dataset`` (the same
detections on both sides: every number equal within 1e-6), then the
narrow rotated model scored through ``engine.test`` beside the JAX model's
detections of the same batches scored by the JAX evaluator. The JAX
package has no command-line path for a rotated model (its
``build_evaluator`` has no rotated branch, its mapper makes 4-dim boxes):
the port fails the same way, with a message.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data import detection_utils as jax_utils
from jtsm_tpu.data.datasets.coco import convert_to_coco_dict as jax_convert_to_coco_dict
from jtsm_tpu.data.transforms import transform as jax_T
from jtsm_tpu.evaluation import inference_on_dataset as jax_inference_on_dataset
from jtsm_tpu.evaluation.rotated_coco_evaluation import RotatedCOCOEval as JaxRotatedCOCOEval
from jtsm_tpu.evaluation.rotated_coco_evaluation import RotatedCOCOEvaluator as JaxRotatedCOCOEvaluator
from jtsm_tpu.evaluation.rotated_coco_evaluation import pairwise_iou_rotated_np as jax_iou_np
from jtsm_tpu.structures import BoxMode as JaxBoxMode
from jtsm_tpu.structures import Instances as JaxInstances
from jtsm_tpu_torch.data import DatasetMapper, MetadataCatalog
from jtsm_tpu_torch.data import detection_utils as utils
from jtsm_tpu_torch.data.datasets.coco import convert_to_coco_dict
from jtsm_tpu_torch.data.datasets.synthetic_rotated import make_synthetic_rotated, register_synthetic_rotated
from jtsm_tpu_torch.data.transforms import transform as T
from jtsm_tpu_torch.engine.defaults import build_test_loader
from jtsm_tpu_torch.engine import test as engine_test
from jtsm_tpu_torch.evaluation import (
    COCOEvaluator,
    RotatedCOCOEval,
    RotatedCOCOEvaluator,
    inference_on_dataset,
    pairwise_iou_rotated_np,
)
from jtsm_tpu_torch.structures import BoxMode, Instances
from tests.test_torch_rotated_model import narrow_cfg, seeded_models

TOL_AP = 1e-6


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_box_mode_rotated_conversions_as_jax():
    boxes = np.array([[10, 20, 8, 4, 30], [5, 5, 2, 6, -120], [0, 0, 3, 3, 90]], np.float32)
    xywh = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.float64)
    for value, a, b in ((boxes, "XYWHA_ABS", "XYXY_ABS"), (boxes.tolist()[0], "XYWHA_ABS", "XYXY_ABS"),
                        (tuple(boxes.tolist()[1]), "XYWHA_ABS", "XYXY_ABS"), (xywh, "XYWH_ABS", "XYWHA_ABS"),
                        (xywh.tolist()[0], "XYWH_ABS", "XYWHA_ABS"), (xywh, "XYWH_ABS", "XYXY_ABS")):
        want = JaxBoxMode.convert(copy.deepcopy(value), JaxBoxMode[a], JaxBoxMode[b])
        got = BoxMode.convert(copy.deepcopy(value), BoxMode[a], BoxMode[b])
        assert type(got) is type(want) and np.asarray(got).dtype == np.asarray(want).dtype, (a, b, type(value))
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    for side in (JaxBoxMode, BoxMode):
        with pytest.raises(NotImplementedError, match="not supported"):
            side.convert(boxes, side.XYWHA_ABS, side.XYWH_ABS)


def test_apply_rotated_box_as_jax():
    rng = np.random.default_rng(0)
    rb = np.concatenate([rng.uniform(0, 100, (20, 4)), rng.uniform(-180, 180, (20, 1))], 1)
    pairs = [
        (jax_T.NoOpTransform(), T.NoOpTransform()),
        (jax_T.ResizeTransform(100, 80, 150, 60), T.ResizeTransform(100, 80, 150, 60)),
        (jax_T.HFlipTransform(80), T.HFlipTransform(80)),
        (jax_T.TransformList([jax_T.ResizeTransform(100, 80, 50, 120), jax_T.HFlipTransform(120)]),
         T.TransformList([T.ResizeTransform(100, 80, 50, 120), T.HFlipTransform(120)])),
    ]
    for jt, tt in pairs:
        np.testing.assert_array_equal(tt.apply_rotated_box(rb), jt.apply_rotated_box(rb), err_msg=type(tt).__name__)
    for tt in (T.VFlipTransform(100), T.CropTransform(0, 0, 10, 10)):
        with pytest.raises(NotImplementedError, match="apply_rotated_box is not defined"):
            tt.apply_rotated_box(rb)


def test_rotated_annotations_and_instances_as_jax():
    """The XYWHA branch of ``transform_instance_annotations`` (resize and
    flip), ``annotations_to_instances_rotated`` (the nearly-axis-aligned
    clip) and ``filter_empty_instances`` on 5-dim boxes."""
    annos = [{"bbox": [30.0, 40.0, 20.0, 10.0, 30.0], "bbox_mode": 4, "category_id": 1},
             {"bbox": [5.0, 5.0, 30.0, 12.0, 0.5], "bbox_mode": 4, "category_id": 2},  # clips
             {"bbox": [60.0, 20.0, 0.0, 10.0, -45.0], "bbox_mode": 4, "category_id": 0}]  # empty
    jt = jax_T.TransformList([jax_T.ResizeTransform(64, 80, 96, 120), jax_T.HFlipTransform(120)])
    tt = T.TransformList([T.ResizeTransform(64, 80, 96, 120), T.HFlipTransform(120)])
    want = [jax_utils.transform_instance_annotations(dict(a, bbox_mode=JaxBoxMode.XYWHA_ABS), jt, (96, 120))
            for a in copy.deepcopy(annos)]
    got = [utils.transform_instance_annotations(dict(a, bbox_mode=BoxMode.XYWHA_ABS), tt, (96, 120))
           for a in copy.deepcopy(annos)]
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g["bbox"], w["bbox"])
        assert g["bbox_mode"] == w["bbox_mode"] == 4
    wi = jax_utils.annotations_to_instances_rotated(want, (96, 120))
    gi = utils.annotations_to_instances_rotated(got, (96, 120))
    np.testing.assert_array_equal(gi.gt_boxes, wi.gt_boxes)
    np.testing.assert_array_equal(gi.gt_classes, wi.gt_classes)
    assert gi.gt_boxes.dtype == np.float32 and gi.gt_boxes[1, 2] < got[1]["bbox"][2]  # the nearly aligned box clips
    wf = jax_utils.filter_empty_instances(wi)
    gf = utils.filter_empty_instances(gi)
    assert len(gf) == len(wf) == 2
    np.testing.assert_array_equal(gf.gt_boxes, wf.gt_boxes)
    assert utils.annotations_to_instances_rotated([], (10, 10)).gt_boxes.shape == (0, 5)
    assert isinstance(gi, Instances) and isinstance(wi, JaxInstances)


def _register_both(name, num, seed, image_hw=(64, 64), num_classes=3):
    """The synthetic rotated scenes under ``name`` in both catalogs (the
    JAX package's without the pixels)."""
    records = register_synthetic_rotated(name, num, seed, image_hw, num_classes)
    jax_records = [{k: v for k, v in r.items() if k != "image"} for r in copy.deepcopy(records)]
    for r in jax_records:
        for a in r["annotations"]:
            a["bbox_mode"] = JaxBoxMode.XYWHA_ABS
    JaxDatasetCatalog.register(name, lambda: copy.deepcopy(jax_records))
    JaxMetadataCatalog.get(name).set(thing_classes=MetadataCatalog.get(name).thing_classes)
    return records


def test_convert_to_coco_dict_keeps_rotated_boxes_as_jax():
    name = "torch_rotated_coco_dict"
    records = _register_both(name, 4, seed=1)
    got, want = convert_to_coco_dict(name), jax_convert_to_coco_dict(name)
    assert got == want
    assert all(len(a["bbox"]) == 5 for a in got["annotations"])
    assert len(got["annotations"]) == sum(len(r["annotations"]) for r in records)


def _detections(rng, n_images, d=12, hw=(64, 64)):
    boxes = np.zeros((n_images, d, 5), np.float32)
    boxes[..., 0] = rng.uniform(10, hw[1] - 10, (n_images, d))
    boxes[..., 1] = rng.uniform(10, hw[0] - 10, (n_images, d))
    boxes[..., 2:4] = rng.uniform(6, 30, (n_images, d, 2))
    boxes[..., 4] = rng.uniform(-90, 90, (n_images, d))
    return {"boxes": boxes, "scores": rng.uniform(size=(n_images, d)).astype(np.float32),
            "classes": rng.integers(0, 3, (n_images, d)).astype(np.int32),
            "valid": rng.uniform(size=(n_images, d)) < 0.9}


def test_rotated_coco_eval_and_iou_as_jax():
    """``pairwise_iou_rotated_np`` equal, and ``RotatedCOCOEval`` on the
    scenes' ground truth with detections near it (each a ground truth box
    jittered) and far from it: every number equal; crowds refused."""
    name = "torch_rotated_eval"
    records = _register_both(name, 6, seed=2)
    gt = convert_to_coco_dict(name)
    rng = np.random.default_rng(2)
    a = np.asarray([x["bbox"] for x in gt["annotations"]], np.float64)
    b = a + rng.normal(0, [1, 1, 1, 1, 5], a.shape)
    np.testing.assert_array_equal(pairwise_iou_rotated_np(a, b), jax_iou_np(a, b))
    dets = []
    for ann, box in zip(gt["annotations"], b):
        dets.append({"image_id": ann["image_id"], "category_id": ann["category_id"], "bbox": box.tolist(),
                     "score": float(rng.uniform())})
    for r in records:
        for _ in range(3):
            dets.append({"image_id": r["image_id"], "category_id": int(rng.integers(0, 3)),
                         "bbox": [float(v) for v in rng.uniform([5, 5, 4, 4, -90], [60, 60, 30, 30, 90])],
                         "score": float(rng.uniform())})
    want = JaxRotatedCOCOEval(gt, iou_type="bbox").evaluate(copy.deepcopy(dets))
    got = RotatedCOCOEval(gt, iou_type="bbox").evaluate(copy.deepcopy(dets))
    assert list(got) == list(want) and got["AP"] > 0.1
    for k in want:
        assert (np.isnan(want[k]) and np.isnan(got[k])) or abs(got[k] - want[k]) <= TOL_AP, k
    crowd = copy.deepcopy(gt)
    crowd["annotations"][0]["iscrowd"] = 1
    with pytest.raises(ValueError, match="crowd"):
        RotatedCOCOEval(crowd).evaluate(dets)


def _same_results(want, got):
    assert list(got) == list(want) == ["bbox"]
    assert list(got["bbox"]) == list(want["bbox"])
    for k, w in want["bbox"].items():
        g = got["bbox"][k]
        assert (np.isnan(w) and np.isnan(g)) or abs(g - w) <= TOL_AP, (k, g, w)


def test_rotated_evaluator_through_inference_on_dataset_as_jax():
    """The same batched detections through both packages'
    ``inference_on_dataset`` and ``RotatedCOCOEvaluator``: every number
    equal; the port's ``COCOEvaluator`` refuses 5-dim boxes with a message."""
    name = "torch_rotated_evaluator"
    records = _register_both(name, 6, seed=3)
    rng = np.random.default_rng(3)
    batches = []
    for i in range(0, 6, 2):
        out = _detections(rng, 2)
        batches.append(({"image": np.zeros((2, 64, 64, 3), np.float32),
                         "image_ids": np.array([r["image_id"] for r in records[i:i + 2]]),
                         "orig_sizes": np.array([[64, 64]] * 2, np.int32)}, out))
    outputs = {id(inputs): out for inputs, out in batches}
    loader = [inputs for inputs, _ in batches]
    want = jax_inference_on_dataset(lambda x: outputs[id(x)], loader, JaxRotatedCOCOEvaluator(name))
    got = inference_on_dataset(lambda x: {k: torch.as_tensor(v) for k, v in outputs[id(x)].items()}, loader,
                               RotatedCOCOEvaluator(name))
    _same_results(want, got)
    with pytest.raises(ValueError, match="RotatedCOCOEvaluator"):
        inference_on_dataset(lambda x: outputs[id(x)], loader, COCOEvaluator(name))


def test_narrow_model_scored_as_jax():
    """The narrow rotated model (seeded weights on both sides) over 8
    synthetic scenes: the port through ``engine.test`` with
    ``RotatedCOCOEvaluator``, the JAX model on the same batches through its
    ``inference_on_dataset`` and evaluator: every number equal within 1e-6
    (the detections agree to 1e-3 px, ``tests/test_torch_rotated_model.py``)."""
    name = "torch_rotated_scored"
    _register_both(name, 8, seed=4)
    cfg = narrow_cfg()
    cfg.DATASETS.TEST = (name,)
    loader = list(build_test_loader(cfg, name))
    first = {k: v for k, v in loader[0].items() if k != "image_ids"}
    jm, jb, variables, tm = seeded_models(cfg, first)
    got = engine_test(cfg, tm, evaluators=[RotatedCOCOEvaluator(name)])
    with jax.default_matmul_precision("highest"):
        run = jax.jit(lambda v, b: jm.apply(v, b, train=False))
        want = jax_inference_on_dataset(
            lambda b: run(variables, {k: jnp.asarray(v) for k, v in b.items() if k != "image_ids"}), loader,
            JaxRotatedCOCOEvaluator(name))
    print(got["bbox"])
    _same_results(want, got)
    assert got["bbox"]["AP"] >= 0.0 and np.isfinite(got["bbox"]["AP50"])


def test_mapper_makes_4_dim_boxes_as_jax():
    """The JAX package's DatasetMapper turns XYWHA annotations into 4-dim
    ground truth (``annotations_to_instances``, JAX
    ``dataset_mapper.py:146``); the port's does the same, and the rotated
    model refuses such a batch in training
    (``tests/test_torch_rotated_heads.py::test_rotated_pieces_build_by_name``)."""
    record = make_synthetic_rotated(1, seed=5)[0]
    out = DatasetMapper(narrow_cfg(), True)(copy.deepcopy(record))
    assert out["instances"].gt_boxes.shape == (len(record["annotations"]), 4)
