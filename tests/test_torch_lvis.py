"""LVIS in the port (``data/datasets/lvis.py``, ``evaluation/lvis_evaluation.py``,
``config.mask_rcnn_R_50_FPN_lvis_cfg``) held against the JAX package on the
CPU:

* the loader and the registration on a tiny LVIS json written here
  (``datasets.synthetic_lvis``), in its v1 (``coco_url``) and v0.5
  (``file_name``) forms: the records and ``thing_classes`` equal, and the
  image path the root joined with a bare file name in both packages (no
  ``val2017/``; ROADMAP §3);
* ``LVISEvaluator`` against the JAX package's on the same predictions:
  equal numbers, nan where both are nan (a detection of an unlisted class
  dropped, one of a negative class a false positive, not-exhaustive
  classes, the frequency buckets, boxes and masks);
* the narrow LVIS Mask R-CNN at the real class count (1203 box classes,
  4812 deltas, the 1024-candidate cut over 16 proposals x 1203 classes at
  SCORE_THRESH_TEST 0.0001), DETECTIONS_PER_IMAGE 20 so that the mask
  predictor's 1203 channels stay small on the CPU: boxes within 1e-4 px
  (measured 7.6e-5), scores within 1e-5 of the largest (3.3e-6), masks
  within 1e-4 (1.4e-6), the train step's losses within 1e-5 relative
  (4.0e-7) and every gradient within 1e-4 of its norm (1.2e-6);
* TPU.MAX_GT_INSTANCES 100: an image of 130 instances loses the same 30 in
  both train loaders (the repeat-factor sampler at REPEAT_THRESHOLD 0.001).
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data.build import build_detection_train_loader as jax_train_loader
from jtsm_tpu.data.datasets.lvis import load_lvis_json as jax_load_lvis_json
from jtsm_tpu.data.datasets.lvis import register_lvis_instances as jax_register_lvis
from jtsm_tpu.evaluation.lvis_evaluation import LVISEvaluator as JaxLVISEvaluator
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu_torch.config import cascade_narrow, get_cfg, mask_rcnn_R_50_FPN_lvis_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data.build import build_detection_train_loader
from jtsm_tpu_torch.data.datasets.lvis import load_lvis_json, register_lvis_instances
from jtsm_tpu_torch.data.datasets.synthetic_lvis import make_synthetic_lvis, write_synthetic_lvis
from jtsm_tpu_torch.evaluation import LVISEvaluator
from tests.test_torch_cascade import batch_of, check_model, deterministic
from tests.test_torch_train_loader import _assert_same


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _plain(records):
    """Records with numpy scalars and arrays as plain Python values."""
    return json.loads(json.dumps(records, default=lambda o: o.tolist() if hasattr(o, "tolist") else str(o)))


@pytest.mark.parametrize("version", ["v1", "v0.5"])
def test_lvis_loader_equals_jax(tmp_path, version):
    path = write_synthetic_lvis(str(tmp_path), f"lvis_{version}_val", num=4, image_hw=(96, 128), version=version)
    root = str(tmp_path / "coco")
    name = f"torch_lvis_loader_{version}"
    want = jax_load_lvis_json(path, root, name)
    got = load_lvis_json(path, root, name)
    assert _plain(got) == _plain(want)
    assert MetadataCatalog.get(name).thing_classes == JaxMetadataCatalog.get(name).thing_classes
    assert len(MetadataCatalog.get(name).thing_classes) == {"v1": 1203, "v0.5": 1230}[version]
    r = got[0]
    assert r["file_name"] == os.path.join(root, "000000000000.jpg")  # a bare name under coco/: no val2017/
    assert os.path.exists(r["file_name"])
    assert {"neg_category_ids", "not_exhaustive_category_ids"} <= set(r)
    assert all("iscrowd" not in a for a in r["annotations"])
    assert min(a["category_id"] for rec in got for a in rec["annotations"]) >= 0


def test_lvis_polygon_filter_and_names_equal_jax(tmp_path):
    """Odd and short polygons are dropped; a category without synonyms is
    named by its name, one without either by its id."""
    lvis, _ = make_synthetic_lvis(2, image_hw=(64, 96), num_classes=3)
    lvis["annotations"][0]["segmentation"] += [[1, 2, 3, 4], [1, 2, 3, 4, 5, 6, 7]]
    lvis["categories"] = [{"id": 1, "synonyms": ["one", "uno"]}, {"id": 2, "name": "two"}, {"id": 3}]
    path = tmp_path / "lvis.json"
    path.write_text(json.dumps(lvis))
    want = jax_load_lvis_json(str(path), "coco", "torch_lvis_filter")
    got = load_lvis_json(str(path), "coco", "torch_lvis_filter")
    assert _plain(got) == _plain(want)
    assert len(got[0]["annotations"][0]["segmentation"]) == 1
    assert MetadataCatalog.get("torch_lvis_filter").thing_classes == ["one", "two", "3"]


def test_builtin_lvis_names_equal_jax():
    import jtsm_tpu.data.datasets  # noqa: F401  (registers the JAX builtins)

    for name in ("lvis_v1_train", "lvis_v1_val", "lvis_v0.5_train", "lvis_v0.5_val"):
        assert name in DatasetCatalog and name in JaxDatasetCatalog
        want, got = JaxMetadataCatalog.get(name), MetadataCatalog.get(name)
        assert (got.json_file, got.image_root, got.evaluator_type) == (want.json_file, want.image_root, "lvis")


# -- the evaluator ------------------------------------------------------------------------

def _register_both(name, lvis):
    """``name`` in both packages' metadata with ``lvis`` as a json file."""
    import tempfile

    path = os.path.join(tempfile.mkdtemp(), "lvis.json")
    with open(path, "w") as f:
        json.dump(lvis, f)
    JaxMetadataCatalog.get(name).json_file = path
    MetadataCatalog.get(name).json_file = path


def _same_results(want, got):
    assert sorted(want) == sorted(got)
    for task in want:
        assert sorted(want[task]) == sorted(got[task]), task
        for k, v in want[task].items():
            assert (math.isnan(v) and math.isnan(got[task][k])) or v == got[task][k], (task, k, v, got[task][k])


def _evaluate(name, batches, with_masks):
    res = []
    for ev in (JaxLVISEvaluator(name, distributed=False), LVISEvaluator(name, distributed=False)):
        ev.reset()
        for inputs, outputs in batches:
            outs = dict(outputs) if with_masks else {k: v for k, v in outputs.items() if k != "masks"}
            ev.process(inputs, outs)
        res.append(ev.evaluate())
    return res


def test_lvis_evaluator_federated_rule_equals_jax():
    """The JAX package's own case (``tests/test_evaluation.py``): a perfect
    detection, one of an unlisted class (dropped) and one of a negative
    class (a false positive)."""
    gt = {
        "images": [{"id": 1, "width": 50, "height": 50, "not_exhaustive_category_ids": [], "neg_category_ids": [2]}],
        "annotations": [{"id": 1, "image_id": 1, "category_id": 1, "bbox": [5, 5, 20, 20], "area": 400,
                         "segmentation": [[5, 5, 25, 5, 25, 25, 5, 25]]}],
        "categories": [{"id": 1, "name": "a", "frequency": "f"}, {"id": 2, "name": "b", "frequency": "c"},
                       {"id": 3, "name": "c", "frequency": "r"}],
    }
    _register_both("torch_lvis_eval_rule", gt)
    outputs = {
        "boxes": np.asarray([[[5, 5, 25, 25], [0, 0, 10, 10], [30, 30, 45, 45]]], np.float32),
        "scores": np.asarray([[0.9, 0.95, 0.8]], np.float32),
        "classes": np.asarray([[0, 2, 1]], np.int64),
        "valid": np.asarray([[True, True, True]]),
    }
    inputs = {"image_ids": np.asarray([1]), "orig_sizes": np.asarray([[50, 50]])}
    want, got = _evaluate("torch_lvis_eval_rule", [(inputs, outputs)], False)
    _same_results(want, got)
    assert got["bbox"]["AP"] == 100.0 and "AR300" in got["bbox"] and math.isnan(got["bbox"]["APr"])


@pytest.mark.parametrize("with_masks", [False, True])
def test_lvis_evaluator_equals_jax_on_seeded_predictions(with_masks):
    """Six scenes of the synthetic LVIS set (the 80 used classes in all
    three frequency buckets, two negative classes and one not-exhaustive
    class an image) and seeded predictions: each ground truth jittered, a
    detection of each negative class, of an unlisted class and of random
    boxes, 40 an image with masks."""
    lvis, _ = make_synthetic_lvis(6, seed=3, image_hw=(96, 128))
    name = f"torch_lvis_eval_seeded_{with_masks}"
    _register_both(name, lvis)
    rng = np.random.default_rng(7)
    batches = []
    for img in lvis["images"]:
        rows = []
        for a in [a for a in lvis["annotations"] if a["image_id"] == img["id"]]:
            x, y, w, h = a["bbox"]
            for _ in range(2):
                rows.append(([x, y, x + w, y + h] + rng.normal(0, 3, 4), a["category_id"] - 1))
        for c in img["neg_category_ids"] + [int(rng.integers(81, 1203))]:
            rows.append((np.r_[rng.uniform(0, 60, 2), rng.uniform(70, 96, 2)], c - 1))
        while len(rows) < 40:
            rows.append((np.r_[rng.uniform(0, 60, 2), rng.uniform(70, 96, 2)], int(rng.integers(0, 80))))
        boxes = np.asarray([r[0] for r in rows], np.float32)
        boxes[:, 2:] = np.maximum(boxes[:, 2:], boxes[:, :2] + 2)
        outputs = {
            "boxes": boxes[None], "scores": rng.uniform(0.05, 1, (1, 40)).astype(np.float32),
            "classes": np.asarray([[r[1] for r in rows]], np.int64), "valid": np.ones((1, 40), bool),
            "masks": rng.uniform(0, 1, (1, 40, 14, 14)).astype(np.float32),
        }
        valid = outputs["valid"]
        valid[0, -3:] = False
        batches.append(({"image_ids": np.asarray([img["id"]]),
                         "orig_sizes": np.asarray([[img["height"], img["width"]]])}, outputs))
    want, got = _evaluate(name, batches, with_masks)
    _same_results(want, got)
    assert sorted(got) == (["bbox", "segm"] if with_masks else ["bbox"])
    b = got["bbox"]
    assert b["AP"] > 10 and all(not math.isnan(b[k]) for k in ("APr", "APc", "APf"))


# -- the model ----------------------------------------------------------------------------

def narrow_lvis_cfg():
    """The narrow form (``cascade_narrow``) of the LVIS v1 Mask R-CNN at its
    1203 classes and SCORE_THRESH_TEST 0.0001, 20 detections an image."""
    cfg = deterministic(cascade_narrow(mask_rcnn_R_50_FPN_lvis_cfg("v1")))
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 1203
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0001
    cfg.TEST.DETECTIONS_PER_IMAGE = 20
    return cfg


def test_narrow_lvis_mask_rcnn_serves_and_trains_as_jax():
    """At the real class count: 16 proposals x 1203 classes, almost all
    above 0.0001, cut to 1024 candidates before the class-aware NMS (JAX
    ``fast_rcnn.py:136-137``; ROADMAP §3)."""
    cfg = narrow_lvis_cfg()
    batch = batch_of(cfg)
    batch["gt_classes"] = (batch["gt_classes"] * 61 + 7) % 1203  # classes across the 1203
    _, tm = check_model(cfg, batch, tol_px=1e-4, tol_rel=1e-5)
    p = tm.roi_heads.box_predictor
    assert p.cls_score.out_features == 1204 and p.bbox_pred.out_features == 4812
    assert tm.roi_heads.mask_head.predictor.out_channels == 1203


def test_max_gt_instances_keeps_the_same_100_in_both_loaders(tmp_path):
    """An image of 130 instances under TPU.MAX_GT_INSTANCES 100 through both
    train loaders (the repeat-factor sampler, SEED 42): the same batches,
    the same 100 instances kept."""
    lvis, _ = make_synthetic_lvis(2, image_hw=(96, 128))
    path = write_synthetic_lvis(str(tmp_path), "lvis_v1_train", num=2, image_hw=(96, 128))
    rng = np.random.default_rng(0)
    for k in range(130):
        x, y = rng.uniform(0, 100, 2)
        lvis["annotations"].append({"id": 1000 + k, "image_id": 0, "category_id": int(rng.integers(1, 81)),
                                    "bbox": [x, y, 12.0, 10.0], "area": 120.0,
                                    "segmentation": [[x, y, x + 12, y, x + 12, y + 10, x, y + 10]]})
    with open(path, "w") as f:
        json.dump(lvis, f)
    name = "torch_lvis_crowded"
    jax_register_lvis(name, {}, path, str(tmp_path / "coco"))
    register_lvis_instances(name, {}, path, str(tmp_path / "coco"))
    opts = ["DATASETS.TRAIN", f"('{name}',)", "INPUT.MIN_SIZE_TRAIN", "(96,)", "INPUT.MAX_SIZE_TRAIN", "128",
            "TPU.IMAGE_BUCKETS", "[[96, 128]]", "SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "0",
            "SEED", "42", "MODEL.ROI_HEADS.NUM_CLASSES", "1203"]
    lvis_yaml = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                             "configs/LVISv1-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml")
    jc, pc = jax_get_cfg(), get_cfg()
    for c in (jc, pc):
        c.merge_from_file(lvis_yaml)
        c.merge_from_list(copy.copy(opts))
    assert pc.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler" and pc.TPU.MAX_GT_INSTANCES == 100
    jax_seed_all_rng(42)
    jit = iter(jax_train_loader(jc))
    want = [next(jit) for _ in range(3)]
    pit = iter(build_detection_train_loader(pc))
    got = [next(pit) for _ in range(3)]
    _assert_same(want, got)
    assert max(int(b["gt_valid"].sum(1).max()) for b in got) == 100
