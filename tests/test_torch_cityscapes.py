"""Cityscapes in the port (``data/datasets/cityscapes*.py``,
``evaluation/cityscapes_evaluation.py``,
``config.mask_rcnn_R_50_FPN_cityscapes_cfg``) held against the JAX package on
the CPU:

* the instance, semantic and panoptic loaders on a tiny gtFine tree written
  here (``datasets.synthetic_cityscapes``): equal records; the builtin
  names and their metadata equal;
* ``CityscapesInstanceEvaluator`` against the JAX package's on the same
  predictions: equal numbers where the two rasterisers agree (the synthetic
  scenes' rectangles and hexagons); on self-crossing polygons the port's
  fill differs from Pillow's at a few corner joins (ROADMAP §3), and the
  test states the AP difference it finds;
* ``CityscapesSemSegEvaluator``: PNG ground truth (label ids and instance
  ids) in both packages, equal numbers; the port's in-memory arrays give
  the same numbers as its PNGs;
* ``cityscapes_panoptic_seg`` has no evaluator in either package;
* the narrow Cityscapes Mask R-CNN (8 classes) at a small bucket: detections,
  masks, losses and gradients at ``tests/test_torch_cascade.py``'s rule, the
  boxes within 2e-4 px of the network's input (measured 1.07e-4: 7 float32
  spacings of the 2x original coordinates, near 300 px) and the scores
  within 1e-5 of the largest.
"""

import copy
import json
import math
import os

import numpy as np
import pytest
import torch

import jtsm_tpu.data.datasets  # noqa: F401  (registers the JAX builtins)
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data.datasets.cityscapes import load_cityscapes_instances as jax_load_instances
from jtsm_tpu.data.datasets.cityscapes import load_cityscapes_semantic as jax_load_semantic
from jtsm_tpu.data.datasets.cityscapes_panoptic import load_cityscapes_panoptic as jax_load_panoptic
from jtsm_tpu.engine.defaults import DefaultTrainer as JaxTrainer
from jtsm_tpu.evaluation.cityscapes_evaluation import CityscapesInstanceEvaluator as JaxInstanceEvaluator
from jtsm_tpu.evaluation.cityscapes_evaluation import CityscapesSemSegEvaluator as JaxSemSegEvaluator
from jtsm_tpu.structures import BoxMode as JaxBoxMode
from jtsm_tpu_torch.config import cascade_narrow, get_cfg, mask_rcnn_R_50_FPN_cityscapes_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data.datasets.cityscapes import load_cityscapes_instances, load_cityscapes_semantic
from jtsm_tpu_torch.data.datasets.cityscapes_panoptic import cityscapes_panoptic_meta, load_cityscapes_panoptic
from jtsm_tpu_torch.data.datasets.synthetic_cityscapes import (
    make_synthetic_cityscapes,
    register_synthetic_cityscapes_sem_seg,
    write_synthetic_cityscapes,
)
from jtsm_tpu_torch.engine.defaults import build_evaluator
from jtsm_tpu_torch.evaluation import CityscapesInstanceEvaluator, CityscapesSemSegEvaluator
from jtsm_tpu_torch.structures import BoxMode
from tests.test_torch_cascade import batch_of, check_model, deterministic
from tests.test_torch_lvis import _plain, _same_results

HW = (96, 192)


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cityscapes_root"))
    write_synthetic_cityscapes(root, "val", num=4, seed=0, image_hw=HW)
    return root


def _dirs(root):
    return (os.path.join(root, "cityscapes", "leftImg8bit", "val"), os.path.join(root, "cityscapes", "gtFine", "val"))


def test_instance_and_semantic_loaders_equal_jax(tree):
    image_dir, gt_dir = _dirs(tree)
    want, got = jax_load_instances(image_dir, gt_dir), load_cityscapes_instances(image_dir, gt_dir)
    assert _plain(got) == _plain(want) and len(got) == 4
    annos = [a for r in got for a in r["annotations"]]
    assert any(a["iscrowd"] for a in annos) and all(a["bbox_mode"] == BoxMode.XYXY_ABS for a in annos)
    assert isinstance(got[0]["image_id"], str)
    # the "sky" polygon of each scene is no instance
    assert len(annos) == sum(len(p["objects"]) - 1 for _, _, p, *_ in make_synthetic_cityscapes(4, 0, HW))
    assert _plain(load_cityscapes_semantic(image_dir, gt_dir)) == _plain(jax_load_semantic(image_dir, gt_dir))


def test_panoptic_loader_equals_jax(tree):
    image_dir, _ = _dirs(tree)
    gt_dir = os.path.join(tree, "cityscapes", "gtFine", "cityscapes_panoptic_val")
    scenes = make_synthetic_cityscapes(4, 0, HW)
    anns = [{"image_id": image_id, "file_name": f"{image_id}_gtFine_panoptic.png",
             "segments_info": [{"id": 1, "category_id": 7, "iscrowd": 0, "area": 10},
                               {"id": 26000, "category_id": 26, "iscrowd": 0, "area": 5}]}
            for image_id, *_ in scenes[:3]] + [{"image_id": "elsewhere_000000_000000", "file_name": "x.png",
                                                "segments_info": []}]
    gt_json = os.path.join(tree, "cityscapes", "gtFine", "cityscapes_panoptic_val.json")
    with open(gt_json, "w") as f:
        json.dump({"annotations": anns}, f)
    meta = cityscapes_panoptic_meta()
    jax_meta = {k: JaxMetadataCatalog.get("cityscapes_fine_panoptic_val").get(k)
                for k in ("thing_dataset_id_to_contiguous_id", "stuff_dataset_id_to_contiguous_id")}
    got = load_cityscapes_panoptic(image_dir, gt_dir, gt_json, meta)
    assert _plain(got) == _plain(jax_load_panoptic(image_dir, gt_dir, gt_json, jax_meta))
    assert len(got) == 3 and [s["category_id"] for s in got[0]["segments_info"]] == [0, 13]


CITYSCAPES_NAMES = [f"cityscapes_fine_{kind}_{split}" for kind in ("instance_seg", "sem_seg")
                    for split in ("train", "val", "test")] + ["cityscapes_fine_panoptic_train",
                                                              "cityscapes_fine_panoptic_val"]


@pytest.mark.parametrize("name", CITYSCAPES_NAMES)
def test_builtin_cityscapes_names_equal_jax(name):
    assert name in DatasetCatalog and name in JaxDatasetCatalog
    want, got = JaxMetadataCatalog.get(name), MetadataCatalog.get(name)
    keys = sorted(k for k in vars(want) if k != "name")
    assert keys == sorted(k for k in vars(got) if k != "name")
    assert _plain({k: getattr(got, k) for k in keys}) == _plain({k: getattr(want, k) for k in keys})


def test_cityscapes_panoptic_has_no_evaluator_in_either_package():
    cfg = get_cfg()
    with pytest.raises(NotImplementedError, match="cityscapes_panoptic_seg"):
        build_evaluator(cfg, "cityscapes_fine_panoptic_val")
    jc = jax_get_cfg()
    jc.OUTPUT_DIR = cfg.OUTPUT_DIR
    with pytest.raises(NotImplementedError, match="cityscapes_panoptic_seg"):
        JaxTrainer.build_evaluator(jc, "cityscapes_fine_panoptic_val")


# -- the evaluators -------------------------------------------------------------------------

def _register_instances(name, records, pkg):
    catalogs = (JaxDatasetCatalog, JaxMetadataCatalog) if pkg == "jax" else (DatasetCatalog, MetadataCatalog)
    if name in catalogs[0]:
        catalogs[0].remove(name)
    catalogs[0].register(name, lambda: copy.deepcopy(records))
    catalogs[1].get(name).set(thing_classes=["person", "rider", "car", "truck", "bus", "train", "motorcycle",
                                             "bicycle"], evaluator_type="cityscapes_instance")


def _predictions(records, seed, n=12):
    """One batch an image: each ground truth box jittered with a random
    14x14 mask, and random boxes, ``n`` an image, the last two invalid."""
    rng = np.random.default_rng(seed)
    out = []
    for r in records:
        h, w = r["height"], r["width"]
        rows = [(np.asarray(a["bbox"], np.float64) + rng.normal(0, 1.5, 4), a["category_id"])
                for a in r["annotations"]]
        while len(rows) < n:
            x, y = rng.uniform(0, [w - 40, h - 30])
            rows.append((np.asarray([x, y, x + rng.uniform(8, 40), y + rng.uniform(8, 30)]), int(rng.integers(8))))
        rows = rows[:n]
        masks = np.clip(rng.normal(0.8, 0.3, (1, n, 14, 14)), 0, 1).astype(np.float32)
        outputs = {"boxes": np.asarray([[b for b, _ in rows]], np.float32),
                   "scores": rng.uniform(0.1, 1, (1, n)).astype(np.float32),
                   "classes": np.asarray([[c for _, c in rows]], np.int64),
                   "valid": np.asarray([[True] * (n - 2) + [False] * 2]), "masks": masks}
        out.append(({"image_ids": np.asarray([r["image_id"]]), "orig_sizes": np.asarray([[h, w]]),
                     "image_sizes": np.asarray([[h, w]])}, outputs))
    return out


def _instance_results(name, records, batches):
    res = []
    for pkg, cls in (("jax", JaxInstanceEvaluator), ("port", CityscapesInstanceEvaluator)):
        _register_instances(name, records, pkg)
        ev = cls(name)
        ev.reset()
        for inputs, outputs in batches:
            ev.process(inputs, outputs)
        res.append(ev)
    return res


def test_instance_evaluator_equals_jax_on_the_synthetic_scenes(tree):
    records = load_cityscapes_instances(*_dirs(tree))
    jev, pev = _instance_results("torch_city_instances", records, _predictions(records, 1))
    assert _plain(pev._gt) == _plain(jev._gt)  # the rasterised ground truth, RLE for RLE
    want, got = jev.evaluate(), pev.evaluate()
    _same_results(want, got)
    assert sorted(got["segm"]) == ["AP", "AP50"] and got["segm"]["AP50"] > 10


def test_instance_evaluator_on_self_crossing_polygons():
    """The polygons of ``tests/test_torch_data.py``'s crowded case (2000
    seeded polygons of up to 11 vertices at 96x120) where the port's fill
    and Pillow's differ at a corner join (ROADMAP §3), as the ground truth
    of two images, and each detected by the port's own fill of it: the
    ground truth differs by 20 pixels in 10 masks; measured AP and AP50
    equal (100 on both sides: every IoU stays above 0.95)."""
    from jtsm_tpu.structures.masks import polygons_to_bitmask as pillow_fill
    from jtsm_tpu_torch.data.rle import rle_string_encode
    from jtsm_tpu_torch.structures.masks import polygons_to_bitmask

    rng = np.random.default_rng(1)
    polys = [list(rng.uniform(-10, 130, 2 * int(rng.integers(3, 12)))) for _ in range(2000)]
    crossing = [p for p in polys if (polygons_to_bitmask([p], 96, 120) != pillow_fill([np.asarray(p)], 96, 120)).any()]
    assert len(crossing) == 10
    records, detections = [], []
    for i in range(2):
        annos = []
        for k, p in enumerate(crossing[5 * i: 5 * i + 5]):
            xs, ys = np.clip(p[0::2], 0, 120), np.clip(p[1::2], 0, 96)
            annos.append({"category_id": k % 8, "bbox": [xs.min(), ys.min(), xs.max(), ys.max()],
                          "bbox_mode": BoxMode.XYXY_ABS, "segmentation": [p], "iscrowd": 0})
            detections.append({"image_id": i, "category_id": k % 8 + 1, "score": 0.9 - 0.01 * k,
                               "bbox": [0, 0, 1, 1], "segmentation": rle_string_encode(polygons_to_bitmask([p], 96, 120))})
        records.append({"file_name": f"x{i}.png", "image_id": f"crossing_{i:06d}_000000", "height": 96, "width": 120,
                        "annotations": annos})
    jax_records = copy.deepcopy(records)
    for r in jax_records:
        for a in r["annotations"]:
            a["bbox_mode"] = JaxBoxMode.XYXY_ABS
    jev, _ = _instance_results("torch_city_crossing", jax_records, [])
    _, pev = _instance_results("torch_city_crossing", records, [])
    from jtsm_tpu_torch.data.rle import decode_segmentation

    differ = [int((decode_segmentation(a["segmentation"], 96, 120) != decode_segmentation(b["segmentation"], 96, 120)).sum())
              for a, b in zip(jev._gt["annotations"], pev._gt["annotations"])]
    print("masks that differ", sum(d > 0 for d in differ), "pixels", sum(differ))
    assert sum(d > 0 for d in differ) == 10 and sum(differ) == 20
    jev._predictions, pev._predictions = copy.deepcopy(detections), copy.deepcopy(detections)
    want, got = jev.evaluate(), pev.evaluate()
    print("AP", want["segm"], got["segm"])
    assert got["segm"] == {"AP": 100.0, "AP50": 100.0}
    assert want["segm"] == got["segm"]


def _sem_seg_predictions(scenes, seed):
    rng = np.random.default_rng(seed)
    preds = []
    for image_id, _, _, _, labels, _ in scenes:
        train = np.full(labels.shape, 255, np.int64)
        for lab, tid in ((7, 0), (11, 2), (23, 10), (24, 11), (26, 13), (27, 14), (28, 15), (31, 16), (32, 17),
                         (33, 18), (25, 12)):
            train[labels == lab] = tid
        flip = rng.random(labels.shape) < 0.15
        train[flip] = rng.integers(0, 19, int(flip.sum()))
        preds.append((image_id, train))
    return preds


def test_sem_seg_evaluator_equals_jax_from_pngs_and_from_memory(tree):
    image_dir, gt_dir = _dirs(tree)
    name = "torch_city_sem_seg_pngs"
    records = load_cityscapes_semantic(image_dir, gt_dir)
    for r in records:
        r["image_id"] = os.path.basename(r["file_name"])[: -len("_leftImg8bit.png")]
    for catalog in (JaxDatasetCatalog, DatasetCatalog):
        catalog.register(name, lambda: copy.deepcopy(records))
    scenes = make_synthetic_cityscapes(4, 0, HW)
    preds = _sem_seg_predictions(scenes, 3)
    results = []
    for ev in (JaxSemSegEvaluator(name, distributed=False), CityscapesSemSegEvaluator(name, distributed=False)):
        ev.reset()
        for image_id, pred in preds:
            ev.process({"image_ids": np.asarray([image_id])}, {"sem_seg": pred[None]})
        results.append(ev.evaluate())
    _same_results(*results)
    got = results[1]["sem_seg"]
    assert 20 < got["IoU"] < 100 and not math.isnan(got["iIoU"]) and not math.isnan(got["iIoU_sup"])
    memory = "torch_city_sem_seg_memory"
    register_synthetic_cityscapes_sem_seg(memory, 4, 0, HW)
    ev = CityscapesSemSegEvaluator(memory)
    ev.reset()
    for image_id, pred in preds:
        ev.process({"image_ids": np.asarray([image_id])}, {"sem_seg": torch.as_tensor(pred[None])})
    _same_results(results[1], ev.evaluate())


# -- the model --------------------------------------------------------------------------------

def test_narrow_cityscapes_mask_rcnn_serves_and_trains_as_jax():
    """``mask_rcnn_R_50_FPN_cityscapes_cfg`` narrowed (``cascade_narrow``)
    with its 8 classes, at the narrow bucket. Boxes within 2e-4 input px:
    between 1024 and 2048 px one float32 step is 1.2e-4, so 1e-4 would ask
    for less than one rounding (measured 1.07e-4); scores and masks within
    1e-5."""
    cfg = deterministic(cascade_narrow(mask_rcnn_R_50_FPN_cityscapes_cfg()))
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 8
    _, tm = check_model(cfg, batch_of(cfg, seed=3), seed=3, tol_px=2e-4, tol_rel=1e-5)
    assert tm.roi_heads.box_predictor.cls_score.out_features == 9
