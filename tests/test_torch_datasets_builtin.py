"""The port's dataset catalog and the pieces of ``data/datasets`` this slice
adds, held against the JAX package on the CPU:

* the catalog's names against the JAX package's: 58 of its 62, without only
  the WSL web and mined-label splits (ROADMAP queue 1 item 6), each with the
  same metadata;
* ``convert_to_coco_dict`` on instance records (XYWH and XYXY boxes,
  polygons, RLE, keypoints, crowds, records without ``image_id``) equal to
  the JAX package's; ``convert_to_coco_json``'s cache and its write through
  a temporary file; a rotated box as the JAX package converts it, and the
  conversion it lacks raising with a message;
* ``COCOEvaluator`` on a dataset registered without a COCO json (Cityscapes
  records) equal to the JAX package's;
* ``load_coco_panoptic_json`` and ``register_coco_panoptic`` (the standard
  COCO panoptic splits) and ``merge_to_panoptic`` equal to the JAX
  package's;
* ``register_all_ade20k``: the ADE20K-150 splits' metadata, and their
  records on a tiny written tree.
"""

import copy
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jtsm_tpu.data.datasets  # noqa: F401  (registers the JAX builtins)
import jtsm_tpu.wsl  # noqa: F401  (registers the JAX WSL splits)
import jtsm_tpu_torch.wsl  # noqa: F401  (registers the port's WSL splits)
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data.datasets import builtin as jax_builtin
from jtsm_tpu.data.datasets.builtin_meta import _get_builtin_metadata as jax_metadata
from jtsm_tpu.data.datasets.coco import convert_to_coco_dict as jax_convert
from jtsm_tpu.evaluation.coco_evaluation import COCOEvaluator as JaxCOCOEvaluator
from jtsm_tpu.structures import BoxMode as JaxBoxMode
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data.datasets import builtin
from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
from jtsm_tpu_torch.data.datasets.coco import convert_to_coco_dict, convert_to_coco_json
from jtsm_tpu_torch.data.datasets.synthetic_cityscapes import make_synthetic_cityscapes
from jtsm_tpu_torch.evaluation import COCOEvaluator
from jtsm_tpu_torch.structures import BoxMode
from tests.test_torch_lvis import _plain, _same_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WSL_ONLY = ["flickr_coco", "flickr_voc", "voc_2007_train_pgt", "voc_2007_val_pgt"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# Both packages' builtin names, each catalog as its package's imports leave
# it, read in a fresh process: tests in a shared process register sets of
# their own, and the JAX package registers the VOC splits only when its WSL
# data module imports cleanly at that moment (ROADMAP §3).
_LIST_BUILTINS = """
import json
import jtsm_tpu.data.datasets, jtsm_tpu.wsl, jtsm_tpu_torch.data.datasets, jtsm_tpu_torch.wsl
from jtsm_tpu.data import DatasetCatalog as J
from jtsm_tpu_torch.data import DatasetCatalog as T
print(json.dumps([J.list(), sorted(T._registry)]))
"""


def test_catalog_holds_58_of_the_jax_packages_62_names():
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _LIST_BUILTINS], cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want, got = map(set, json.loads(proc.stdout.strip().splitlines()[-1]))
    assert sorted(want - got) == WSL_ONLY and not got - want, (sorted(want - got), sorted(got - want))
    assert len(want) == 62 and len(got) == 58


@pytest.mark.parametrize("name", ["lvis_v1_val", "ade20k_sem_seg_train", "ade20k_sem_seg_val",
                                  "coco_2017_val_panoptic", "coco_2017_train_panoptic",
                                  "coco_2017_val_100_panoptic", "coco_2017_varied_100_panoptic",
                                  "cityscapes_fine_instance_seg_val", "cityscapes_fine_sem_seg_train"])
def test_new_builtin_metadata_equals_jax(name):
    want, got = JaxMetadataCatalog.get(name), MetadataCatalog.get(name)
    keys = sorted(k for k in vars(want) if k != "name")
    assert keys == sorted(k for k in vars(got) if k != "name")
    assert _plain({k: getattr(got, k) for k in keys}) == _plain({k: getattr(want, k) for k in keys})


def test_standard_panoptic_metadata_equals_jax():
    assert _plain(_get_builtin_metadata("coco_panoptic_standard")) == _plain(jax_metadata("coco_panoptic_standard"))
    assert len(_get_builtin_metadata("coco_panoptic_standard")["thing_classes"]) == 133


# -- convert_to_coco_dict -------------------------------------------------------------------

def _records(box_mode):
    """Two images: polygons, an RLE, a crowd, keypoints, numpy boxes; the
    second without an ``image_id``."""
    rng = np.random.default_rng(0)
    return [
        {"file_name": "a.jpg", "image_id": 7, "height": 40, "width": 60, "annotations": [
            {"bbox": [2.123456, 3.5, 20.25, 30.0], "bbox_mode": box_mode, "category_id": 1,
             "segmentation": [[2, 3, 22, 3, 22, 33, 2, 33]], "keypoints": rng.uniform(0, 30, (3, 3)).round(2)},
            {"bbox": np.asarray([10.0, 5.0, 30.0, 25.0]), "bbox_mode": box_mode, "category_id": 0, "iscrowd": 1,
             "segmentation": {"size": [40, 60], "counts": "abc"}},
        ]},
        {"file_name": "b.jpg", "height": 50, "width": 70, "annotations": [
            {"bbox": [1.0, 1.0, 9.0, 9.0], "bbox_mode": box_mode, "category_id": 2}]},
    ]


@pytest.mark.parametrize("mode", ["XYWH_ABS", "XYXY_ABS"])
def test_convert_to_coco_dict_equals_jax(mode):
    name = f"torch_convert_{mode}"
    recs = _records(getattr(BoxMode, mode))
    jax_recs = _records(getattr(JaxBoxMode, mode))
    meta = {"thing_classes": ["a", "b", "c"], "thing_dataset_id_to_contiguous_id": {5: 0, 9: 1, 11: 2}}
    JaxDatasetCatalog.register(name, lambda: copy.deepcopy(jax_recs))
    DatasetCatalog.register(name, lambda: copy.deepcopy(recs))
    JaxMetadataCatalog.get(name).set(**meta)
    MetadataCatalog.get(name).set(**meta)
    got = convert_to_coco_dict(name)
    assert _plain(got) == _plain(jax_convert(name))
    assert [a["category_id"] for a in got["annotations"]] == [9, 5, 11]
    assert got["images"][1]["id"] == 1 and got["annotations"][1]["iscrowd"] == 1
    assert got["annotations"][0]["num_keypoints"] == 3


def test_convert_to_coco_json_caches_and_writes_atomically(tmp_path, monkeypatch):
    name = "torch_convert_json"
    DatasetCatalog.register(name, lambda: _records(BoxMode.XYWH_ABS))
    MetadataCatalog.get(name).set(thing_classes=["a", "b", "c"])
    out = tmp_path / "cache" / "coco.json"
    replaced = []
    real_replace = os.replace
    monkeypatch.setattr(os, "replace", lambda a, b: (replaced.append((a, b)), real_replace(a, b)))
    convert_to_coco_json(name, str(out))
    assert replaced == [(str(out) + ".tmp", str(out))] and json.load(open(out)) == _plain(convert_to_coco_dict(name))
    out.write_text("{}")
    convert_to_coco_json(name, str(out))  # cached: kept as it is
    assert out.read_text() == "{}"
    convert_to_coco_json(name, str(out), allow_cached=False)
    assert json.load(open(out))["categories"][0] == {"id": 0, "name": "a"}


def test_rotated_boxes_raise_with_a_message():
    """A rotated (XYWHA) box converts as the JAX package converts it (the
    rotated family is ported): ``convert_to_coco_dict`` keeps it 5-dim,
    ``BoxMode`` gives its XYXY envelope; the conversion the JAX package
    lacks, XYWHA to XYWH, raises with a message on both sides."""
    name = "torch_convert_rotated"
    records = [{"file_name": "r.jpg", "image_id": 1, "height": 10, "width": 10,
                "annotations": [{"bbox": [5, 5, 4, 2, 30], "bbox_mode": BoxMode.XYWHA_ABS, "category_id": 0}]}]
    DatasetCatalog.register(name, lambda: copy.deepcopy(records))
    MetadataCatalog.get(name).set(thing_classes=["a"])
    jax_records = copy.deepcopy(records)
    jax_records[0]["annotations"][0]["bbox_mode"] = JaxBoxMode.XYWHA_ABS
    JaxDatasetCatalog.register(name, lambda: copy.deepcopy(jax_records))
    JaxMetadataCatalog.get(name).set(thing_classes=["a"])
    got = convert_to_coco_dict(name)
    assert got == jax_convert(name) and got["annotations"][0]["bbox"] == [5, 5, 4, 2, 30]
    np.testing.assert_array_equal(BoxMode.convert(np.array([[5, 5, 4, 2, 30]]), BoxMode.XYWHA_ABS, BoxMode.XYXY_ABS),
                                  JaxBoxMode.convert(np.array([[5, 5, 4, 2, 30]]), JaxBoxMode.XYWHA_ABS,
                                                     JaxBoxMode.XYXY_ABS))
    for mode in (BoxMode, JaxBoxMode):
        with pytest.raises(NotImplementedError, match="not supported"):
            mode.convert([5, 5, 4, 2, 30], mode.XYWHA_ABS, mode.XYWH_ABS)


def test_coco_evaluator_converts_a_dataset_without_json_as_jax():
    """Cityscapes records (string ids, XYXY boxes, polygons) scored by both
    packages' ``COCOEvaluator``, which converts the records."""
    from jtsm_tpu_torch.data.datasets.cityscapes import cityscapes_instance_record

    scenes = make_synthetic_cityscapes(3, seed=4, image_hw=(64, 128))
    recs = [cityscapes_instance_record(f"{i}_leftImg8bit.png", poly) for i, _, poly, *_ in scenes]
    jax_recs = copy.deepcopy(recs)
    for r in jax_recs:
        for a in r["annotations"]:
            a["bbox_mode"] = JaxBoxMode.XYXY_ABS
    name = "torch_coco_without_json"
    JaxDatasetCatalog.register(name, lambda: copy.deepcopy(jax_recs))
    DatasetCatalog.register(name, lambda: copy.deepcopy(recs))
    classes = ["person", "rider", "car", "truck", "bus", "train", "motorcycle", "bicycle"]
    JaxMetadataCatalog.get(name).set(thing_classes=classes)
    MetadataCatalog.get(name).set(thing_classes=classes)
    results = []
    for ev in (JaxCOCOEvaluator(name, distributed=False), COCOEvaluator(name)):
        ev.reset()
        for r in recs:
            n = len(r["annotations"]) + 2
            boxes = np.asarray([a["bbox"] for a in r["annotations"]] + [[1, 1, 20, 20], [30, 10, 60, 40]])
            outputs = {"boxes": boxes[None].astype(np.float32),
                       "scores": np.linspace(0.9, 0.2, n, dtype=np.float32)[None],
                       "classes": np.asarray([[a["category_id"] for a in r["annotations"]] + [0, 2]]),
                       "valid": np.ones((1, n), bool)}
            ev.process({"image_ids": np.asarray([r["image_id"]]), "orig_sizes": np.asarray([[64, 128]])}, outputs)
        results.append(ev.evaluate())
    _same_results(*results)
    assert results[1]["bbox"]["AP"] > 50


# -- COCO panoptic (standard) and ADE20K -----------------------------------------------------

def _panoptic_json(path):
    cats = jax_metadata("coco_panoptic_standard")
    thing, stuff = list(cats["thing_dataset_id_to_contiguous_id"]), list(cats["stuff_dataset_id_to_contiguous_id"])
    anns = [{"image_id": 139 + i, "file_name": f"{139 + i:012d}.png",
             "segments_info": [{"id": 3 + i, "category_id": thing[i], "iscrowd": 0, "bbox": [1, 2, 3, 4], "area": 12},
                               {"id": 99, "category_id": stuff[i], "iscrowd": 0, "bbox": [0, 0, 9, 9], "area": 81}]}
            for i in range(3)]
    with open(path, "w") as f:
        json.dump({"annotations": anns, "images": [], "categories": []}, f)


def test_standard_coco_panoptic_loader_and_merge_equal_jax(tmp_path):
    path = tmp_path / "panoptic.json"
    _panoptic_json(path)
    meta = _get_builtin_metadata("coco_panoptic_standard")
    want = jax_builtin.load_coco_panoptic_json(str(path), "img", "pan", jax_metadata("coco_panoptic_standard"))
    got = builtin.load_coco_panoptic_json(str(path), "img", "pan", meta)
    assert _plain(got) == _plain(want)
    assert got[0]["file_name"] == os.path.join("img", "000000000139.jpg") and got[0]["segments_info"][0]["isthing"]
    sem = [{"file_name": r["file_name"], "sem_seg_file_name": f"s{i}.png"} for i, r in enumerate(got)]
    assert _plain(builtin.merge_to_panoptic(got, sem)) == _plain(jax_builtin.merge_to_panoptic(want, sem))
    name = "torch_standard_panoptic"
    builtin.register_coco_panoptic(name, meta, "img", "pan", str(path), "instances.json")
    jax_builtin.register_coco_panoptic(name, jax_metadata("coco_panoptic_standard"), "img", "pan", str(path),
                                       "instances.json")
    assert _plain(DatasetCatalog.get(name)) == _plain(JaxDatasetCatalog.get(name))
    m = MetadataCatalog.get(name)
    assert (m.evaluator_type, m.label_divisor, m.json_file) == ("coco_panoptic_seg", 1000, "instances.json")


def test_ade20k_splits_on_a_written_tree(tmp_path, monkeypatch):
    from PIL import Image

    base = tmp_path / "ADEChallengeData2016"
    for split, dirname in (("train", "training"), ("val", "validation")):
        for d in ("images", "annotations_detectron2"):
            (base / d / dirname).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(base / "images" / dirname / f"ADE_{split}_{i}.jpg")
            Image.fromarray(np.full((8, 8), i, np.uint8)).save(
                base / "annotations_detectron2" / dirname / f"ADE_{split}_{i}.png")
    # fresh catalogs: the builtin splits keep their roots
    import jtsm_tpu.data.catalog as jax_catalog
    import jtsm_tpu_torch.data.catalog as catalog

    cats = {}
    for module, cat in ((builtin, catalog), (jax_builtin, jax_catalog)):
        cats[module] = (cat._DatasetCatalog(), cat._MetadataCatalog())
        monkeypatch.setattr(module, "DatasetCatalog", cats[module][0])
        monkeypatch.setattr(module, "MetadataCatalog", cats[module][1])
        module.register_all_ade20k(str(tmp_path))
    for name in ("ade20k_sem_seg_train", "ade20k_sem_seg_val"):
        got = cats[builtin][0].get(name)
        assert _plain(got) == _plain(cats[jax_builtin][0].get(name)) and len(got) == 2
        meta = cats[builtin][1].get(name)
        assert len(meta.stuff_classes) == 150 and meta.image_root == str(base / "images" / dict(
            ade20k_sem_seg_train="training", ade20k_sem_seg_val="validation")[name])
