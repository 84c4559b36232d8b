"""The port's train input side held against the JAX package on the CPU:
the flips and resizes, the augmentation draws, the instance annotations,
the mask crops and the train loaders on the dev script's synthetic trees.

Tolerances: all equal, bit for bit (images, boxes, polygons, masks, the
batches key for key), except the rasterisation of self-crossing float
polygons, where the port's corner joins differ from Pillow's at a few
vertex pixels (ROADMAP §3); that count is held at what it measured.
"""

import copy
import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data import detection_utils as jax_utils
from jtsm_tpu.data import transforms as JT
from jtsm_tpu.data.build import build_detection_train_loader as jax_train_loader
from jtsm_tpu.data.datasets.builtin import register_coco_panoptic_separated as jax_register_panoptic
from jtsm_tpu.data.datasets.builtin_meta import _get_builtin_metadata as jax_metadata
from jtsm_tpu.data.datasets.coco import register_coco_instances as jax_register
from jtsm_tpu.data.rle import rle_encode as jax_rle_encode
from jtsm_tpu.structures.masks import rasterize_polygons_within_box as jax_rasterize
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu.wsl import add_wsl_config
from jtsm_tpu.wsl.data import build_wsl_train_loader as jax_wsl_train_loader
from jtsm_tpu_torch.config import get_cfg, wsl_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data import detection_utils as utils
from jtsm_tpu_torch.data import transforms as T
from jtsm_tpu_torch.data.build import build_detection_train_loader
from jtsm_tpu_torch.data.datasets.builtin import register_coco_panoptic_separated
from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
from jtsm_tpu_torch.data.datasets.coco import register_coco_instances
from jtsm_tpu_torch.data.samplers import RepeatFactorTrainingSampler
from jtsm_tpu_torch.structures import rasterize_polygons_within_box
from jtsm_tpu_torch.wsl.data import build_wsl_train_loader


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
MRCNN_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_training_acc_test.yaml")
JTSM_YAML = os.path.join(ROOT, "projects/WSL/configs/quick_schedules/jtsm_synthetic_training_acc_test.yaml")
COCO_NAME = "torch_train_coco"
PANOPTIC_NAME = "torch_train_varied_panoptic"  # registers <name>_separated


def register_trees(root: str):
    """Registers the dev script's ``coco`` tree as COCO_NAME and its
    ``cocovar`` tree as PANOPTIC_NAME + "_separated" in both packages;
    returns the names to remove."""
    coco, var = os.path.join(root, "coco"), os.path.join(root, "cocovar")
    ann = "annotations/instances_val2017_100.json"
    for reg, meta in ((jax_register, jax_metadata), (register_coco_instances, _get_builtin_metadata)):
        reg(COCO_NAME, meta("coco"), os.path.join(coco, ann), os.path.join(coco, "val2017"))
    for reg, meta in ((jax_register_panoptic, jax_metadata), (register_coco_panoptic_separated, _get_builtin_metadata)):
        reg(PANOPTIC_NAME, meta("coco_panoptic_separated"), os.path.join(var, "val2017"),
            os.path.join(var, "panoptic_val2017_100"), os.path.join(var, "annotations/panoptic_val2017_100.json"),
            os.path.join(var, "panoptic_stuff_val2017_100"), os.path.join(var, ann))
    return [COCO_NAME, PANOPTIC_NAME + "_separated", PANOPTIC_NAME + "_stuffonly"]


def unregister(names):
    for catalog in (JaxDatasetCatalog, JaxMetadataCatalog, DatasetCatalog, MetadataCatalog):
        for n in names:
            if n in catalog:
                catalog.remove(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The dev script's trees (``--num 8 --num-varied 6``), registered in
    both packages for this module."""
    root = str(tmp_path_factory.mktemp("synthetic_trees"))
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", root,
                    "--num", "8", "--num-varied", "6"], check=True, capture_output=True, cwd=ROOT)
    names = register_trees(root)
    yield root
    unregister(names)


def _assert_same(want, got, where=""):
    if isinstance(want, dict):
        assert sorted(want) == sorted(got), where
        for k in want:
            _assert_same(want[k], got[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), where
        for i, (a, b) in enumerate(zip(want, got)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert want.dtype == np.asarray(got).dtype and want.shape == np.shape(got), where
        np.testing.assert_array_equal(want, got, err_msg=where)
    else:
        assert want == got, where


# -- transforms and draws --------------------------------------------------------

TRANSFORMS = {
    "hflip": (lambda h, w: JT.HFlipTransform(w), lambda h, w: T.HFlipTransform(w)),
    "vflip": (lambda h, w: JT.VFlipTransform(h), lambda h, w: T.VFlipTransform(h)),
    "down": (lambda h, w: JT.ResizeTransform(h, w, 31, 44), lambda h, w: T.ResizeTransform(h, w, 31, 44)),
    "up": (lambda h, w: JT.ResizeTransform(h, w, 101, 77), lambda h, w: T.ResizeTransform(h, w, 101, 77)),
}


@pytest.mark.parametrize("kind", sorted(TRANSFORMS))
def test_transforms_equal_jax(kind):
    """Images (uint8 and float), boxes, polygons and segmentations (uint8
    and int ids) through a flip or resize and their chain with a flip."""
    rng = np.random.RandomState(3)
    h, w = 57, 83
    jax_make, make = TRANSFORMS[kind]
    out_w = getattr(make(h, w), "new_w", w)
    jt = JT.TransformList([jax_make(h, w), JT.HFlipTransform(out_w)])
    pt = T.TransformList([make(h, w), T.HFlipTransform(out_w)])
    for j, p in ((jax_make(h, w), make(h, w)), (jt, pt)):
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        _assert_same(j.apply_image(img), p.apply_image(img), "uint8 image")
        fimg = rng.rand(h, w, 3).astype(np.float32) * 255
        _assert_same(j.apply_image(fimg), p.apply_image(fimg), "float image")
        xy = rng.rand(7, 2, 2) * [w, h]
        boxes = np.concatenate([xy.min(1), xy.max(1)], axis=1)
        _assert_same(j.apply_box(boxes), p.apply_box(boxes), "boxes")
        polys = [rng.rand(2 * k) * np.tile([w, h], k) for k in (3, 5)]
        _assert_same(j.apply_polygons(polys), p.apply_polygons(polys), "polygons")
        seg = rng.randint(0, 5, (h, w)).astype(np.uint8)
        _assert_same(j.apply_segmentation(seg), p.apply_segmentation(seg), "uint8 seg")
        ids = rng.randint(0, 900, (h, w)).astype(np.int32)
        _assert_same(j.apply_segmentation(ids), p.apply_segmentation(ids), "id seg")


@pytest.mark.parametrize("aug", ["range", "choice", "flip", "vflip"])
def test_augmentation_draws_equal_jax(aug):
    """The JAX package draws from the global ``np.random``, the port from a
    ``RandomState`` of the same seed: 200 draws give the same transforms."""
    img = np.zeros((60, 90, 3), np.uint8)
    if aug == "flip" or aug == "vflip":
        jax_aug = JT.RandomFlip(horizontal=aug == "flip", vertical=aug == "vflip")
        port = T.RandomFlip(horizontal=aug == "flip", vertical=aug == "vflip")
    else:
        sizes = (40, 80) if aug == "range" else (40, 48, 56, 96)
        jax_aug = JT.ResizeShortestEdge(sizes, 120, aug)
        port = T.ResizeShortestEdge(sizes, 120, aug)
    np.random.seed(11)
    want = [jax_aug.get_transform(img) for _ in range(200)]
    rng = np.random.RandomState(11)
    got = [port.get_transform(img, port.draw(rng)) for _ in range(200)]
    assert len({type(t).__name__ for t in want}) == 2 or len({(t.new_h, t.new_w) for t in want}) > 3
    for a, b in zip(want, got):
        assert type(a).__name__ == type(b).__name__
        assert {k: v for k, v in vars(a).items() if k != "interp"} == vars(b)


# -- annotations -----------------------------------------------------------------


def _annotations(h, w):
    """A polygon object of two parts, a float rectangle, an RLE object, a
    crowd, a degenerate (zero-width) polygon and an object without
    polygons."""
    mask = np.zeros((h, w), bool)
    mask[10:30, 40:71] = True
    rle = jax_rle_encode(mask)
    return [
        {"bbox": [5.5, 6.25, 30.0, 22.5], "bbox_mode": 1, "category_id": 3, "iscrowd": 0,
         "segmentation": [[5.5, 6.25, 35.5, 6.25, 35.5, 28.75, 5.5, 28.75], [8.2, 9.1, 20.7, 9.9, 14.3, 20.4]]},
        {"bbox": [44.3, 30.1, 61.9, 52.6], "bbox_mode": 0, "category_id": 7, "iscrowd": 0,
         "segmentation": [[44.3, 30.1, 61.9, 30.1, 61.9, 52.6, 44.3, 52.6]]},
        {"bbox": [40, 10, 31, 20], "bbox_mode": 1, "category_id": 1, "iscrowd": 0, "segmentation": rle},
        {"bbox": [0, 0, 20, 20], "bbox_mode": 1, "category_id": 2, "iscrowd": 1, "segmentation": rle},
        {"bbox": [12.0, 40.0, 0.0, 10.0], "bbox_mode": 1, "category_id": 4, "iscrowd": 0,
         "segmentation": [[12.0, 40.0, 12.0, 50.0, 12.0, 45.0]]},
        {"bbox": [60.0, 5.0, 10.0, 8.0], "bbox_mode": 1, "category_id": 5, "iscrowd": 0, "segmentation": []},
    ]


@pytest.mark.parametrize("mask_format,flip", [("polygon", False), ("polygon", True), ("bitmask", True)])
def test_annotations_to_static_targets_equal_jax(mask_format, flip):
    """``transform_instance_annotations`` (polygons, RLE, a crowd, a
    degenerate and an empty polygon) under a resize and a flip, then
    ``annotations_to_instances``, ``filter_empty_instances`` and
    ``instances_to_static_targets`` with 56x56 crops. RLE takes the
    bitmask format: in the polygon format the port raises, as detectron2
    does (the JAX package rasterises the decoded mask's rows as a
    polygon, ROADMAP §3)."""
    h, w = 60, 90
    nh, nw = 83, 124
    jt = JT.TransformList([JT.ResizeTransform(h, w, nh, nw)] + ([JT.HFlipTransform(nw)] if flip else []))
    pt = T.TransformList([T.ResizeTransform(h, w, nh, nw)] + ([T.HFlipTransform(nw)] if flip else []))
    annos = [a for a in _annotations(h, w) if a["iscrowd"] == 0]
    if mask_format == "polygon":
        annos = [a for a in annos if isinstance(a["segmentation"], list)]
    want = [jax_utils.transform_instance_annotations(copy.deepcopy(a), jt, (nh, nw)) for a in annos]
    got = [utils.transform_instance_annotations(copy.deepcopy(a), pt, (nh, nw)) for a in annos]
    _assert_same(want, got)
    if mask_format == "polygon":  # PolygonMasks needs 3 points a polygon: the empty one only
        want, got = [a for a in want if len(a["segmentation"]) != 1 or len(a["segmentation"][0]) >= 6], \
            [a for a in got if len(a["segmentation"]) != 1 or len(a["segmentation"][0]) >= 6]
    ji = jax_utils.annotations_to_instances(want, (nh, nw), mask_format)
    pi = utils.annotations_to_instances(got, (nh, nw), mask_format)
    _assert_same(ji.gt_boxes, pi.gt_boxes)
    _assert_same(ji.gt_classes, pi.gt_classes)
    jf, pf = jax_utils.filter_empty_instances(ji), utils.filter_empty_instances(pi)
    assert len(pf) == len(jf) < len(pi)
    _assert_same(jax_utils.instances_to_static_targets(jf, 6, 56), utils.instances_to_static_targets(pf, 6, 56))
    if mask_format == "polygon":
        with pytest.raises(ValueError, match="bitmask"):
            rle = utils.transform_instance_annotations(copy.deepcopy(_annotations(h, w)[2]), pt, (nh, nw))
            utils.annotations_to_instances([rle], (nh, nw), "polygon")


def test_mapper_drops_crowds_and_empty_instances_as_jax(trees):
    """The train mapper on the dev tree's records plus a crowd and an empty
    polygon: the same instances as the JAX mapper's, in the same order."""
    from jtsm_tpu.data.dataset_mapper import DatasetMapper as JaxMapper
    from jtsm_tpu_torch.data.dataset_mapper import DatasetMapper

    jc, pc = _cfgs(MRCNN_YAML)
    records = DatasetCatalog.get(COCO_NAME)[:3]
    extra = _annotations(records[0]["height"], records[0]["width"])
    records[0]["annotations"] += [extra[3], extra[5]]
    jm, pm = JaxMapper(jc, True), DatasetMapper(pc, True)
    np.random.seed(5)
    pm.rng = np.random.RandomState(5)
    for r in records:
        a, b = jm(copy.deepcopy(r)), pm(copy.deepcopy(r))
        ja, pa = a.pop("instances"), b.pop("instances")
        _assert_same({k: v for k, v in a.items() if k != "annotations"}, b)
        _assert_same(jax_utils.instances_to_static_targets(ja, 8, 56), utils.instances_to_static_targets(pa, 8, 56))
    assert len(pa) == len([x for x in records[-1]["annotations"] if not x.get("iscrowd")])


# -- mask crops -------------------------------------------------------------------


def _float_polygons(kind, rng):
    if kind == "rectangle":
        x0, y0 = rng.uniform(-10, 60, 2)
        bw, bh = rng.uniform(0.5, 70, 2)
        return [np.array([x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh])]
    if kind == "convex":
        k = rng.randint(3, 9)
        ang = np.sort(rng.uniform(0, 2 * np.pi, k))
        c, r = rng.uniform(0, 70, 2), rng.uniform(3, 40, k)
        return [np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)], 1).reshape(-1)]
    return [rng.uniform(-5, 80, 2 * rng.randint(4, 10))]


@pytest.mark.parametrize("kind,allowed", [("rectangle", 0), ("convex", 0), ("self_crossing", 16)])
def test_mask_crops_of_float_polygons_equal_jax(kind, allowed):
    """``rasterize_polygons_within_box`` of 300 seeded float polygons into
    56x56 crops of a box around them (partly cut by it): rectangles and
    convex polygons equal the JAX package's Pillow fill pixel for pixel
    (Pillow truncates float vertices toward zero, as the port does).
    Self-crossing ones are held to the corner-join count the port
    measured (4 polygons of 300, 16 pixels of the 281,785 Pillow fills;
    ROADMAP §3)."""
    rng = np.random.RandomState({"rectangle": 0, "convex": 1, "self_crossing": 2}[kind])
    diff = differing = filled = 0
    for _ in range(300):
        polys = _float_polygons(kind, rng)
        pts = np.concatenate(polys).reshape(-1, 2)
        box = np.concatenate([pts.min(0), pts.max(0)]).astype(np.float32)
        box += rng.uniform(-3, 3, 4).astype(np.float32)
        want = jax_rasterize(polys, box, 56)
        got = rasterize_polygons_within_box(polys, box, 56)
        d = int((want != got).sum())
        diff, differing, filled = diff + d, differing + (d > 0), filled + int(want.sum())
    assert filled > 100_000
    assert diff <= allowed, (differing, diff, filled)


# -- loaders ----------------------------------------------------------------------


def _cfgs(yaml, opts=(), wsl=False):
    jc = jax_get_cfg()
    pc = wsl_cfg() if wsl else get_cfg()
    if wsl:
        add_wsl_config(jc)
    for c in (jc, pc):
        c.merge_from_file(yaml)
        c.merge_from_list(list(opts))
    return jc, pc


def _first_batches(it, n=6):
    it = iter(it)
    out = [next(it) for _ in range(n)]
    it.close() if hasattr(it, "close") else None
    return out


TRAIN_OPTS = ["DATASETS.TRAIN", f"('{COCO_NAME}',)", "INPUT.MIN_SIZE_TRAIN", "(96, 112, 128)",
              "INPUT.MIN_SIZE_TRAIN_SAMPLING", "choice", "TPU.MAX_GT_INSTANCES", "5"]


@pytest.fixture(scope="module")
def jax_batches(trees):
    jc, _ = _cfgs(MRCNN_YAML, TRAIN_OPTS)
    jax_seed_all_rng(jc.SEED)
    return _first_batches(jax_train_loader(jc))


@pytest.mark.parametrize("workers", [0, 2])
def test_train_loader_batches_equal_jax(trees, jax_batches, workers):
    """The first 6 batches of ``build_detection_train_loader`` on the dev
    tree (SEED 42, three short sides, the flip, aspect grouping): equal key
    for key to the JAX package's (NUM_WORKERS 0), images bit for bit; with
    2 mapping threads the port's batches are the same. The loader times
    each record's mapping in the thread that maps it."""
    _, pc = _cfgs(MRCNN_YAML, TRAIN_OPTS + ["DATALOADER.NUM_WORKERS", str(workers)])
    loader = build_detection_train_loader(pc)
    got = _first_batches(loader)
    _assert_same(jax_batches, got)
    assert loader.batches >= 6 and loader.map_seconds > 0
    assert len({b["image"].shape for b in got}) == 1 and got[0]["gt_mask_crops"].shape == (4, 5, 56, 56)
    assert sum(int(b["gt_valid"].sum()) for b in got) > 20


def test_wsl_train_loader_batches_equal_jax(trees):
    """``build_wsl_train_loader`` on the cocovar tree with its MCG-style
    proposals (superpixels, membership), the flip and two short sides:
    6 batches equal to the JAX package's, key for key."""
    opts = ["DATASETS.TRAIN", f"('{PANOPTIC_NAME}_separated',)", "DATASETS.PROPOSAL_FILES_TRAIN",
            f"('{os.path.join(trees, 'cocovar', 'proposals_val2017_100.pkl')}',)",
            "INPUT.MIN_SIZE_TRAIN", "(112, 128)"]
    jc, pc = _cfgs(JTSM_YAML, opts, wsl=True)
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_wsl_train_loader(jc))
    got = _first_batches(build_wsl_train_loader(pc))
    _assert_same(want, got)
    assert {"superpixels", "oh_labels", "gt_sem_seg", "proposals"} <= set(got[0])


def test_bucket_that_holds_no_batch_raises():
    """The JTSM flagship's 1200 train scale makes a 375x500 image 1200x1600,
    which none of the default buckets holds: a ValueError names the size
    and the buckets (the JAX package fails in numpy's broadcast)."""
    img = {"image": np.zeros((1200, 1600, 3), np.float32), "height": 375, "width": 500}
    with pytest.raises(ValueError, match="1200x1600"):
        utils.build_static_batch([img], [[800, 1344], [1344, 800], [1024, 1024]])
    batch = utils.build_static_batch([img], [[800, 1344], [1200, 1600]])
    assert batch["image"].shape == (1, 1200, 1600, 3)


def test_repeat_factor_sampler_equals_jax():
    """RepeatFactorTrainingSampler: the same factors and the same first 200
    indices as the JAX package's for the same seed."""
    from jtsm_tpu.data.samplers import RepeatFactorTrainingSampler as JaxSampler

    rng = np.random.RandomState(0)
    dicts = [{"annotations": [{"category_id": int(c)} for c in rng.randint(0, 6, rng.randint(1, 4))]}
             for _ in range(30)]
    want = JaxSampler.repeat_factors_from_category_frequency(dicts, 0.3)
    got = RepeatFactorTrainingSampler.repeat_factors_from_category_frequency(dicts, 0.3)
    _assert_same(want, got)
    assert want.max() > 1
    a, b = iter(JaxSampler(want, seed=9)), iter(RepeatFactorTrainingSampler(got, seed=9))
    assert [next(a) for _ in range(200)] == [next(b) for _ in range(200)]


def test_proposal_pickle_unchanged_by_the_loader(trees):
    """The loader reads the proposal pickle and leaves it as it was."""
    path = os.path.join(trees, "cocovar", "proposals_val2017_100.pkl")
    with open(path, "rb") as f:
        before = pickle.load(f)
    opts = ["DATASETS.TRAIN", f"('{PANOPTIC_NAME}_separated',)", "DATASETS.PROPOSAL_FILES_TRAIN", f"('{path}',)"]
    _first_batches(build_wsl_train_loader(_cfgs(JTSM_YAML, opts, wsl=True)[1]), 1)
    with open(path, "rb") as f:
        after = pickle.load(f)
    _assert_same(before["ids"], after["ids"])
