"""INPUT.CROP in the port held against the JAX package on the CPU, bit for
bit where it is data (the crops' draws under the same ``np.random`` seed,
``CropTransform`` on images, boxes, polygons and segmentations,
``gen_crop_transform_with_instance``, the train loaders' batches with the
crop first: images, boxes, classes, the mask crops of the boxes recomputed
from the cropped polygons, the stuff maps under the category-area crop, the
MCG proposals with their superpixel map and membership), then WSDDN R-18
DC5 (``wsddn_R_18_DC5_1x.yaml``, which sets INPUT.CROP) narrowed
(``config.wsddn_R_18_narrow_cfg``): one train step on a batch of the
port's cropped loader, the losses within 1e-4 relative and the gradients
within 1e-4 of each parameter's L2 norm (the tolerances of
``tests/test_torch_wsod.py``), the DAN's dropout off on both sides.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.data import detection_utils as jax_utils
from jtsm_tpu.data import transforms as JT
from jtsm_tpu.data.build import build_detection_train_loader as jax_train_loader
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu.wsl.data import build_wsl_train_loader as jax_wsl_train_loader
from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw
from jtsm_tpu.wsl.modeling import wsod_zoo as jax_zoo
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import wsddn_R_18_narrow_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data import detection_utils as utils
from jtsm_tpu_torch.data import transforms as T
from jtsm_tpu_torch.data.build import build_detection_train_loader
from jtsm_tpu_torch.data.dataset_mapper import DatasetMapper
from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.wsl.data import build_wsl_train_loader
from jtsm_tpu_torch.wsl.train_net import Trainer as WSLTrainer
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_meta_archs import _random_variables
from tests.test_torch_train_loader import (  # noqa: F401  (the fixture)
    COCO_NAME,
    JTSM_YAML,
    MRCNN_YAML,
    PANOPTIC_NAME,
    _assert_same,
    _cfgs,
    _first_batches,
    trees,
)

TOL = 1e-4
CROPS = {
    "relative_range": ("relative_range", [0.6, 0.7]),
    "relative": ("relative", [0.5, 0.8]),
    "absolute": ("absolute", [40, 70]),
    "absolute_range": ("absolute_range", [30, 80]),
}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", sorted(CROPS) + ["category_area"])
def test_crop_draws_equal_jax(kind):
    """150 windows of a 60x90 image from the same seed, the JAX package's
    from the global ``np.random``, the port's from a ``RandomState``; the
    category-area crop retries on a stuff map of three bands."""
    img = np.zeros((60, 90, 3), np.uint8)
    sem = np.zeros((60, 90), np.uint8)
    sem[20:, :] = 1
    sem[45:, 30:] = 255
    if kind == "category_area":
        jax_aug = JT.RandomCrop_CategoryAreaConstraint("relative_range", [0.3, 0.3], 0.6, 255)
        port = T.RandomCrop_CategoryAreaConstraint("relative_range", [0.3, 0.3], 0.6, 255)
        args = (img, sem)
    else:
        jax_aug, port, args = JT.RandomCrop(*CROPS[kind]), T.RandomCrop(*CROPS[kind]), (img,)
    np.random.seed(5)
    want = [jax_aug.get_transform(*args) for _ in range(150)]
    rng = np.random.RandomState(5)
    got = [port.get_transform(*args, drawn=port.draw(rng, img.shape[:2], sem)) for _ in range(150)]
    assert [vars(a) for a in want] == [vars(b) for b in got]
    assert len({(t.x0, t.y0, t.w, t.h) for t in got}) > (1 if kind == "relative" else 50) or kind == "absolute"
    assert np.random.rand() == rng.rand()  # the same number of draws


def test_crop_transform_equal_jax():
    """Images, boxes (corners past the window), polygons (not clipped),
    uint8 and int segmentations through a crop and through the chain crop,
    resize, flip."""
    rng = np.random.RandomState(3)
    h, w = 57, 83
    crop = (11, 7, 50, 40)
    chains = [(JT.CropTransform(*crop), T.CropTransform(*crop)),
              (JT.TransformList([JT.CropTransform(*crop), JT.ResizeTransform(40, 50, 61, 77), JT.HFlipTransform(77)]),
               T.TransformList([T.CropTransform(*crop), T.ResizeTransform(40, 50, 61, 77), T.HFlipTransform(77)]))]
    for j, p in chains:
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        _assert_same(j.apply_image(img), p.apply_image(img), "image")
        xy = rng.rand(9, 2, 2) * [w, h]
        boxes = np.concatenate([xy.min(1), xy.max(1)], axis=1)
        _assert_same(j.apply_box(boxes), p.apply_box(boxes), "boxes")
        polys = [rng.rand(2 * k) * np.tile([w, h], k) for k in (3, 6)]
        _assert_same(j.apply_polygons(polys), p.apply_polygons(polys), "polygons")
        seg = rng.randint(0, 5, (h, w)).astype(np.uint8)
        _assert_same(j.apply_segmentation(seg), p.apply_segmentation(seg), "seg")
        ids = rng.randint(0, 900, (h, w)).astype(np.int32)
        _assert_same(j.apply_segmentation(ids), p.apply_segmentation(ids), "ids")


def test_gen_crop_transform_with_instance_equals_jax():
    instances = [{"bbox": [10.0, 12.0, 30.0, 20.0], "bbox_mode": 1}, {"bbox": [5.5, 40.0, 80.0, 55.0], "bbox_mode": 0}]
    np.random.seed(7)
    want = [jax_utils.gen_crop_transform_with_instance((32, 48), (60, 90), inst) for inst in instances * 20]
    rng = np.random.RandomState(7)
    got = [utils.gen_crop_transform_with_instance((32, 48), (60, 90), inst, rng) for inst in instances * 20]
    assert [tuple(int(v) for v in vars(a).values()) for a in want] == [
        tuple(int(v) for v in vars(b).values()) for b in got]


def test_mapper_puts_the_crop_first():
    _, pc = _cfgs(MRCNN_YAML, ["INPUT.CROP.ENABLED", "True"])
    mapper = DatasetMapper(pc, True)
    assert type(mapper.augmentations.augs[0]) is T.RandomCrop and mapper.recompute_boxes and mapper.draws_on_record
    pc.INPUT.CROP.SINGLE_CATEGORY_MAX_AREA = 0.5
    assert type(DatasetMapper(pc, True).augmentations.augs[0]) is T.RandomCrop_CategoryAreaConstraint
    assert not DatasetMapper(pc, False).draws_on_record
    with pytest.raises(ValueError, match="must come first"):
        T.AugmentationList([T.RandomFlip(), T.RandomCrop("relative", [0.5, 0.5])]).draw(np.random, (10, 10))


CROP_OPTS = ["DATASETS.TRAIN", f"('{COCO_NAME}',)", "INPUT.MIN_SIZE_TRAIN", "(96, 112, 128)",
             "INPUT.MIN_SIZE_TRAIN_SAMPLING", "choice", "TPU.MAX_GT_INSTANCES", "5", "INPUT.CROP.ENABLED", "True",
             "INPUT.CROP.SIZE", "[0.5, 0.6]"]


@pytest.mark.parametrize("workers", [0, 2])
def test_cropped_train_loader_batches_equal_jax(trees, workers):
    """Mask R-CNN's loader on the dev tree with the crop: 5 batches equal
    to the JAX package's, key for key, the boxes recomputed from the
    cropped polygons; with 2 mapping threads the same."""
    jc, pc = _cfgs(MRCNN_YAML, CROP_OPTS + ["DATALOADER.NUM_WORKERS", str(workers)])
    jc.DATALOADER.NUM_WORKERS = 0
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_train_loader(jc), 5)
    got = _first_batches(build_detection_train_loader(pc), 5)
    _assert_same(want, got)
    assert sum(int(b["gt_valid"].sum()) for b in got) > 10


def test_category_area_crop_of_stuff_maps_equals_jax(trees):
    """The panoptic tree's stuff maps under the category-area crop: the
    draws read each record's map, the batches' ``gt_sem_seg`` equal."""
    opts = ["DATASETS.TRAIN", f"('{PANOPTIC_NAME}_separated',)", "INPUT.MIN_SIZE_TRAIN", "(96, 112)",
            "TPU.MAX_GT_INSTANCES", "8", "INPUT.CROP.ENABLED", "True", "INPUT.CROP.SIZE", "[0.4, 0.4]",
            "INPUT.CROP.SINGLE_CATEGORY_MAX_AREA", "0.6", "MODEL.META_ARCHITECTURE", "PanopticFPN",
            "DATALOADER.FILTER_EMPTY_ANNOTATIONS", "False"]
    jc, pc = _cfgs(MRCNN_YAML, opts)
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_train_loader(jc), 4)
    got = _first_batches(build_detection_train_loader(pc), 4)
    _assert_same(want, got)
    assert "gt_sem_seg" in got[0]


def test_cropped_wsl_loader_equals_jax(trees):
    """The WSL loader with the MCG-style proposals of the cocovar tree and
    the crop: the proposals clipped to the window and filtered, the
    superpixel map cropped, the membership rows following their boxes."""
    opts = ["DATASETS.TRAIN", f"('{PANOPTIC_NAME}_separated',)", "DATASETS.PROPOSAL_FILES_TRAIN",
            f"('{os.path.join(trees, 'cocovar', 'proposals_val2017_100.pkl')}',)",
            "INPUT.MIN_SIZE_TRAIN", "(112, 128)", "INPUT.CROP.ENABLED", "True", "INPUT.CROP.SIZE", "[0.5, 0.5]"]
    jc, pc = _cfgs(JTSM_YAML, opts, wsl=True)
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_wsl_train_loader(jc), 4)
    got = _first_batches(build_wsl_train_loader(pc), 4)
    _assert_same(want, got)
    assert {"superpixels", "oh_labels", "proposals"} <= set(got[0])


@pytest.fixture
def _jax_dan_without_dropout(monkeypatch):
    no_dropout = functools.partial(jax_rhw.DiscriminativeAdaptionNeck, dropout=0.0)
    monkeypatch.setattr(jax_rhw, "DiscriminativeAdaptionNeck", no_dropout)
    monkeypatch.setattr(jax_zoo, "DiscriminativeAdaptionNeck", no_dropout)


def test_wsddn_R_18_train_step_with_the_crop_matches_jax(_jax_dan_without_dropout):
    name = "torch_crop_voc"
    proposals = register_synthetic_voc(name, num=6, seed=2, image_hw=(150, 200))
    try:
        cfg = wsddn_R_18_narrow_cfg()
        cfg.DATASETS.TRAIN = (name,)
        cfg.DATASETS.PROPOSAL_FILES_TRAIN = (proposals,)
        cfg.SOLVER.IMS_PER_BATCH = 2
        assert cfg.INPUT.CROP.ENABLED and cfg.MODEL.BACKBONE.FREEZE_AT == 2
        it = iter(WSLTrainer.build_train_loader(cfg))
        batch = {k: v for k, v in next(it).items() if k != "image_ids"}
        it.close()
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    assert batch["image"].shape == (2, 128, 176, 3) and (batch["image_sizes"] < [[128, 176]]).any()
    jm = jax_build_model(_jax_cfg(cfg))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = _random_variables(jm, jb, seed=0, train=False)

    def loss(p):
        out = jm.apply({**variables, "params": p}, jb, train=True,
                       rngs={"dropout": jax.random.key(0), "sampling": jax.random.key(0)})
        return sum(out.values()), out

    with jax.default_matmul_precision("highest"):
        (_, want_losses), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    model.train()
    model.roi_heads.dan.dropout = 0.0
    losses = model(batch)
    assert sorted(losses) == sorted(want_losses)
    for k in losses:
        assert abs(float(want_losses[k]) - losses[k].item()) <= TOL * abs(float(want_losses[k])), k
    sum(losses.values()).backward()
    want_grads = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, grads)})
    scale = max(float(np.linalg.norm(g.numpy())) for g in want_grads.values())
    trained = 0
    for n, p in model.named_parameters():
        w = want_grads[n].numpy()
        g = np.zeros_like(w) if p.grad is None else p.grad.numpy()
        assert np.linalg.norm(w - g) / max(np.linalg.norm(w), 1e-2 * scale) <= TOL, n
        trained += p.grad is not None and "res3" in n
    assert trained > 0 and model.backbone.stem.conv1.weight.grad is None  # FREEZE_AT 2
