"""The port's scoring input side held against the JAX package (and
Pillow) on the CPU: the resize, polygon rasterisation, the COCO json
loader and metadata, the test mapper and collator, and the in-memory
synthetic set; and the card's path without Pillow.

Tolerances: all equal (bit for bit), except the rasterisation of general
polygons: the 447,275 pixels Pillow fills for 400 seeded random polygons
are equal, as is every polygon of the synthetic set (axis-aligned
rectangles); on polygons of up to 11 vertices, whose rows the edges cross
many times, the port's corner joins differ from Pillow's at a few vertex
pixels, held at the measured count.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image, ImageDraw

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data.build import build_detection_test_loader as jax_test_loader
from jtsm_tpu.data.datasets.coco import register_coco_instances as jax_register
from jtsm_tpu.data.detection_utils import read_image as jax_read_image
from jtsm_tpu.data.transforms import ResizeTransform as JaxResizeTransform
from jtsm_tpu.structures.masks import polygons_to_bitmask as jax_polygons_to_bitmask
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog, build_detection_test_loader
from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
from jtsm_tpu_torch.data.datasets.coco import register_coco_instances
from jtsm_tpu_torch.data.datasets.synthetic import make_synthetic_coco, register_synthetic_coco, write_synthetic_coco
from jtsm_tpu_torch.data.detection_utils import read_image
from jtsm_tpu_torch.data.transforms import ResizeShortestEdge, ResizeTransform
from jtsm_tpu_torch.structures import polygons_to_bitmask

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml")
JSON_NAME = "instances_val2017_100.json"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The dev script's synthetic COCO tree (``--num 8``), written for this module."""
    root = tmp_path_factory.mktemp("synthetic_coco")
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8", "--num-varied", "1"], check=True, capture_output=True, cwd=ROOT)
    return os.path.join(str(root), "coco")


def _gate_images(tree):
    with open(os.path.join(tree, "annotations", JSON_NAME)) as f:
        coco = json.load(f)
    return coco, [os.path.join(tree, "val2017", im["file_name"]) for im in coco["images"]]


def test_resize_bit_equal_to_pillow_on_the_gate_images(tree):
    """Every gate image, decoded as the gate reads it (BGR), resized to
    the gate's test size by the port and by the JAX package's Pillow call."""
    _, files = _gate_images(tree)
    shapes = set()
    for f in files:
        img = jax_read_image(f, "BGR")
        h, w = img.shape[:2]
        nh, nw = ResizeShortestEdge.get_output_shape(h, w, 128, 176)
        want = JaxResizeTransform(h, w, nh, nw).apply_image(img)
        got = ResizeTransform(h, w, nh, nw).apply_image(img)
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        shapes.add((h, w, nh, nw))
    assert len(shapes) == len(files)


RESIZES = [
    ((480, 640), (800, 1067)),  # the flagship's test resize of a COCO-sized image
    ((300, 400), (128, 171)),
    ((57, 91), (33, 200)),  # down in one axis, up in the other
    ((320, 320), (128, 128)),
    ((5, 7), (60, 3)),
    ((1, 9), (4, 4)),
    ((100, 100), (100, 37)),  # one axis only
    ((33, 47), (33, 47)),  # no change
]


@pytest.mark.parametrize("src,dst", RESIZES, ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in RESIZES])
def test_resize_bit_equal_to_pillow_on_random_images(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for channels in (3, 0):
        shape = src + ((channels,) if channels else ())
        img = rng.integers(0, 256, shape).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize(dst[::-1], Image.BILINEAR))
        np.testing.assert_array_equal(ResizeTransform(*src, *dst).apply_image(img), want)


def test_rasteriser_bit_equal_to_jax_on_the_gate_polygons(tree):
    coco, _ = _gate_images(tree)
    sizes = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}
    for a in coco["annotations"]:
        h, w = sizes[a["image_id"]]
        want = jax_polygons_to_bitmask([np.asarray(p) for p in a["segmentation"]], h, w)
        got = polygons_to_bitmask([np.asarray(p) for p in a["segmentation"]], h, w)
        np.testing.assert_array_equal(got, want)
        assert got.sum() > 0
    assert len(coco["annotations"]) >= 8


def _pillow_fill(polys, h, w):
    img = Image.new("L", (w, h), 0)
    draw = ImageDraw.Draw(img)
    for p in polys:
        draw.polygon([(p[i], p[i + 1]) for i in range(0, len(p), 2)], outline=1, fill=1)
    return np.asarray(img, bool)


def test_rasteriser_against_pillow_on_rectangles_and_random_polygons():
    rng = np.random.default_rng(0)
    for _ in range(300):  # rectangles of the synthetic generator's distribution: equal
        h, w = int(rng.integers(240, 321)), int(rng.integers(320, 401))
        bw, bh = rng.uniform(20, w / 2), rng.uniform(20, h / 2)
        x, y = rng.uniform(0, w - bw - 1), rng.uniform(0, h - bh - 1)
        poly = [x, y, x + bw, y, x + bw, y + bh, x, y + bh]
        np.testing.assert_array_equal(polygons_to_bitmask([poly], h, w), _pillow_fill([poly], h, w))
    rng = np.random.default_rng(0)
    differ = filled = 0
    for _ in range(400):  # random polygons, partly outside a 64x80 image
        poly = list(rng.uniform(-10, 90, 2 * int(rng.integers(3, 9))))
        want = _pillow_fill([poly], 64, 80)
        differ += int((polygons_to_bitmask([poly], 64, 80) != want).sum())
        filled += int(want.sum())
    assert filled > 400_000
    assert differ == 0, differ  # measured 0


def test_rasteriser_against_pillow_on_crowded_polygons():
    """Polygons of up to 11 random vertices: the rows where one polygon's
    edges cross many times are where the corner joins can still differ from
    Pillow's (ROADMAP §3), held at the measured count."""
    rng = np.random.default_rng(1)
    differ = filled = 0
    for _ in range(2000):
        poly = list(rng.uniform(-10, 130, 2 * int(rng.integers(3, 12))))
        want = _pillow_fill([poly], 96, 120)
        differ += int((polygons_to_bitmask([poly], 96, 120) != want).sum())
        filled += int(want.sum())
    assert filled > 5_000_000
    assert differ <= 20, differ  # measured 20, in 10 of the 2000 polygons


def test_load_coco_json_and_metadata_match_jax(tree):
    coco, _ = _gate_images(tree)
    json_file = os.path.join(tree, "annotations", JSON_NAME)
    image_root = os.path.join(tree, "val2017")
    name = "torch_test_data_coco"
    jax_register(name, {}, json_file, image_root)
    register_coco_instances(name, _get_builtin_metadata("coco"), json_file, image_root)
    try:
        want, got = JaxDatasetCatalog.get(name), DatasetCatalog.get(name)
        assert got == want
        assert len(got) == 8 and all(len(r["annotations"]) >= 1 for r in got)
        jm, m = JaxMetadataCatalog.get(name), MetadataCatalog.get(name)
        assert m.thing_classes == jm.thing_classes
        assert m.thing_dataset_id_to_contiguous_id == jm.thing_dataset_id_to_contiguous_id
        assert m.evaluator_type == jm.evaluator_type == "coco"
        assert m.json_file == json_file
    finally:
        for catalog in (JaxDatasetCatalog, DatasetCatalog, JaxMetadataCatalog, MetadataCatalog):
            catalog.remove(name)


def test_mapper_and_collator_match_jax_test_loader(tree):
    """The gate config's test loader: decoded, resized, bucketed batches."""
    json_file = os.path.join(tree, "annotations", JSON_NAME)
    image_root = os.path.join(tree, "val2017")
    name = "torch_test_data_loader"
    jax_register(name, {}, json_file, image_root)
    register_coco_instances(name, _get_builtin_metadata("coco"), json_file, image_root)
    try:
        jcfg = jax_get_cfg()
        jcfg.merge_from_file(GATE_YAML)
        cfg = get_cfg()
        cfg.merge_from_file(GATE_YAML)
        for batch_size in (1, 3):  # 3: the final batch is padded and trimmed
            want = list(jax_test_loader(jcfg, name, batch_size=batch_size))
            got = list(build_detection_test_loader(cfg, name, batch_size=batch_size))
            assert len(got) == len(want) == -(-8 // batch_size)
            for g, w in zip(got, want):
                assert sorted(g) == ["image", "image_ids", "image_sizes", "orig_sizes"]
                for k in g:
                    assert g[k].dtype == w[k].dtype, k
                    np.testing.assert_array_equal(g[k], w[k])
        np.testing.assert_array_equal(np.concatenate([b["image_ids"] for b in got]), np.arange(8))
        assert {tuple(b["image"].shape[1:3]) for b in got} <= {(128, 176), (176, 176)}
    finally:
        for catalog in (JaxDatasetCatalog, DatasetCatalog, JaxMetadataCatalog, MetadataCatalog):
            catalog.remove(name)


def test_read_image_matches_jax(tree):
    _, files = _gate_images(tree)
    for fmt in ("BGR", "RGB", None):
        np.testing.assert_array_equal(read_image(files[0], fmt), jax_read_image(files[0], fmt))


def test_synthetic_module_matches_the_dev_script(tree, monkeypatch, tmp_path):
    """The same json text as the dev script's ``--num 8``, the same JPEG
    files where Pillow writes them, and its pixels before JPEG encoding
    (taken from the dev script's own save calls)."""
    coco, images = make_synthetic_coco(8, 0)
    with open(os.path.join(tree, "annotations", JSON_NAME)) as f:
        assert json.dumps(coco) == f.read()
    written = write_synthetic_coco(str(tmp_path), 8, 0)
    for rel in [os.path.join("annotations", JSON_NAME)] + [os.path.join("val2017", im["file_name"])
                                                            for im in coco["images"]]:
        with open(os.path.join(written, rel), "rb") as a, open(os.path.join(tree, rel), "rb") as b:
            assert a.read() == b.read(), rel

    sys.path.insert(0, os.path.join(ROOT, "dev"))
    try:
        import make_synthetic_coco as dev
    finally:
        sys.path.pop(0)
    saved = {}
    monkeypatch.setattr(Image.Image, "save", lambda self, fp, *a, **k: saved.__setitem__(os.path.basename(fp), np.asarray(self)))
    rng = np.random.default_rng(0)
    infos = dev.make_images(os.path.join(str(tree), "unused"), 8, rng)
    anns = dev.make_instances(infos, rng)
    by_image = {}
    for a in anns:
        by_image.setdefault(a["image_id"], []).append(a)
    dev.render_images(os.path.join(str(tree), "unused"), infos, by_image, rng)
    assert len(saved) == 8
    for info in infos:
        np.testing.assert_array_equal(images[info["id"]], saved[info["file_name"]])
    # and the JPEGs of the dev script's tree decode to the same sizes
    for info in coco["images"]:
        assert read_image(os.path.join(tree, "val2017", info["file_name"])).shape == images[info["id"]].shape


def test_synthetic_dataset_in_memory_feeds_the_loader():
    """A registered in-memory set: records carry their RGB pixels; the
    mapper takes them without decoding (BGR as INPUT.FORMAT says)."""
    name = "torch_test_synthetic_memory"
    coco = register_synthetic_coco(name, num=3, seed=0, image_hw=(60, 90))
    try:
        cfg = get_cfg()
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = 40, 100
        cfg.TPU.IMAGE_BUCKETS = [[40, 64]]
        cfg.DATASETS.TEST = (name,)
        batches = list(build_detection_test_loader(cfg, name))
        _, images = make_synthetic_coco(3, 0, (60, 90))
        assert len(batches) == 3 and MetadataCatalog.get(name).json_file is coco
        for i, b in enumerate(batches):
            assert b["image"].shape == (1, 40, 64, 3)
            np.testing.assert_array_equal(b["image_sizes"], [[40, 60]])
            np.testing.assert_array_equal(b["orig_sizes"], [[60, 90]])
            want = ResizeTransform(60, 90, 40, 60).apply_image(images[i][:, :, ::-1]).astype(np.float32)
            np.testing.assert_array_equal(b["image"][0, :, :60], want)
            assert not b["image"][0, :, 60:].any()
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)


def test_card_path_runs_without_pillow():
    """With Pillow blocked, the modules of the card's scoring path import
    and the mapper maps a synthetic scene; decoding a file says why not."""
    code = r"""
import sys
sys.modules["PIL"] = None
from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
from jtsm_tpu_torch.data import DatasetCatalog, DatasetMapper
from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco
from jtsm_tpu_torch.data.detection_utils import read_image
from jtsm_tpu_torch.engine import test
from jtsm_tpu_torch.evaluation import COCOEvaluator, COCOEval
from jtsm_tpu_torch.ops.paste_masks import paste_masks
register_synthetic_coco("nopil", num=1)
d = DatasetMapper(mask_rcnn_gate_cfg(), False)(DatasetCatalog.get("nopil")[0])
assert d["image"].dtype.name == "float32" and min(d["image"].shape[:2]) == 128, d["image"].shape
try:
    read_image("x.jpg")
except ImportError as e:
    assert "Pillow" in str(e)
else:
    raise AssertionError("read_image decoded without Pillow")
assert sys.modules["PIL"] is None and not any(m.startswith("jax") or m.startswith("jtsm_tpu.") for m in sys.modules)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stdout[-2000:] + proc.stderr[-3000:]
