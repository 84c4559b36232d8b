"""The port's JTSM scoring slice on the CPU against the JAX package: the
WSL command ``python -m jtsm_tpu_torch.wsl.train_net --eval-only --device
cpu`` on the JTSM inference gate over the cocovar tree that
``dev/make_synthetic_coco.py`` writes, beside the JAX package's
``projects/WSL/tools/train_net.py --eval-only`` on the same tree; the
``WSL.TEST_NO_PASTE`` masks; the WSL test loader's batches; Pillow's
nearest resize written out; the sem-seg and panoptic evaluators; the
panoptic fusion; the in-memory cocovar set; and the card's path without
Pillow.

Tolerances: the printed numbers (12 bbox, 12 segm, 4 sem_seg, 9
panoptic_seg) and every per-class IoU within 1e-4 of JAX's, nan equal to
nan (measured: all equal); the COCO result lists as
``tests/test_torch_scoring.py`` holds them: boxes within 1e-3 px, scores
within 1e-4 (float32 on both sides, different summation orders), each
detection matched by image, class and box, since the gate's scores tie to
float noise and two such detections may trade slots; masks equal but for
pixels whose probability lies within float noise of 0.5 (measured 1 pixel
of 1200 masks, held at 3).
Everything else equal: integers, maps, segments, the evaluators' float64
numbers (the same numpy operations on the same integers).
"""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from jtsm_tpu.data.transforms import ResizeTransform as JaxResizeTransform
from jtsm_tpu.evaluation.panoptic_evaluation import PQStat as JaxPQStat
from jtsm_tpu.evaluation.panoptic_evaluation import pq_compute_single_image as jax_pq_single
from jtsm_tpu.modeling.meta_arch.panoptic_fpn import (
    combine_semantic_and_instance_outputs as jax_combine,
    panoptic_fusion_postprocess as jax_fusion,
)
from jtsm_tpu_torch.data.transforms import ResizeTransform, resize_nearest
from jtsm_tpu_torch.evaluation.panoptic_evaluation import pq_compute_single_image
from jtsm_tpu_torch.modeling.meta_arch.panoptic_fpn import (
    combine_semantic_and_instance_outputs,
    panoptic_fusion_postprocess,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_YAML = os.path.join(ROOT, "projects/WSL/configs/quick_schedules/jtsm_synthetic_inference_acc_test.yaml")
PINS = {("bbox", "AP"): 25.1932, ("segm", "AP"): 25.5954, ("sem_seg", "mIoU"): 7.9448,
        ("panoptic_seg", "PQ"): 3.4049}
COUNTS = {"bbox": 12, "segm": 12, "sem_seg": 4, "panoptic_seg": 9}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The dev script's tree, and one run of each command on it, the two at
    once."""
    tmp = tmp_path_factory.mktemp("jtsm_scoring")
    root = tmp / "datasets"
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8"], check=True, capture_output=True, cwd=ROOT)
    env = dict(os.environ, JTSM_DATASETS=str(root), PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
    commands = {
        "port": [sys.executable, "-m", "jtsm_tpu_torch.wsl.train_net", "--eval-only", "--device", "cpu",
                 "--config-file", GATE_YAML, "OUTPUT_DIR", str(tmp / "port")],
        "jax": [sys.executable, os.path.join(ROOT, "projects", "WSL", "tools", "train_net.py"), "--eval-only",
                "--config-file", GATE_YAML, "OUTPUT_DIR", str(tmp / "jax")],
    }
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, c in commands.items()}
    out = {"tree": os.path.join(str(root), "cocovar"), "root": str(root)}
    for k, p in procs.items():
        text = p.communicate(timeout=900)[0]
        inference = os.path.join(str(tmp / k), "inference")

        def read(name):
            path = os.path.join(inference, name)
            return json.load(open(path)) if os.path.exists(path) else None

        out[k] = {"rc": p.returncode, "log": text, "results": read("coco_instances_results.json"),
                  "sem_seg": read("sem_seg_evaluation.json")}
    return out


def _copypaste(log):
    """{task: {metric: value}} from the ``copypaste:`` lines."""
    lines = [ln.split("copypaste: ", 1)[1] for ln in log.splitlines() if "copypaste: " in ln]
    tasks = {}
    for i, ln in enumerate(lines):
        m = re.match(r"Task: (\w+)", ln)
        if m:
            tasks[m.group(1)] = dict(zip(lines[i + 1].split(","), map(float, lines[i + 2].split(","))))
    return tasks


def _assert_close_nan(got, want, tol):
    assert got.keys() == want.keys()
    for k in want:
        g, w = float(got[k]), float(want[k])
        assert (np.isnan(g) and np.isnan(w)) or abs(g - w) <= tol, (k, g, w)


def _assert_same_results(got, want):
    """The same detections: each of ``got`` pairs with one of ``want`` of
    its image, class and box (within 1e-3 px) and score within 1e-4; a pair
    may sit in other slots of the lists only where ``want``'s scores in the
    two slots lie within 1e-4 (the gate's WSDDN-scale scores tie to float
    noise, which orders them). Masks: equal, but for a pixel whose pasted
    probability lies within float noise of 0.5 (measured: one pixel of one
    of the 1200 masks), each mask's IoU at least 0.999, 3 such pixels in
    all."""
    from jtsm_tpu_torch.data.rle import decode_segmentation

    assert got is not None and want is not None
    assert len(got) == len(want) > 50
    free = list(range(len(want)))
    pixels = 0
    for i, g in enumerate(got):
        for n, j in enumerate(free):
            w = want[j]
            if ((g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
                    and np.abs(np.subtract(g["bbox"], w["bbox"])).max() <= 1e-3 and abs(g["score"] - w["score"]) <= 1e-4):
                assert abs(want[i]["score"] - w["score"]) <= 1e-4, (i, j)
                if g["segmentation"] != w["segmentation"]:
                    gm, wm = (decode_segmentation(r["segmentation"], 0, 0) for r in (g, w))
                    assert (gm & wm).sum() >= 0.999 * (gm | wm).sum(), (i, j)
                    pixels += int((gm != wm).sum())
                free.pop(n)
                break
        else:
            raise AssertionError(f"detection {i} {g['image_id'], g['category_id'], g['score']} has no match")
    assert pixels <= 3, pixels


# (a) the gate through both commands


def test_port_cli_scores_the_jtsm_gate_pins(runs):
    port = runs["port"]
    assert port["rc"] == 0, port["log"][-4000:]
    assert "Results verification passed." in port["log"]
    stats = _copypaste(port["log"])
    assert {t: len(v) for t, v in stats.items()} == COUNTS
    for (task, metric), pin in PINS.items():
        assert abs(stats[task][metric] - pin) <= 0.02, (task, metric, stats[task][metric])


def test_port_cli_numbers_equal_the_jax_cli(runs):
    """All 37 printed numbers and each class's IoU (the evaluators' json)."""
    port, jax = runs["port"], runs["jax"]
    want, got = _copypaste(jax["log"]), _copypaste(port["log"])
    assert {t: len(v) for t, v in want.items()} == COUNTS, jax["log"][-4000:]
    for task in COUNTS:
        _assert_close_nan(got[task], want[task], 1e-4)
    assert len(port["sem_seg"]) == 4 + 54
    _assert_close_nan(port["sem_seg"], jax["sem_seg"], 1e-4)


def test_port_cli_result_list_matches_the_jax_cli(runs):
    _assert_same_results(runs["port"]["results"], runs["jax"]["results"])


def test_no_paste_coco_path_and_fusion_equal_jax():
    """(f) The gate under WSL.TEST_NO_PASTE on four in-memory cocovar
    scenes: its ``masks_full`` outputs through the port's COCO result list
    and panoptic fusion, and through the JAX package's on the same arrays,
    give the same segmentations, id maps and segments."""
    from jtsm_tpu.evaluation.coco_evaluation import batched_outputs_to_coco_json as jax_to_json
    from jtsm_tpu_torch.config import jtsm_gate_cfg
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_cocovar
    from jtsm_tpu_torch.evaluation import batched_outputs_to_coco_json
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.tools.train_net import load_weights
    from jtsm_tpu_torch.wsl.data import build_wsl_test_loader

    name = "torch_test_jtsm_no_paste"
    cfg = jtsm_gate_cfg()
    cfg.WSL.TEST_NO_PASTE = True
    cfg.DATASETS.TEST = (name,)
    cfg.DATASETS.PROPOSAL_FILES_TEST = (register_synthetic_cocovar(name, num=4),)
    try:
        model = build_model(cfg, device="cpu")
        load_weights(model, os.path.join(ROOT, cfg.MODEL.WEIGHTS))
        rev = {v: k for k, v in MetadataCatalog.get(name).thing_dataset_id_to_contiguous_id.items()}
        combine = cfg.MODEL.PANOPTIC_FPN.COMBINE
        flat = 0
        for batch in build_wsl_test_loader(cfg, name, batch_size=2):
            out = model.inference({k: v for k, v in batch.items() if k != "image_ids"})
            assert "masks" not in out and bool(out["no_paste"].any())
            arrays = {k: v.numpy() for k, v in out.items()}
            sizes = (batch["image_ids"], batch["orig_sizes"])
            got = batched_outputs_to_coco_json(out, *sizes, rev, True, image_sizes=batch["image_sizes"])
            want = jax_to_json(arrays, *sizes, rev, with_masks=True, image_sizes=batch["image_sizes"])
            assert got == want and len(got) > 50
            flat += len(got)
            args = (batch["image_sizes"], batch["orig_sizes"], combine.OVERLAP_THRESH, combine.STUFF_AREA_LIMIT,
                    combine.INSTANCES_CONFIDENCE_THRESH)
            fused, jfused = panoptic_fusion_postprocess(out, *args), jax_fusion(arrays, *args)
            for (gm, gs), (wm, ws) in zip(fused["panoptic_seg"], jfused["panoptic_seg"]):
                np.testing.assert_array_equal(gm, wm)
                assert gs == ws and any(s["isthing"] for s in gs)
        assert flat >= 200
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)


# (b) the WSL test loader


@pytest.mark.parametrize("batch_size", [1, 5])
def test_wsl_test_loader_batches_equal_jax(runs, batch_size):
    """At batch 1 (the gate's) and 5 (12 images: a padded final batch of
    2), key for key and equal; the cocovar tree registered under a name of
    this test in both packages."""
    from jtsm_tpu.config import get_cfg as jax_get_cfg
    from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
    from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
    from jtsm_tpu.data.build import build_detection_test_loader as jax_test_loader
    from jtsm_tpu.data.datasets.builtin import register_coco_panoptic_separated as jax_register
    from jtsm_tpu.data.datasets.builtin_meta import _get_builtin_metadata as jax_meta
    from jtsm_tpu.wsl import add_wsl_config
    from jtsm_tpu.wsl.data import WSLDatasetMapper as JaxMapper
    from jtsm_tpu.wsl.data import WSLStaticBatchLoader as JaxLoader
    from jtsm_tpu.wsl.data import load_mcg_proposals_into_dataset as jax_proposal_loader
    from jtsm_tpu_torch.config import wsl_cfg
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.builtin import register_coco_panoptic_separated
    from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
    from jtsm_tpu_torch.wsl.data import build_wsl_test_loader

    tree, prefix = runs["tree"], f"torch_test_cocovar_{batch_size}"
    paths = [os.path.join(tree, p) for p in ("val2017", "panoptic_val2017_100", "annotations/panoptic_val2017_100.json",
                                             "panoptic_stuff_val2017_100", "annotations/instances_val2017_100.json")]
    jax_register(prefix, jax_meta("coco_panoptic_separated"), *paths)
    register_coco_panoptic_separated(prefix, _get_builtin_metadata("coco_panoptic_separated"), *paths)
    name = prefix + "_separated"
    try:
        jcfg = jax_get_cfg()
        add_wsl_config(jcfg)
        jcfg.merge_from_file(GATE_YAML)
        cfg = wsl_cfg()
        cfg.merge_from_file(GATE_YAML)
        for c in (jcfg, cfg):
            c.DATASETS.TEST = (name,)
            c.DATASETS.PROPOSAL_FILES_TEST = (os.path.join(tree, "proposals_val2017_100.pkl"),)
        want = list(JaxLoader(jax_test_loader(jcfg, name, JaxMapper(jcfg, False), batch_size=batch_size,
                                              proposal_loader=jax_proposal_loader), jcfg.WSL.MAX_SUPERPIXELS))
        got = list(build_wsl_test_loader(cfg, name, batch_size=batch_size))
    finally:
        for catalog in (JaxDatasetCatalog, DatasetCatalog, JaxMetadataCatalog, MetadataCatalog):
            for n in (name, prefix + "_stuffonly"):
                catalog.remove(n)
    assert len(got) == len(want) == -(-12 // batch_size)
    for g, w in zip(got, want):
        assert set(g) == set(w) >= {"proposals", "proposal_scores", "superpixels", "oh_labels", "gt_sem_seg"}
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    assert len(got[-1]["image_ids"]) == (2 if batch_size == 5 else 1)


# (c) Pillow's nearest resize


def _pillow_nearest(img, h, w):
    mode = None if img.dtype == np.uint8 else "F"
    return np.asarray(Image.fromarray(img, mode=mode).resize((w, h), Image.NEAREST))


def test_nearest_resize_equals_pillow_over_a_sweep():
    """L (uint8) and F (float32) modes, every pair of sizes 1..48 along one
    axis, 400 seeded pairs up to 1400, and the flagship's 375x500 ->
    688x917 on both axes at once."""
    rng = np.random.default_rng(0)
    pairs = [(i, o) for i in range(1, 49) for o in range(1, 49)]
    pairs += [tuple(int(v) for v in rng.integers(1, 1400, 2)) for _ in range(400)]
    for i, o in pairs:
        row = rng.integers(0, 256, (2, i)).astype(np.uint8)
        np.testing.assert_array_equal(resize_nearest(row, 2, o), _pillow_nearest(row, 2, o), err_msg=str((i, o)))
        col = rng.integers(0, 5000, (i, 2)).astype(np.float32)
        np.testing.assert_array_equal(resize_nearest(col, o, 2), _pillow_nearest(col, o, 2), err_msg=str((i, o)))
    sp = rng.integers(0, 1000, (375, 500)).astype(np.float32)
    np.testing.assert_array_equal(resize_nearest(sp, 688, 917), _pillow_nearest(sp, 688, 917))


def test_segmentation_transform_equals_jax_on_the_gate_scenes():
    """The superpixel ids (int32, through F mode) and the stuff maps (uint8)
    of the 12 cocovar scenes to their 128-176 test sizes, as the JAX
    package's ResizeTransform gives them, dtype included."""
    from jtsm_tpu_torch.data.datasets.synthetic import make_synthetic_cocovar
    from jtsm_tpu_torch.data.transforms import ResizeShortestEdge

    coco, _, sem_maps, _, _, proposals = make_synthetic_cocovar()
    for info, sp in zip(coco["images"], proposals["superpixels"]):
        h, w = info["height"], info["width"]
        nh, nw = ResizeShortestEdge.get_output_shape(h, w, 128, 176)
        for seg in (sp, sem_maps[info["id"]]):
            got = ResizeTransform(h, w, nh, nw).apply_segmentation(seg)
            want = JaxResizeTransform(h, w, nh, nw).apply_segmentation(seg)
            assert got.dtype == want.dtype and got.shape == (nh, nw)
            np.testing.assert_array_equal(got, want)


# (d) the evaluators


def _seeded_panoptic(seed, h=48, w=64):
    """A ground truth and a prediction: ground-truth segments of classes 1-3
    and a crowd segment of class 2, void (id 0) in one corner; a prediction
    with segments that match, one of class 4 only predicted, one mostly on
    void, one on the crowd region, and the gt-only class 3 unmatched."""
    rng = np.random.default_rng(seed)
    gt = np.zeros((h, w), np.int64)
    gt[:, : w // 2] = 1
    gt[:, w // 2:] = 2
    gt[: h // 3, : w // 3] = 3  # crowd
    gt[h // 2:, w // 2: 3 * w // 4] = 4
    gt[-6:, -6:] = 5
    gt[:4, -8:] = 0  # void
    gt_segments = [{"id": 1, "category_id": 1}, {"id": 2, "category_id": 2}, {"id": 3, "category_id": 2, "iscrowd": 1},
                   {"id": 4, "category_id": 1}, {"id": 5, "category_id": 3}]
    pred = gt.copy()
    pred[rng.random((h, w)) < 0.08] = 6
    pred[pred == 5] = 1
    pred[: h // 3, : w // 3] = 7  # on the crowd region
    pred[:4, -8:] = 8  # on void
    pred[h - 10: h - 6, :10] = 9
    pred_segments = [{"id": 1, "category_id": 1}, {"id": 2, "category_id": 2}, {"id": 4, "category_id": 1},
                     {"id": 6, "category_id": 4}, {"id": 7, "category_id": 2}, {"id": 8, "category_id": 3},
                     {"id": 9, "category_id": 4}]
    return gt, pred, gt_segments, pred_segments


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pq_single_image_equals_jax(seed):
    args = _seeded_panoptic(seed)
    got, want = pq_compute_single_image(*args), jax_pq_single(*args)
    assert dict(got.per_cat) == dict(want.per_cat)
    assert set(want.per_cat) == {1, 2, 3, 4}  # gt-only 3 and prediction-only 4 included
    cats = {c: {"isthing": int(c != 2)} for c in (1, 2, 3, 4)}
    jtotal, total = JaxPQStat(), type(got)()
    jtotal += want
    total += got
    for isthing in (None, True, False):
        assert total.pq_average(cats, isthing) == jtotal.pq_average(cats, isthing)


def test_sem_seg_and_panoptic_evaluators_equal_jax(tmp_path):
    """Both evaluators on a dataset of three images, PNG ground truth (the
    files the JAX package reads), seeded predictions, each class kind."""
    from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
    from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
    from jtsm_tpu.evaluation import COCOPanopticEvaluator as JaxPanoptic
    from jtsm_tpu.evaluation import SemSegEvaluator as JaxSemSeg
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.evaluation import COCOPanopticEvaluator, SemSegEvaluator

    rng = np.random.default_rng(5)
    records, anns, preds = [], [], []
    stuff_classes = ["things", "a", "b", "c", "d"]
    for i in range(3):
        gt, pred, gt_segments, pred_segments = _seeded_panoptic(i)
        sem = np.where(gt == 1, 1, np.where(gt == 2, 2, 0)).astype(np.uint8)
        sem[:4, -8:] = 255  # ignored
        Image.fromarray(sem).save(tmp_path / f"sem{i}.png")
        ids = gt.astype(np.uint32)
        Image.fromarray(np.stack([ids % 256, ids // 256 % 256, ids // 65536], -1).astype(np.uint8)).save(
            tmp_path / f"pan{i}.png")
        records.append({"file_name": f"{i}.jpg", "image_id": i, "sem_seg_file_name": str(tmp_path / f"sem{i}.png")})
        anns.append({"image_id": i, "file_name": f"pan{i}.png", "segments_info": gt_segments})
        sem_pred = rng.integers(0, 5, sem.shape)
        sem_pred[sem_pred == 2] = 3  # class 2 only in the ground truth, 3 and 4 only predicted
        converted = [dict(s, isthing=True, category_id=s["category_id"] - 1) for s in pred_segments]
        preds.append((sem_pred, (pred, converted)))
    pan_json = tmp_path / "pan.json"
    json.dump({"annotations": anns, "categories": [{"id": c, "isthing": int(c != 2)} for c in (1, 2, 3, 4)]},
              open(pan_json, "w"))
    meta = dict(stuff_classes=stuff_classes, ignore_label=255, panoptic_json=str(pan_json),
                panoptic_root=str(tmp_path), thing_dataset_id_to_contiguous_id={c: c - 1 for c in (1, 2, 3, 4)},
                stuff_dataset_id_to_contiguous_id={})
    name = "torch_test_jtsm_evaluators"
    results = []
    for dc, mc, sem_cls, pan_cls in ((JaxDatasetCatalog, JaxMetadataCatalog, JaxSemSeg, JaxPanoptic),
                                     (DatasetCatalog, MetadataCatalog, SemSegEvaluator, COCOPanopticEvaluator)):
        dc.register(name, lambda: [dict(r) for r in records])
        mc.get(name).set(**meta)
        try:
            out = {}
            for ev in (sem_cls(name), pan_cls(name)):
                ev.reset()
                for i, (sem_pred, pan) in enumerate(preds):
                    ev.process({"image_ids": np.array([i])}, {"sem_seg": [sem_pred], "panoptic_seg": [pan]})
                out.update(ev.evaluate())
            results.append(out)
        finally:
            dc.remove(name)
            mc.remove(name)
    want, got = results
    for task in ("sem_seg", "panoptic_seg"):
        _assert_close_nan(got[task], want[task], 0.0)
    assert got["sem_seg"]["IoU-b"] == 0 and np.isnan(got["sem_seg"]["IoU-d"]) and got["panoptic_seg"]["PQ"] > 0


# (e) the panoptic fusion


def _fusion_case(seed, d=12, h=40, w=56, no_paste=False):
    rng = np.random.default_rng(seed)
    scores = rng.choice(np.float32([0.9, 0.6, 0.6, 0.5, 0.5, 0.3, 0.002, 0.0019999]), d).astype(np.float32)
    scores[:4] = scores[0]  # a run of ties
    x0, y0 = rng.uniform(-5, w * 0.6, d), rng.uniform(-5, h * 0.6, d)
    boxes = np.stack([x0, y0, x0 + rng.uniform(2, w / 2, d), y0 + rng.uniform(2, h / 2, d)], 1).astype(np.float32)
    boxes[5] = boxes[4] + 1.0  # overlapping
    out = {
        "boxes": boxes[None], "scores": scores[None], "classes": rng.integers(0, 5, (1, d)).astype(np.int32),
        "valid": (rng.random((1, d)) < 0.9), "masks": rng.random((1, d, 28, 28)).astype(np.float32),
        "sem_seg_logits": rng.normal(0, 1, (1, h + 8, w + 8, 4)).astype(np.float32),
    }
    out["sem_seg_logits"][0, :, :, 3] += 2.5  # one large stuff class, the others under the area limit
    if no_paste:
        out["masks_full"] = rng.random((1, d, h + 8, w + 8)) < 0.3
        out["no_paste"] = out["valid"].copy()
        del out["masks"]
    sizes = (np.array([[h, w]]), np.array([[2 * h - 3, 2 * w + 5]]))
    return out, sizes


@pytest.mark.parametrize("case", ["paste", "no_paste", "boxes"])
@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("threshold", [0.002, 0.5])
def test_panoptic_fusion_equals_jax(case, seed, threshold):
    """Tied scores, scores at and just under the threshold, overlapping
    masks, stuff under STUFF_AREA_LIMIT; the paste, the no_paste masks and
    the box-as-mask branch. The outputs go in as tensors (the port) and as
    arrays (JAX)."""
    out, (image_sizes, orig_sizes) = _fusion_case(seed, no_paste=case == "no_paste")
    if case == "boxes":
        del out["masks"]
    args = (image_sizes, orig_sizes, 0.5, 600, threshold)
    want = jax_fusion(out, *args)
    got = panoptic_fusion_postprocess({k: torch.as_tensor(v) for k, v in out.items()}, *args)
    for (gm, gs), (wm, ws) in zip(got["panoptic_seg"], want["panoptic_seg"]):
        np.testing.assert_array_equal(gm, wm)
        assert gs == ws
    assert len(got["panoptic_seg"][0][1]) >= 2
    for g, w in zip(got["sem_seg"], want["sem_seg"]):
        np.testing.assert_array_equal(g, w)


def test_combine_keeps_the_jax_order_among_tied_scores():
    """Eight equal scores on nested masks: the painting order (and so every
    segment's id, instance and area) is JAX's."""
    rng = np.random.default_rng(3)
    d, h, w = 20, 30, 30
    masks = np.zeros((d, h, w), bool)
    for j in range(d):
        y, x = rng.integers(0, 20, 2)
        masks[j, y: y + 10, x: x + 10] = True
    scores = np.full(d, 0.25, np.float32)
    scores[::3] = 0.5
    classes = rng.integers(0, 3, d)
    valid = np.ones(d, bool)
    sem = rng.integers(0, 3, (h, w))
    got = combine_semantic_and_instance_outputs(masks, scores, classes, valid, sem, 0.5, 10, 0.25)
    want = jax_combine(masks, scores, classes, valid, sem, 0.5, 10, 0.25)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and len(got[1]) > 5


# (g) the in-memory cocovar set against the dev script's files


def test_in_memory_cocovar_equals_the_dev_script(runs, monkeypatch):
    """The jsons' text, the stuff and panoptic PNGs as Pillow decodes them,
    the proposal pickle's arrays, and the pixels before JPEG (taken from
    the dev script's own save calls)."""
    from jtsm_tpu_torch.data.datasets.synthetic import make_synthetic_cocovar

    tree = runs["tree"]
    coco, images, sem_maps, pan_maps, pan_json, proposals = make_synthetic_cocovar()
    for name, d in (("instances_val2017_100.json", coco), ("panoptic_val2017_100.json", pan_json)):
        with open(os.path.join(tree, "annotations", name)) as f:
            assert json.dumps(d) == f.read(), name
    for info in coco["images"]:
        png = info["file_name"].replace(".jpg", ".png")
        stuff = np.asarray(Image.open(os.path.join(tree, "panoptic_stuff_val2017_100", png)))
        np.testing.assert_array_equal(stuff, sem_maps[info["id"]])
        rgb = np.asarray(Image.open(os.path.join(tree, "panoptic_val2017_100", png))).astype(np.uint32)
        np.testing.assert_array_equal(rgb[..., 0] + 256 * rgb[..., 1] + 65536 * rgb[..., 2], pan_maps[info["id"]])
    with open(os.path.join(tree, "proposals_val2017_100.pkl"), "rb") as f:
        want = pickle.load(f)
    assert want.keys() == proposals.keys() and want["ids"] == proposals["ids"]
    for k in ("boxes", "objectness_logits", "superpixels", "oh_labels"):
        for a, b in zip(proposals[k], want[k]):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    sys.path.insert(0, os.path.join(ROOT, "dev"))
    try:
        import make_synthetic_coco as dev
    finally:
        sys.path.pop(0)
    saved = {}
    monkeypatch.setattr(Image.Image, "save",
                        lambda self, fp, *a, **k: saved.__setitem__(os.path.basename(fp), np.asarray(self)))
    rng = np.random.default_rng(7)
    unused = os.path.join(runs["root"], "unused")
    infos = dev.make_images(unused, 12, rng)
    by_image = {}
    for a in dev.make_instances(infos, rng):
        by_image.setdefault(a["image_id"], []).append(a)
    dev.render_images(unused, infos, by_image, rng, varied=True)
    assert len(saved) == 12
    for info in infos:
        np.testing.assert_array_equal(images[info["id"]], saved[info["file_name"]])


# (h) the card's path without Pillow


def test_jtsm_scoring_runs_without_pillow():
    """With Pillow blocked: the scoring modules import, two in-memory
    cocovar scenes score through the gate checkpoint, and a record naming
    a PNG (sem-seg or panoptic ground truth) raises and says why."""
    code = r"""
import sys
sys.modules["PIL"] = None
import numpy as np
from jtsm_tpu_torch.config import jtsm_gate_cfg
from jtsm_tpu_torch.data import DatasetCatalog
from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_cocovar
from jtsm_tpu_torch.engine import test
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.tools.train_net import load_weights
from jtsm_tpu_torch.wsl import train_net as W
from jtsm_tpu_torch.wsl.data import WSLDatasetMapper
cfg = jtsm_gate_cfg()
cfg.DATASETS.TEST = ("nopil",)
cfg.DATASETS.PROPOSAL_FILES_TEST = (register_synthetic_cocovar("nopil", num=2),)
cfg.OUTPUT_DIR = sys.argv[1]
model = build_model(cfg, device="cpu")
load_weights(model, cfg.MODEL.WEIGHTS)
res = test(cfg, model, build_test_loader=W.build_test_loader, build_evaluator=W.build_evaluator)
assert set(res) == {"bbox", "segm", "sem_seg", "panoptic_seg"}, res.keys()
assert all(np.isfinite(res[t][k]) for t, k in (("bbox", "AP"), ("sem_seg", "mIoU"), ("panoptic_seg", "PQ")))
record = dict(DatasetCatalog.get("nopil")[0])
del record["sem_seg"]
record["sem_seg_file_name"] = "missing.png"
try:
    WSLDatasetMapper(cfg, False)(record)
except ImportError as e:
    assert "Pillow" in str(e), e
else:
    raise AssertionError("a sem-seg PNG was read without Pillow")
from jtsm_tpu_torch.evaluation import COCOPanopticEvaluator
ev = COCOPanopticEvaluator("nopil")
try:
    ev._gt_map({"image_id": -1, "file_name": "x.png"})
except ImportError as e:
    assert "Pillow" in str(e), e
else:
    raise AssertionError("a panoptic PNG was read without Pillow")
assert sys.modules["PIL"] is None and not any(m.startswith("jax") or m.startswith("jtsm_tpu.") for m in sys.modules)
print("ok")
"""
    import tempfile

    with tempfile.TemporaryDirectory() as out:
        proc = subprocess.run([sys.executable, "-c", code, out], cwd=ROOT, capture_output=True, text=True,
                              timeout=600, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0 and proc.stdout.strip().endswith("ok"), proc.stdout[-2000:] + proc.stderr[-3000:]
