"""The port's scoring output side held against the JAX package on the CPU:
the COCO RLE codec, the mask paste, the COCO result lists, the category
map, and COCOEval's 12 numbers for boxes and masks.

Tolerances: RLE strings, pasted masks and result lists equal; COCOEval's
numbers to 1e-12 (measured: equal), against the JAX package's native
(g++) path, with which its gate pins were measured, and its numpy path.
"""

import numpy as np
import pytest
import torch

from jtsm_tpu.data import rle as jax_rle
from jtsm_tpu.evaluation.coco_evaluation import _paste_mask_np
from jtsm_tpu.evaluation.coco_evaluation import batched_outputs_to_coco_json as jax_to_coco_json
from jtsm_tpu.evaluation.cocoeval import COCOEval as JaxCOCOEval
from jtsm_tpu_torch.data import rle
from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
from jtsm_tpu_torch.data.datasets.synthetic import make_synthetic_coco
from jtsm_tpu_torch.evaluation import COCOEval, batched_outputs_to_coco_json
from jtsm_tpu_torch.ops.paste_masks import paste_masks


def _edge_masks():
    rng = np.random.default_rng(0)
    one = np.zeros((7, 5), bool)
    one[3, 2] = True
    corner = np.zeros((6, 9), bool)
    corner[0, 0] = True
    last = np.zeros((6, 9), bool)
    last[-1, -1] = True
    return {
        "empty": np.zeros((6, 9), bool),
        "full": np.ones((6, 9), bool),
        "one_pixel": one,
        "first_pixel": corner,
        "last_pixel": last,
        "one_row": rng.uniform(size=(1, 37)) > 0.5,
        "one_column": rng.uniform(size=(41, 1)) > 0.5,
        "random_sparse": rng.uniform(size=(120, 170)) > 0.97,
        "random_dense": rng.uniform(size=(120, 170)) > 0.2,
        # long runs, so the compressed counts need several 5-bit groups
        "blocks": np.kron(rng.uniform(size=(6, 5)) > 0.5, np.ones((200, 300), bool)),
    }


EDGE_MASKS = _edge_masks()


@pytest.mark.parametrize("name", sorted(EDGE_MASKS))
def test_rle_codec_matches_jax(name):
    """Counts, compressed strings, decoding and areas, string for string."""
    m = EDGE_MASKS[name]
    h, w = m.shape
    want, got = jax_rle.rle_encode(m), rle.rle_encode(m)
    assert got == want
    ws, gs = jax_rle.rle_string_encode(m), rle.rle_string_encode(m)
    assert gs == ws
    np.testing.assert_array_equal(rle.rle_string_decode(gs["counts"], h, w), m)
    np.testing.assert_array_equal(rle.rle_decode_counts(got["counts"], h, w), m)
    np.testing.assert_array_equal(rle.decode_segmentation(gs, h, w), jax_rle.decode_segmentation(ws, h, w))
    assert rle.rle_area(gs) == jax_rle.rle_area(ws) == rle.rle_area(got) == int(m.sum())


def _paste_inputs(s, n, h, w, seed):
    rng = np.random.default_rng(seed)
    masks = rng.uniform(0, 1, (n, s, s)).astype(np.float32)
    masks[:4] = np.round(masks[:4] * 4) / 4  # values on the threshold
    masks[7:12] = 0.5  # the weights' rounding decides each pixel
    masks[12:14] = 0.5 + rng.normal(0, 1e-7, (2, s, s)).astype(np.float32)
    x0, y0 = rng.uniform(-0.4 * w, w, n), rng.uniform(-0.4 * h, h, n)  # some boxes leave the image
    bw, bh = rng.uniform(0, 0.8 * w, n), rng.uniform(0, 0.8 * h, n)
    bw[:3] = 0.0  # degenerate: zero width
    bh[3:5] = 1e-7  # below numpy's 1e-6 floor
    bw[5] = -3.0  # inverted
    boxes = np.stack([x0, y0, x0 + bw, y0 + bh], 1).astype(np.float32)
    boxes[6] = [0, 0, w, h]  # the whole image
    return masks, boxes


@pytest.mark.parametrize("s,h,w", [(28, 120, 170), (14, 120, 170), (28, 37, 300), (14, 301, 23)])
def test_paste_matches_numpy_paste_pixel_for_pixel(s, h, w):
    masks, boxes = _paste_inputs(s, 40, h, w, seed=s + h)
    want = np.stack([_paste_mask_np(masks[i], boxes[i], h, w) for i in range(len(masks))])
    got = paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), h, w)
    assert got.dtype == torch.bool and tuple(got.shape) == (40, h, w)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_paste_chunks_agree_with_one_pass(monkeypatch):
    """Chunking over detections changes nothing."""
    import jtsm_tpu_torch.ops.paste_masks as pm

    masks, boxes = _paste_inputs(28, 30, 64, 96, seed=3)
    whole = pm.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), 64, 96)
    monkeypatch.setattr(pm, "CHUNK_BYTES", 8 * 64 * 96 * 7)  # 7 detections a chunk
    np.testing.assert_array_equal(pm.paste_masks(torch.from_numpy(masks), torch.from_numpy(boxes), 64, 96), whole)


def _outputs(b, d, s, seed, sizes):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((b, d, 4), np.float32)
    for i, (h, w) in enumerate(sizes):
        xy = rng.uniform(0, 1, (d, 2)) * [w, h]
        wh = rng.uniform(0.02, 0.6, (d, 2)) * [w, h]
        boxes[i] = np.concatenate([xy, np.minimum(xy + wh, [w, h])], 1)
    return {
        "boxes": boxes,
        "scores": np.sort(rng.uniform(0.05, 1, (b, d)).astype(np.float32), axis=1)[:, ::-1].copy(),
        "classes": rng.integers(0, 80, (b, d)).astype(np.int32),
        "valid": rng.uniform(size=(b, d)) > 0.3,
        "masks": rng.uniform(0, 1, (b, d, s, s)).astype(np.float32),
    }


def test_category_map_goes_back_to_the_gapped_coco_ids():
    """Contiguous class k goes back to the k-th of the 80 COCO thing ids
    (1..90 with gaps), as the synthetic json names them."""
    coco, _ = make_synthetic_coco(8, 0)
    forward = _get_builtin_metadata("coco")["thing_dataset_id_to_contiguous_id"]
    ids = sorted(c["id"] for c in coco["categories"])
    assert len(ids) == 80 and ids[-1] == 90 and 12 not in ids
    assert forward == {cid: k for k, cid in enumerate(ids)}
    reverse = {v: k for k, v in forward.items()}
    assert [reverse[k] for k in (0, 10, 11, 79)] == [1, 11, 13, 90]
    used = {a["category_id"] for a in coco["annotations"]}
    assert any(c > 12 for c in used), used  # the json's own ids lie past a gap


@pytest.mark.parametrize("with_masks", [True, False])
def test_coco_result_lists_match_jax(with_masks):
    sizes = [(120, 170), (97, 64), (150, 150)]
    out = _outputs(3, 25, 28, seed=1, sizes=sizes)
    image_ids = np.array([4, 9, 2])
    orig = np.array(sizes, np.int32)
    reverse = {v: k for k, v in _get_builtin_metadata("coco")["thing_dataset_id_to_contiguous_id"].items()}
    want = jax_to_coco_json(out, image_ids, orig, reverse, with_masks=with_masks)
    got = batched_outputs_to_coco_json({k: torch.from_numpy(v) for k, v in out.items()}, image_ids, orig,
                                       reverse, with_masks=with_masks)
    assert got == want
    assert len(got) == int(out["valid"].sum())


def _detections(coco, seed, n_extra_image):
    """Seeded detections against the synthetic ground truth: jittered
    copies of every box (some with the wrong class), random boxes, equal
    scores, an image with 130 detections (past maxDets 100) and masks as
    RLE strings; ``n_extra_image`` is a ground-truth image with no
    annotation that gets detections too."""
    rng = np.random.default_rng(seed)
    sizes = {im["id"]: (im["height"], im["width"]) for im in coco["images"]}
    cats = [c["id"] for c in coco["categories"]]
    dets = []

    def add(img, cat, box, score):
        h, w = sizes[img]
        x, y, bw, bh = box
        m = np.zeros((h, w), bool)
        m[int(max(y, 0)): int(max(y + bh, 0)), int(max(x, 0)): int(max(x + bw, 0))] = True
        if rng.uniform() < 0.5:
            m &= rng.uniform(size=(h, w)) > 0.1
        dets.append({"image_id": img, "category_id": cat, "bbox": [float(v) for v in box],
                     "score": float(score), "segmentation": rle.rle_string_encode(m)})

    for a in coco["annotations"]:
        for _ in range(3):
            box = np.asarray(a["bbox"]) + rng.normal(0, 6, 4)
            cat = a["category_id"] if rng.uniform() < 0.8 else int(rng.choice(cats))
            add(a["image_id"], cat, box, rng.choice([0.3, 0.5, 0.9]))  # ties
    for img in sizes:
        h, w = sizes[img]
        for _ in range(130 if img == 0 else 12):
            xy = rng.uniform(0, 1, 2) * [w, h]
            add(img, int(rng.choice(cats[:6] + [a["category_id"] for a in coco["annotations"]])),
                [*xy, *(rng.uniform(0.02, 0.5, 2) * [w, h])], rng.uniform(0.05, 1))
    return dets


@pytest.fixture(scope="module")
def coco_and_detections():
    coco, _ = make_synthetic_coco(8, 0)
    coco = dict(coco, images=coco["images"] + [{"id": 8, "file_name": "x.jpg", "height": 200, "width": 300}])
    return coco, _detections(coco, seed=7, n_extra_image=8)


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("native", [True, False], ids=["jax_native", "jax_numpy"])
def test_cocoeval_stats_match_jax(coco_and_detections, iou_type, native):
    coco, dets = coco_and_detections
    want = JaxCOCOEval(coco, iou_type=iou_type, use_native=native).evaluate(dets)
    got = COCOEval(coco, iou_type=iou_type).evaluate(dets)
    _same_stats(got, want)
    assert 0.05 < got["AP"] < 0.95  # neither trivial nor perfect


def _same_stats(got, want):
    assert list(got) == list(want) and len(got) == 12
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= 1e-12, (k, got[k], want[k])


def test_cocoeval_perfect_and_empty_detections():
    coco, _ = make_synthetic_coco(8, 0)
    perfect = [{"image_id": a["image_id"], "category_id": a["category_id"], "bbox": a["bbox"], "score": 1.0}
               for a in coco["annotations"]]
    assert COCOEval(coco, "bbox").evaluate(perfect)["AP"] == JaxCOCOEval(coco, "bbox").evaluate(perfect)["AP"] == 1.0
    _same_stats(COCOEval(coco, "bbox").evaluate([]), JaxCOCOEval(coco, "bbox", use_native=False).evaluate([]))
