"""The ops of the WSOD zoo's heads held against the JAX package on the CPU:
``wsl.ops.roi_loop_pool`` (ContextLocNet), ``wsl.ops.roi_label``,
``roi_merge_lambda``, ``roi_merge_ids`` with ``roi_merge`` (CMIL), and the
guided attention module ``GAMLayer`` with ``gam_image_loss``, from seeded
numpy inputs (float32 on both sides).

Tolerances (measured on the CPU in brackets):

* ``roi_loop_pool``: values equal (the same maxima); the gradient within
  1e-6 of its largest magnitude (2.9e-7: a pixel's gradient sums over the
  bins that pick it in another order); on the tie cases, where every
  gradient is a sum of a few dyadic fractions, equal;
* ``roi_label``: every field equal; the weights' gradient in the class
  weights equal;
* ``roi_merge``: the ids, counts and cluster rows' validity equal; the
  merged rows and their gradient in the members within 1e-6 of the largest
  (0: sums of a few terms in the same order);
* ``roi_merge_lambda``: within 1e-6 relative (float32 logarithms);
* ``GAMLayer``: the attended map, the logits, the loss and the gradients
  within 1e-5 relative to each one's largest magnitude.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.structures.boxes import pairwise_iou as jax_pairwise_iou
from jtsm_tpu.wsl import ops as jax_ops
from jtsm_tpu.wsl.modeling import mil_heads as jax_mil
from jtsm_tpu.wsl.modeling import wsod_zoo as jax_zoo
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.wsl import ops
from jtsm_tpu_torch.wsl.modeling.mil_heads import GAMLayer, gam_image_loss
from jtsm_tpu_torch.wsl.modeling.wsod_zoo import roi_merge, roi_merge_ids, roi_merge_lambda
from tests.test_torch_meta_archs import _random_variables


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    assert want.shape == got.shape, (want.shape, got.shape)
    return float(np.abs(want - got).max(initial=0.0) / max(np.abs(want).max(initial=0.0), 1e-30))


# -- roi_loop_pool ------------------------------------------------------------


def _loop_boxes(kind, rng, h, w, scale, r=40):
    """Image-coordinate boxes on an (h, w) map at ``scale``: inside it;
    touching and crossing its edges; or zero-size, half-pixel (C round's
    .5 cases) and far outside, so that the inner and outer boxes clamp."""
    img_w, img_h = w / scale, h / scale
    if kind == "inside":
        xy = rng.rand(r, 2) * [img_w * 0.6, img_h * 0.6]
        return np.concatenate([xy, xy + 8 + rng.rand(r, 2) * [img_w * 0.35, img_h * 0.35]], 1)
    if kind == "edges":
        xy = rng.rand(r, 2) * [img_w, img_h] - [img_w * 0.3, img_h * 0.3]
        b = np.concatenate([xy, xy + rng.rand(r, 2) * [img_w, img_h]], 1)
        b[: r // 4, 0] = 0.0  # touching the left edge
        b[r // 4: r // 2, 3] = img_h  # touching the bottom
        b[r // 2: r // 2 + 4] = [-5.0, -5.0, img_w + 5.0, img_h + 5.0]  # crossing all four
        return b
    xy = rng.rand(r, 2) * [img_w, img_h]
    b = np.concatenate([xy, xy + rng.rand(r, 2) * 12], 1)
    b[: r // 4, 2:] = b[: r // 4, :2]  # zero-size
    b[r // 4: r // 2] = np.round(b[r // 4: r // 2] * scale * 2) / (scale * 2) + 1.0 / (4 * scale)  # the .5s
    b[r // 2: r // 2 + 6] = [[-40.0, -40.0, 2.0 * img_w, 2.0 * img_h]] * 6  # inner and outer clamp
    return b


def _loop_case(kind, fmap, seed=0, scale=1.0 / 8, shape=(2, 11, 15, 6)):
    rng = np.random.RandomState(seed)
    bimg, h, w, c = shape
    if fmap == "relu":
        f = np.maximum(rng.randn(*shape), 0.0)
        f[:, 2:5] = 0.0  # rows of exact zeros: ties inside the max and at the floor
    else:
        f = np.zeros(shape)
    boxes = _loop_boxes(kind, rng, h, w, scale).astype(np.float32)
    bidx = rng.randint(0, bimg, boxes.shape[0]).astype(np.int32)
    cot = rng.randn(3 * boxes.shape[0], 7, 7, c).astype(np.float32)
    return f.astype(np.float32), boxes, bidx, cot, scale


@functools.partial(jax.jit, static_argnums=4)
def _jax_loop_grad(feat, boxes, bidx, cot, scale):
    def loss(f):
        out = jax_ops.roi_loop_pool(f, boxes, bidx, scale, output_size=7)
        return (out * cot).sum(), out

    return jax.value_and_grad(loss, has_aux=True)(feat)


def _jax_loop(f, boxes, bidx, cot, scale):
    """One compilation for every case of a shape."""
    (_, out), grad = _jax_loop_grad(*(jnp.asarray(a) for a in (f, boxes, bidx, cot)), scale)
    return np.asarray(out), np.asarray(grad)


def _port_loop(f, boxes, bidx, cot, scale):
    ft = torch.tensor(f, requires_grad=True)
    out = ops.roi_loop_pool(ft, torch.tensor(boxes), torch.tensor(bidx), scale, 7)
    (out * torch.tensor(cot)).sum().backward()
    return out.detach().numpy(), ft.grad.numpy()


@pytest.mark.parametrize("fmap", ["relu", "zeros"])
@pytest.mark.parametrize("kind", ["inside", "edges", "degenerate"])
def test_roi_loop_pool_matches_jax(kind, fmap, monkeypatch):
    """Values equal and the gradient as ``jax.grad``'s, on a ReLU map with
    rows of exact zeros and on a map of zeros, for boxes inside the map,
    at and across its edges, and degenerate; the same with every ROI a
    chunk of its own (the chunking changes nothing)."""
    case = _loop_case(kind, fmap)
    want, want_grad = _jax_loop(*case)
    for chunk in (ops._LOOP_CHUNK_ELEMENTS, 1):
        monkeypatch.setattr(ops, "_LOOP_CHUNK_ELEMENTS", chunk)
        got, grad = _port_loop(*case)
        np.testing.assert_array_equal(got, want)
        err = _rel(want_grad, grad)
        print(kind, fmap, chunk, "gradient", err)
        assert err <= 1e-6
    assert (want == 0).any() and np.abs(want_grad).max() > 0
    if kind == "degenerate":
        assert (want.reshape(3, -1, 7, 7, want.shape[-1]) == 0).all(axis=(2, 3, 4)).any()  # empty regions pool 0


def test_roi_loop_pool_splits_ties_in_two_stages():
    """One ROI over a one-channel map of a few pixels, so that its bins'
    windows hold ties: JAX reduces each window's rows for each column, then
    the columns, then the floor at 0, and splits a tie's gradient evenly
    at each stage. Two columns where one holds two tied rows and the other
    one give 1/4, 1/4 and 1/2; a flat maximum over the window (1/3 each) or
    columns first (1/2 to the lone pixel's row mate) would not; a window of
    zeros gives half of its gradient to the floor. Gradients equal."""
    f, _, _, _, scale = _loop_case("inside", "zeros")  # the shapes of the cases above: one compilation
    f[0, 0, 0, 0] = f[0, 1, 0, 0] = f[0, 0, 1, 0] = 1.0  # column 0: two rows; column 1: one
    f[0, 1, 1, 0] = 0.5
    r = 40
    boxes = np.tile(np.array([[0.0, 0.0, 1.0, 1.0]], np.float32) / scale, (r, 1))  # map pixels [0, 1]
    boxes[0] = np.array([0.0, 0.0, 3.0, 3.0], np.float32) / scale
    bidx = np.zeros(r, np.int32)
    cot = np.round(np.random.RandomState(0).rand(3 * r, 7, 7, f.shape[-1]) * 8).astype(np.float32)
    want, want_grad = _jax_loop(f, boxes, bidx, cot, scale)
    got, grad = _port_loop(f, boxes, bidx, cot, scale)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(grad, want_grad)

    # the second ROI's roi block, bin (3, 3): its window is [0, 2) x [0, 2)
    one = np.zeros_like(cot)
    one[1, 3, 3, 0] = 1.0
    _, g = _port_loop(f, boxes, bidx, one, scale)
    np.testing.assert_array_equal(g[0, :2, :2, 0], [[0.25, 0.5], [0.25, 0.0]])
    _, g = _port_loop(np.zeros_like(f), boxes, bidx, one, scale)
    np.testing.assert_array_equal(g[0, :2, :2, 0], [[0.125, 0.125], [0.125, 0.125]])


# -- roi_label ----------------------------------------------------------------


def _label_inputs(seed, r=30, c=5):
    """Boxes with duplicates, tied scores, an absent class, and padded rows
    (-inf) in the second image."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 50, (2, r, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.randint(6, 30, (2, r, 2))], -1).astype(np.float32)
    boxes[:, 4] = boxes[:, 1]
    boxes[:, 9] = boxes[:, 1]
    scores = np.round(rng.rand(2, r, c), 1).astype(np.float32)
    scores[1, -5:] = -np.inf
    labels = np.array([[1, 0, 1, 1, 0], [0, 1, 1, 0, 1]], np.float32)
    weights = rng.rand(2, c).astype(np.float32)
    return boxes, scores, labels, weights


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("args", [dict(fg_threshold=0.6, bg_threshold_hi=0.4, bg_threshold_lo=0.1, top_k=1),
                                  dict(top_k=2)], ids=["cmil", "top2"])
def test_roi_label_matches_jax(seed, args):
    """CMIL's thresholds (fg 0.6, bg [0.1, 0.4), top 1) and the defaults
    at top 2: every field equal, and the weights' gradient in the class
    weights (a cotangent per proposal) equal."""
    boxes, scores, labels, weights = _label_inputs(seed)
    ious = np.asarray(jax.vmap(jax_pairwise_iou)(jnp.asarray(boxes), jnp.asarray(boxes)))
    cot = np.random.RandomState(seed).randn(*scores.shape[:2]).astype(np.float32)

    def jax_fn(cw):
        out = jax.vmap(lambda s, u, l, w: jax_ops.roi_label(s, u, l, w, **args))(
            jnp.asarray(scores), jnp.asarray(ious), jnp.asarray(labels), cw)
        return (out["weight"] * cot).sum(), out

    (_, want), want_grad = jax.jit(jax.value_and_grad(jax_fn, has_aux=True))(jnp.asarray(weights))
    cw = torch.tensor(weights, requires_grad=True)
    got = ops.roi_label(torch.tensor(scores), torch.tensor(ious), torch.tensor(labels), cw, **args)
    (got["weight"] * torch.tensor(cot)).sum().backward()
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(cw.grad.numpy(), np.asarray(want_grad))
    label = np.asarray(want["label"])
    assert (label == scores.shape[2]).any() and (label < scores.shape[2]).any()  # background and classes
    assert not np.asarray(want["mined_ok"]).all()
    if args.get("bg_threshold_lo", -1.0) > 0:
        assert (np.asarray(want["weight"]) == 0).any()  # ignored below bg_threshold_lo


# -- roi_merge ----------------------------------------------------------------


def _merge_inputs(seed, r=48, c=4):
    """Proposals with exact duplicates (the merges of lambda 1.0), near
    copies, tied objectness and padded rows (-inf objectness) in the second
    image."""
    rng = np.random.RandomState(seed)
    xy = rng.randint(0, 40, (2, r, 2)).astype(np.float32)
    boxes = np.concatenate([xy, xy + rng.randint(10, 40, (2, r, 2))], -1).astype(np.float32)
    boxes[:, 10:14] = boxes[:, 3:4]  # four duplicates of proposal 3
    boxes[:, 20] = boxes[:, 5] + [0, 0, 1, 1]
    obj = rng.rand(2, r).astype(np.float32)
    obj[:, 30] = obj[:, 31]
    obj[1, -6:] = -np.inf
    cls = rng.randn(2, r, c).astype(np.float32)
    det = rng.randn(2, r, c).astype(np.float32)
    return boxes, obj, cls, det


@pytest.mark.parametrize("lam", [0.3, 1.0])
@pytest.mark.parametrize("caps", [(200, 40), (20, 6)], ids=["default", "small_window"])
def test_roi_merge_matches_jax(lam, caps):
    """The cliques, counts, cluster rows and their validity as the JAX
    package's fori loop finds them, at lambda 0.3 and 1.0, with the default
    prefix and window and with a prefix (20) and window (6) smaller than
    the proposals; the merged rows' gradient in the members (G[id] /
    count) as ``jax.grad``'s."""
    top_cap, window = caps
    boxes, obj, cls, det = _merge_inputs(0)
    cot = np.random.RandomState(1).randn(*cls.shape).astype(np.float32)

    def jax_fn(cl, dl):
        def one(o, b, c1, d1):
            return jax_zoo.roi_merge(o, jax_pairwise_iou(b, b), c1, d1, jnp.float32(lam), top_cap, window)

        out = jax.vmap(one)(jnp.asarray(obj), jnp.asarray(boxes), cl, dl)
        return ((out["merged_cls"] + 2.0 * out["merged_det"]) * cot).sum(), out

    (_, want), (g_cls, g_det) = jax.jit(jax.value_and_grad(jax_fn, argnums=(0, 1), has_aux=True))(
        jnp.asarray(cls), jnp.asarray(det))
    ids = roi_merge_ids(torch.tensor(obj), torch.tensor(boxes), lam, top_cap, window)
    cl, dl = torch.tensor(cls, requires_grad=True), torch.tensor(det, requires_grad=True)
    got = roi_merge(ids, cl, dl)
    ((got["merged_cls"] + 2.0 * got["merged_det"]) * torch.tensor(cot)).sum().backward()
    for k in ("ids", "counts", "row_valid"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    np.testing.assert_array_equal(got["ids"].amax(1).numpy() + 1, np.asarray(want["num_id"]))
    for k in ("merged_cls", "merged_det"):
        assert _rel(want[k], got[k].detach().numpy()) <= 1e-6, k
    assert _rel(g_cls, cl.grad.numpy()) <= 1e-6 and _rel(g_det, dl.grad.numpy()) <= 1e-6
    counts = np.asarray(want["counts"])
    assert counts.max() >= (5 if caps == (200, 40) else 2)  # the duplicates merge
    # padding never pivots nor joins: each padded row is a singleton
    ids1 = np.asarray(want["ids"])[1]
    assert all(counts[1, ids1[i]] == 1 for i in range(len(ids1) - 6, len(ids1)))


@pytest.mark.parametrize("cur_iter", [0, 1, 250, 5000, 35000, 50000])
def test_roi_merge_lambda_matches_jax(cur_iter):
    """The continuation threshold of CMIL's yamls (MAX_ITER 50000,
    SIZE_EPOCH 5000: 10 epochs) as the JAX function computes it."""
    want = float(jax_zoo.roi_merge_lambda(cur_iter, 10.0, 5000.0))
    got = roi_merge_lambda(cur_iter, 10.0, 5000.0)
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-6), (got, want)
    assert (got == 0.0) == (cur_iter == 0)


# -- GAM ----------------------------------------------------------------------


def test_gam_layer_and_loss_match_jax():
    """The attended map, the image logits, ``loss_gam`` and the gradients
    of the loss plus a cotangent of the attended map, in the map and in
    ``conv6`` and ``conv7``, from the JAX layer's seeded weights carried
    across by the converter."""
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(2, 5, 7, 16), 0.0).astype(np.float32)
    labels = np.array([[1, 0, 1], [0, 0, 1]], np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    jm = jax_mil.GAMLayer(num_classes=3)
    variables = _random_variables(jm, jnp.asarray(x))

    def loss(params, xx):
        att, logits = jm.apply({"params": params}, xx)
        lg = jax_mil.gam_image_loss(logits, jnp.asarray(labels))
        return lg + (att * cot).sum(), (att, logits, lg)

    with jax.default_matmul_precision("highest"):
        (_, (att, logits, lg)), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
            variables["params"], jnp.asarray(x))
    tm = GAMLayer(16, 3)
    tm.load_state_dict(variables_to_state_dict(variables))
    xt = torch.tensor(x).permute(0, 3, 1, 2).contiguous().requires_grad_()
    t_att, t_logits = tm(xt)
    t_lg = gam_image_loss(t_logits, torch.tensor(labels))
    (t_lg + (t_att.permute(0, 2, 3, 1) * torch.tensor(cot)).sum()).backward()
    assert _rel(att, t_att.permute(0, 2, 3, 1).detach().numpy()) <= 1e-5
    assert _rel(logits, t_logits.detach().numpy()) <= 1e-5
    assert _rel(lg, t_lg.item()) <= 1e-5
    assert _rel(gx, xt.grad.permute(0, 2, 3, 1).numpy()) <= 1e-5
    want = variables_to_state_dict({"params": jax.tree_util.tree_map(np.asarray, gp)})
    for name, p in tm.named_parameters():
        assert _rel(want[name].numpy(), p.grad.numpy()) <= 1e-5, name
