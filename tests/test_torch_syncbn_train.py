"""A tiny SyncBN Mask R-CNN trained in the port and in the JAX package on the
CPU: ``_fpn_tiny`` with MODEL.RESNETS, FPN, the box head (a
``FastRCNNConvFCHead`` of 2 convolutions) and the mask head on SyncBN,
FREEZE_AT 2, from the JAX package's initialisation carried across by
``variables_to_state_dict`` (running statistics included).

Sampling is deterministic on both sides, as in
``tests/test_torch_families_train.py``: every anchor and every proposal a
slot at positive fraction 1.0.

Held: the first step's losses within 1e-5 relative and every gradient
within 5e-5 of its largest magnitude (the batch statistics in the graph);
three steps of ``engine.make_train_step`` against the JAX package's train
step with ``batch_stats`` mutable (``engine/train_loop.py:52-72``): each
step's losses and every parameter within 5e-5 of its layer's scale, and
every running statistic within 5e-5 (the means of the activations' scale,
the variances of their own; measured 7.4e-6 at most: a statistic holds
the rounding of every layer before it, and the variance E[x^2] - E[x]^2
cancels digits; ``tests/test_torch_batch_norm.py`` holds the module itself
within 1e-6); the frozen stem's and res2's statistics move as JAX's
(FREEZE_AT stops gradients only); the detections afterwards equal the JAX
package's ``apply`` without ``mutable`` (the running statistics), and the
port serves with them also from a model left in ``train()`` mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.solver import build_optimizer as jax_build_optimizer
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.engine import create_train_state, make_train_step
from jtsm_tpu_torch.layers import NaiveSyncBatchNorm, batch_norms, batch_statistics
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer
from tests.modeling.test_meta_archs import _batch, _fpn_tiny
from tests.test_torch_meta_archs import _batch as _serve_batch
from tests.test_torch_meta_archs import _same_detections

STEPS = 3
TOL_LOSS = 1e-5
TOL_GRAD = 5e-5
TOL_STATS = 5e-5
LOSSES = ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"]


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads_ieee_convolutions():
    """Two intra-op threads, and PyTorch's own CPU convolutions in place of
    oneDNN's while this file runs. Batch statistics in the graph make a
    weight's gradient a small difference of large terms, and oneDNN's
    float32 convolutions on this CPU lose digits there: res3.1.conv2's
    gradient measured 3.7e-2 from a float64 run of the same model with
    oneDNN, 1.4e-5 without it, and the JAX package's 3.0e-5 (with FrozenBN
    the gap does not show)."""
    n, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mkldnn


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max(initial=0.0) / max(np.abs(want).max(initial=0.0), 1e-30))


def syncbn_tiny_cfg(jax_side=True):
    """``_fpn_tiny`` on SyncBN in the parity regime; the JAX package's config
    tree, or the port's."""
    cfg = _fpn_tiny(jax_get_cfg())
    m = cfg.MODEL
    m.MASK_ON = True
    for node in (m.RESNETS, m.FPN, m.ROI_BOX_HEAD, m.ROI_MASK_HEAD):
        node.NORM = "SyncBN"
    m.ROI_BOX_HEAD.NUM_CONV = 2
    m.ROI_BOX_HEAD.CONV_DIM = 32
    m.BACKBONE.FREEZE_AT = 2
    m.RPN.BATCH_SIZE_PER_IMAGE = 1024  # 1023 anchors at 64x64
    m.RPN.POSITIVE_FRACTION = 1.0
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 36  # 32 proposals and 4 ground-truth rows
    m.ROI_HEADS.POSITIVE_FRACTION = 1.0
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.SOLVER.BASE_LR = 0.00005
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (2,)
    if jax_side:
        return cfg
    port = get_cfg()
    port.merge_from_other_cfg(cfg)
    return port


def jax_train_run(cfg, batch, serve_batch=None, steps=STEPS, seed=0):
    """The JAX side (with ``batch_stats`` mutable where the model has them,
    as the JAX package's train step takes it): the initial variables, the
    first step's losses and gradients, ``steps`` steps (losses and the
    variables after them) and, given ``serve_batch``, the detections of the
    trained variables without ``mutable``."""
    model = jax_build_model(cfg)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(lambda k: model.init({"params": k, "sampling": k}, batch, train=True))(
            jax.random.key(seed))
        frozen = variables.get("frozen", {})

        def loss_fn(params, batch_stats):
            v = {"params": params}
            if frozen:
                v["frozen"] = frozen
            rngs = {"sampling": jax.random.key(1)}
            if batch_stats:
                losses, mutated = model.apply(dict(v, batch_stats=batch_stats), batch, train=True, rngs=rngs,
                                              mutable=["batch_stats"])
                batch_stats = mutated["batch_stats"]
            else:
                losses = model.apply(v, batch, train=True, rngs=rngs)
            total = jnp.asarray(0.0, jnp.float32)
            for x in losses.values():
                total = total + x
            return total, (losses, batch_stats)

        value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
        params, stats = variables["params"], variables.get("batch_stats", {})
        (_, (losses, _)), grads = value_and_grad(params, stats)
        tx = jax_build_optimizer(cfg, params)

        @jax.jit
        def update(g, opt_state, params):
            updates, opt_state = tx.update(g, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        opt_state, metrics = tx.init(params), []
        for _ in range(steps):
            (total, (m, stats)), g = value_and_grad(params, stats)
            params, opt_state = update(g, opt_state, params)
            metrics.append(dict({k: float(v) for k, v in m.items()}, total_loss=float(total)))
        final = {"params": params}
        if stats:
            final["batch_stats"] = stats
        if frozen:
            final["frozen"] = frozen
        served = None
        if serve_batch is not None:
            served = jax.jit(lambda v: model.apply(v, serve_batch, train=False))(final)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(variables=to_np(variables), losses={k: float(v) for k, v in losses.items()}, grads=to_np(grads),
                metrics=metrics, final=to_np(final), served=None if served is None else to_np(served))


def port_model(cfg, variables):
    model = build_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(variables), strict=True)
    return model


def layer_scale(params, name):
    layer = name.rsplit(".", 1)[0]
    return max(float(np.abs(np.asarray(params[f"{layer}.{leaf}"])).max())
               for leaf in ("weight", "bias") if f"{layer}.{leaf}" in params)


def stats_errors(want, got):
    """Per batch norm: its running mean's gap over the activations' scale
    (the root of the largest E[x^2]), its running variance's over its own
    largest value."""
    out = {}
    for k in want:
        if k.endswith("running_mean"):
            v = k[:-4] + "var"
            wm, wv = want[k].numpy().astype(np.float64), want[v].numpy().astype(np.float64)
            gm, gv = got[k].numpy().astype(np.float64), got[v].numpy().astype(np.float64)
            out[k[:-len(".running_mean")]] = (np.abs(wm - gm).max() / np.sqrt(wv + wm * wm).max(),
                                              np.abs(wv - gv).max() / np.abs(wv).max())
    return out


@pytest.fixture(scope="module")
def run():
    batch = {k: np.array(v) for k, v in _batch(masks=True).items()}
    serve = _serve_batch()
    r = jax_train_run(syncbn_tiny_cfg(), batch, serve)
    return dict(r, batch=batch, serve=serve)


def test_syncbn_model_has_batch_norms_everywhere(run):
    model = port_model(syncbn_tiny_cfg(False), run["variables"])
    names = [n for n, m in model.named_modules() if isinstance(m, NaiveSyncBatchNorm)]
    assert len(names) == len(batch_norms(model)) == len(variables_to_state_dict(
        {"batch_stats": run["variables"]["batch_stats"]})) // 2
    for part in ("bottom_up.stem", "bottom_up.res5", "fpn_lateral2", "fpn_output5", "box_head.conv2", "mask_fcn1"):
        assert any(part in n for n in names), part


def test_syncbn_losses_and_gradients_match_jax(run):
    model = port_model(syncbn_tiny_cfg(False), run["variables"])
    model.train()
    with batch_statistics():
        losses = model(run["batch"], generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    assert sorted(losses) == sorted(run["losses"]) == LOSSES
    for k in losses:
        assert _rel(run["losses"][k], losses[k].item()) <= TOL_LOSS, k
    want = variables_to_state_dict({"params": run["grads"]})
    grads = {n: p.grad for n, p in model.named_parameters()}
    assert sorted(want) == sorted(grads)
    live = 0
    for name, w in want.items():
        w = w.numpy()
        if not np.abs(w).max() > 0:
            assert grads[name] is None or not grads[name].abs().max() > 0, name
            continue
        assert _rel(w, grads[name].numpy()) <= TOL_GRAD, (name, _rel(w, grads[name].numpy()))
        live += 1
    assert live >= 80  # the norms' scales and shifts train
    assert grads["backbone.bottom_up.stem.conv1.norm.weight"] is None  # FREEZE_AT 2


def test_syncbn_three_train_steps_match_jax(run):
    cfg = syncbn_tiny_cfg(False)
    model = port_model(cfg, run["variables"])
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))
    for i in range(STEPS):
        metrics = train_step(state, run["batch"])
        for k, v in metrics.items():
            assert _rel(run["metrics"][i][k], v.item()) <= TOL_GRAD, (i, k)
    want = {k: v for k, v in variables_to_state_dict(run["final"]).items()}
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        if "running_" in k:
            continue
        gap = float(np.abs(want[k].numpy() - got[k].numpy()).max())
        assert gap <= TOL_GRAD * layer_scale(want, k), (k, gap)
    errs = stats_errors(want, got)
    assert max(max(e) for e in errs.values()) <= TOL_STATS, sorted(errs.items(), key=lambda x: -max(x[1]))[:3]
    # every batch norm's statistics moved, the frozen stem's and res2's too
    start = variables_to_state_dict(run["variables"])
    for name in errs:
        assert not torch.equal(start[f"{name}.running_var"], got[f"{name}.running_var"]), name
    assert "backbone.bottom_up.stem.conv1.norm" in errs and "backbone.bottom_up.res2.0.conv1.norm" in errs


def test_syncbn_inference_after_training_matches_jax(run):
    """The trained variables serve with their running statistics: the
    detections equal the JAX package's ``apply`` without ``mutable``, from
    a model in ``eval()`` mode and from one left in ``train()`` mode, whose
    statistics stay as they are."""
    model = port_model(syncbn_tiny_cfg(False), run["final"])
    want = {k: np.asarray(v) for k, v in run["served"].items()}
    assert want["valid"].sum() > 10
    model.eval()
    got = model(run["serve"])
    _same_detections(want, got, upscale=2.0)  # the batch's original sizes are twice its own
    model.train()
    before = {k: v.clone() for k, v in model.state_dict().items() if "running_" in k}
    again = model.inference(run["serve"])
    for k in got:
        assert torch.equal(got[k], again[k]), k
    for k, v in before.items():
        assert torch.equal(v, model.state_dict()[k]), k
