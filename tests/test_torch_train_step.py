"""The port's training slice held against the JAX package on the CPU: the
tiny FPN Mask R-CNN (``_fpn_tiny`` with MASK_ON and FREEZE_AT 2) takes the
same train steps from the same weights on the same batch.

Sampling is made deterministic on both sides, as docs/notes/
reference_parity.md describes, by budgeting more slots than candidates at
positive fraction 1.0: the 64x64 images have 1023 anchors for 1024 RPN
slots, and 32 proposals plus 4 ground truth rows fill exactly the 36 ROI
slots (the JAX package's top-k needs at least as many candidates as
slots); the mask branch's 128 slots exceed the 36. Which slot holds which
ROI is still random on both sides; the losses are sums over slots and do
not depend on it.

Tolerances (float32 on both sides, JAX matmul precision "highest"; the two
frameworks round convolutions and sums differently, measured ~1e-6): the
first step's losses to 1e-5 relative, gradients to 5e-5 of each
parameter's gradient scale, the trajectory's losses and every parameter
after three SGD steps to 5e-5 of their scale (the differences grow with
each update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.engine.train_loop import TrainState as JaxTrainState
from jtsm_tpu.engine.train_loop import make_train_step as jax_make_train_step
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.solver import build_optimizer as jax_build_optimizer
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.engine import create_train_state, make_train_step
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer
from tests.modeling.test_meta_archs import _batch, _fpn_tiny


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads while this file runs, as the other port test
    files have: at one a core, PyTorch's pools spin under the parallel
    tier-1 run and slow every worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

LOSSES = ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"]
STEPS = 3


def _cfg():
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 1024
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 36
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    # warmup over the first two updates, then the milestone: three
    # learning rates in three steps
    cfg.SOLVER.BASE_LR = 0.002
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (2,)
    return cfg


@pytest.fixture(scope="module")
def jax_run():
    """The JAX side, compiled once for the module: the initial variables,
    the loss dict and gradients of the first step, and the metrics and
    parameters of three steps of ``jtsm_tpu.engine.make_train_step``."""
    cfg = _cfg()
    batch = {k: np.array(v) for k, v in _batch(masks=True).items()}
    model = jax_build_model(cfg)
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(
            lambda k: model.init({"params": k, "sampling": k}, batch, train=True)
        )(jax.random.key(0))

        def loss_fn(params):
            losses = model.apply(
                {"params": params, "frozen": variables["frozen"]}, batch, train=True,
                rngs={"sampling": jax.random.key(1)},
            )
            return sum(losses.values()), losses

        (_, losses), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(variables["params"])
        tx = jax_build_optimizer(cfg, variables["params"])
        state = JaxTrainState(
            step=jnp.zeros((), jnp.int32), params=variables["params"], frozen=variables["frozen"],
            batch_stats={}, opt_state=tx.init(variables["params"]), rng=jax.random.key(2),
        )
        step = jax.jit(jax_make_train_step(model, tx))
        metrics = []
        for _ in range(STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return dict(
        cfg=cfg, batch=batch, variables=to_np(variables),
        losses={k: float(v) for k, v in losses.items()}, grads=to_np(grads), metrics=metrics,
        final=to_np({"params": state.params, "frozen": state.frozen}),
    )


def _torch_model(jax_run):
    cfg = get_cfg()
    cfg.merge_from_other_cfg(jax_run["cfg"])
    model = build_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(jax_run["variables"]), strict=True)
    return cfg, model


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def test_train_losses_match_jax(jax_run):
    _, model = _torch_model(jax_run)
    model.train()
    losses = model(jax_run["batch"], generator=torch.Generator().manual_seed(0))
    assert sorted(losses) == sorted(jax_run["losses"]) == LOSSES
    for k in LOSSES:
        assert np.isfinite(jax_run["losses"][k]) and jax_run["losses"][k] > 0
        assert _rel(jax_run["losses"][k], losses[k].item()) <= 1e-5, k


@pytest.mark.parametrize(
    "name",
    [
        "backbone.fpn_lateral3.weight",
        "proposal_generator.rpn_head.conv.weight",
        "roi_heads.box_head.fc1.weight",
        "roi_heads.mask_head.predictor.weight",
        "backbone.bottom_up.res3.0.conv1.weight",
        "backbone.bottom_up.stem.conv1.weight",
    ],
)
def test_train_gradients_match_jax(jax_run, name):
    _, model = _torch_model(jax_run)
    model.train()
    losses = model(jax_run["batch"], generator=torch.Generator().manual_seed(0))
    sum(losses.values()).backward()
    want = variables_to_state_dict({"params": jax_run["grads"]})[name].numpy()
    got = dict(model.named_parameters())[name].grad
    if "stem" in name:
        # FREEZE_AT 2: the stem and res2 sit behind the detach, as behind
        # the JAX package's stop_gradient
        assert got is None and np.abs(want).max() == 0.0
        return
    assert np.abs(want).max() > 0
    assert _rel(want, got.numpy()) <= 5e-5


def test_three_train_steps_match_jax(jax_run):
    cfg, model = _torch_model(jax_run)
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))
    stem_before = model.backbone.bottom_up.stem.conv1.weight.detach().clone()
    for i in range(STEPS):
        metrics = train_step(state, jax_run["batch"])
        assert sorted(metrics) == sorted(jax_run["metrics"][i]) == LOSSES + ["total_loss"]
        for k, v in metrics.items():
            assert _rel(jax_run["metrics"][i][k], v.item()) <= 5e-5, (i, k)
    assert state.step == STEPS
    want = variables_to_state_dict(jax_run["final"])
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(want[k].numpy(), got[k].numpy()) <= 5e-5, k
    # weight decay and momentum move the frozen stem as they do in the JAX
    # package, though its gradient is zero
    assert not torch.equal(model.backbone.bottom_up.stem.conv1.weight.detach(), stem_before)
