"""SOLVER.OPTIMIZER ADAM, the WarmupPolyLR schedule and this slice's
configurations in the port, held against the JAX package on the CPU.

* ADAM: three updates of a model with the three parameter groups
  (regular, bias and norm, each with its decay) against the JAX
  package's optax chain (``solver/build.py:127-139``) on the same
  gradients, with no clip and with each clip type: every parameter within
  1e-6 relative after each update.
* WarmupPolyLR: the port's schedule against both of the JAX package's (the
  function of ``build_lr_schedule`` and the class of ``lr_scheduler.py``),
  across warm-up and past MAX_ITER, with a constant ending that also
  floors the warm-up: within 1e-6 relative (the JAX package computes in
  float32).
* The builders ``mask_rcnn_R_50_FPN_{giou,pred_boxes,syncbn}_cfg()`` and
  ``wsddn_R_18_DC5_cfg()`` equal their yamls merged into the port's tree,
  and the JAX package's merge but for the device; the four core yamls of
  this slice and WSDDN R-18 build from their files, raise "no CUDA device"
  without ``device="cpu"``, and, narrowed (ResNet-18 and ``_fpn_tiny``'s
  widths, their norms, losses and FREEZE_AT kept), take a train step on
  the CPU with finite losses.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.solver import build_lr_schedule as jax_build_lr_schedule
from jtsm_tpu.solver import build_optimizer as jax_build_optimizer
from jtsm_tpu.solver.lr_scheduler import WarmupPolyLR as JaxWarmupPolyLR
from jtsm_tpu.wsl import add_wsl_config
from jtsm_tpu_torch.config import (
    get_cfg,
    mask_rcnn_R_50_FPN_giou_cfg,
    mask_rcnn_R_50_FPN_pred_boxes_cfg,
    mask_rcnn_R_50_FPN_syncbn_cfg,
    wsddn_R_18_DC5_cfg,
    wsl_cfg,
)
from jtsm_tpu_torch.engine import DefaultTrainer, create_train_state, make_train_step
from jtsm_tpu_torch.engine.train_loop import sgd_update
from jtsm_tpu_torch.layers import NaiveSyncBatchNorm
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.solver import Adam, WarmupPolyLR, build_lr_schedule, build_optimizer
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

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-6
YAMLS = {
    "giou": "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x_giou.yaml",
    "pred_boxes": "configs/quick_schedules/mask_rcnn_R_50_FPN_pred_boxes_training_acc_test.yaml",
    "syncbn": "configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml",
    "scratch_syncbn": "configs/Misc/scratch_mask_rcnn_R_50_FPN_9x_syncbn.yaml",
    "wsddn_R_18": "projects/WSL/configs/PascalVOC-Detection/wsddn_R_18_DC5_1x.yaml",
}
BUILDERS = {"giou": mask_rcnn_R_50_FPN_giou_cfg, "pred_boxes": mask_rcnn_R_50_FPN_pred_boxes_cfg,
            "syncbn": mask_rcnn_R_50_FPN_syncbn_cfg, "wsddn_R_18": wsddn_R_18_DC5_cfg}


class _Toy(nn.Module):
    """A linear layer (regular and bias groups) and a batch norm's scale and
    shift (the norm group), under the JAX tree's names."""

    def __init__(self):
        super().__init__()
        self.dense = nn.Linear(6, 5)
        self.norm = NaiveSyncBatchNorm(5)


def _solver_cfg(jax_side, clip):
    cfg = jax_get_cfg() if jax_side else get_cfg()
    s = cfg.SOLVER
    s.OPTIMIZER = "ADAM"
    s.BASE_LR = 0.01
    s.WEIGHT_DECAY = 0.01
    s.WEIGHT_DECAY_NORM = 0.001
    s.WEIGHT_DECAY_BIAS = 0.01  # the JAX package labels no bias (ROADMAP §3): its rule here
    s.WARMUP_ITERS = 2
    s.STEPS = (2,)
    if clip:
        s.CLIP_GRADIENTS.ENABLED = True
        s.CLIP_GRADIENTS.CLIP_TYPE = clip
        s.CLIP_GRADIENTS.CLIP_VALUE = 0.5
    return cfg


@pytest.mark.parametrize("clip", [None, "value", "norm", "full_model"])
def test_adam_updates_match_optax(clip):
    rng = np.random.RandomState(0)
    params = {"dense": {"kernel": rng.randn(6, 5).astype(np.float32), "bias": rng.randn(5).astype(np.float32)},
              "norm": {"scale": rng.uniform(0.5, 1.5, 5).astype(np.float32),
                       "bias": rng.randn(5).astype(np.float32)}}
    grads = [jax.tree_util.tree_map(lambda a: (rng.randn(*a.shape) * 3).astype(np.float32), params) for _ in range(3)]
    grads[1]["dense"]["bias"][:] = 0  # a zero gradient: the decay alone (none for biases)
    tx = jax_build_optimizer(_solver_cfg(True, clip), params)
    state, jp, want = tx.init(params), params, []
    for g in grads:
        updates, state = tx.update(g, state, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(jax.tree_util.tree_map(np.asarray, jp))

    cfg = _solver_cfg(False, clip)
    model = _Toy()
    with torch.no_grad():
        model.dense.weight.copy_(torch.from_numpy(params["dense"]["kernel"].T))
        model.dense.bias.copy_(torch.from_numpy(params["dense"]["bias"]))
        model.norm.weight.copy_(torch.from_numpy(params["norm"]["scale"]))
        model.norm.bias.copy_(torch.from_numpy(params["norm"]["bias"]))
    opt = build_optimizer(cfg, model)
    assert type(opt) is Adam
    assert sorted(g["label"] for g in opt.param_groups) == ["bias", "norm", "regular"]
    schedule = build_lr_schedule(cfg)
    for i, g in enumerate(grads):
        model.dense.weight.grad = torch.from_numpy(g["dense"]["kernel"].T.copy())
        model.dense.bias.grad = torch.from_numpy(g["dense"]["bias"].copy())
        model.norm.weight.grad = torch.from_numpy(g["norm"]["scale"].copy())
        model.norm.bias.grad = torch.from_numpy(g["norm"]["bias"].copy())
        sgd_update(opt, schedule(i))
        w = want[i]
        for got, ref in ((model.dense.weight, w["dense"]["kernel"].T), (model.dense.bias, w["dense"]["bias"]),
                         (model.norm.weight, w["norm"]["scale"]), (model.norm.bias, w["norm"]["bias"])):
            err = float(np.abs(got.detach().numpy() - ref).max() / np.abs(ref).max())
            assert err <= TOL, (i, err)


def test_adam_trains_the_tiny_model_with_iter_size():
    """ADAM through ``make_train_step`` with ITER_SIZE 2: the parameters move
    only at the second mini-batch."""
    cfg = get_cfg()
    cfg.merge_from_other_cfg(_fpn_tiny(jax_get_cfg()))
    cfg.MODEL.MASK_ON = True
    cfg.SOLVER.OPTIMIZER = "ADAM"
    cfg.SOLVER.BASE_LR = 1e-4
    cfg.SOLVER.LR_SCHEDULER_NAME = "WarmupPolyLR"
    model = build_model(cfg, device="cpu")
    opt = build_optimizer(cfg, model)
    state = create_train_state(model, opt, 0)
    step = make_train_step(model, opt, build_lr_schedule(cfg), iter_size=2)
    batch = {k: np.asarray(v) for k, v in _batch(masks=True).items()}
    w0 = model.backbone.fpn_output2.weight.detach().clone()
    step(state, batch)
    assert torch.equal(w0, model.backbone.fpn_output2.weight) and state.step == 0
    losses = step(state, batch)
    assert state.step == 1 and not torch.equal(w0, model.backbone.fpn_output2.weight)
    assert all(np.isfinite(v.item()) for v in losses.values())


@pytest.mark.parametrize("method,ending", [("linear", 0.0), ("linear", 0.3), ("constant", 0.05)])
def test_warmup_poly_lr_matches_both_jax_schedules(method, ending):
    cfgs = []
    for c in (jax_get_cfg(), get_cfg()):
        s = c.SOLVER
        s.LR_SCHEDULER_NAME = "WarmupPolyLR"
        s.BASE_LR, s.MAX_ITER, s.WARMUP_ITERS, s.WARMUP_FACTOR, s.WARMUP_METHOD = 0.02, 50, 10, 0.001, method
        s.POLY_LR_POWER = 0.9
        s.POLY_LR_CONSTANT_ENDING = ending
        cfgs.append(c)
    jax_fn = jax_build_lr_schedule(cfgs[0])
    jax_cls = JaxWarmupPolyLR(0.02, 50, 0.001, 10, method, 0.9, ending)
    port = build_lr_schedule(cfgs[1])
    assert isinstance(port, WarmupPolyLR)
    for step in range(0, 60):
        got = port(step)
        for want in (float(jax_fn(jnp.asarray(step, jnp.int32))), float(jax_cls(step))):
            assert abs(got - want) <= TOL * max(abs(want), 1e-30), (step, got, want)
    assert port(55) == pytest.approx(0.02 * ending, abs=1e-12)  # past MAX_ITER the ending, or 0


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_python_configs_equal_their_yamls(name):
    path = os.path.join(ROOT, YAMLS[name])
    wsl = name.startswith("wsddn")
    cfg = wsl_cfg() if wsl else get_cfg()
    cfg.merge_from_file(path)
    assert BUILDERS[name]().to_dict() == cfg.to_dict()
    jcfg = jax_get_cfg()
    if wsl:
        add_wsl_config(jcfg)
    jcfg.merge_from_file(path)
    jcfg.MODEL.DEVICE = "cuda"
    assert jcfg.to_dict() == cfg.to_dict()


def _narrowed(cfg):
    """ResNet-18 with ``_fpn_tiny``'s widths, the yaml's norms, losses,
    TRAIN_ON_PRED_BOXES and FREEZE_AT kept."""
    keep = {k: cfg.MODEL[k[0]][k[1]] for k in (("RESNETS", "NORM"), ("FPN", "NORM"), ("ROI_BOX_HEAD", "NORM"),
                                               ("ROI_MASK_HEAD", "NORM"), ("ROI_BOX_HEAD", "NUM_CONV"),
                                               ("ROI_BOX_HEAD", "BBOX_REG_LOSS_TYPE"), ("RPN", "BBOX_REG_LOSS_TYPE"),
                                               ("ROI_BOX_HEAD", "TRAIN_ON_PRED_BOXES"), ("BACKBONE", "FREEZE_AT"))}
    tiny = get_cfg()
    tiny.merge_from_other_cfg(_fpn_tiny(jax_get_cfg()))
    tiny.MODEL.MASK_ON = True
    tiny.MODEL.ROI_BOX_HEAD.CONV_DIM = 32
    for (a, b), v in keep.items():
        tiny.MODEL[a][b] = v
    tiny.SOLVER = cfg.SOLVER.clone()
    return tiny


@pytest.mark.parametrize("name", ["giou", "pred_boxes", "syncbn", "scratch_syncbn"])
def test_core_yamls_build_raise_without_a_card_and_train(name):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, YAMLS[name]))
    model = build_model(cfg, device="cpu")  # full width, as the yaml sets it
    assert sum(p.numel() for p in model.parameters()) > 40e6
    del model
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DefaultTrainer(cfg)
    tiny = _narrowed(cfg)
    model = build_model(tiny, device="cpu")
    opt = build_optimizer(tiny, model)
    state = create_train_state(model, opt, 0)
    metrics = make_train_step(model, opt, build_lr_schedule(tiny))(
        state, {k: np.asarray(v) for k, v in _batch(masks=True).items()})
    assert state.step == 1 and all(np.isfinite(v.item()) for v in metrics.values())
    if "syncbn" in name:
        assert not torch.equal(model.backbone.bottom_up.stem.conv1.norm.running_var, torch.ones(64))


def test_wsddn_R_18_yaml_builds_and_raises_without_a_card():
    cfg = wsl_cfg()
    cfg.merge_from_file(os.path.join(ROOT, YAMLS["wsddn_R_18"]))
    model = build_model(cfg, device="cpu")
    assert model.backbone.freeze_at == 2 and cfg.INPUT.CROP.ENABLED
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(cfg)
