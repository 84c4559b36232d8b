"""The port's trainers for RetinaNet, the RPN alone, Keypoint R-CNN,
Panoptic FPN and ``SemanticSegmentor`` held against the JAX package on the
CPU, over the dev script's synthetic tree (``dev/make_synthetic_coco.py``):

* the train loaders of the person keypoint set and the separated panoptic
  set, key for key and bit for bit (``gt_keypoints`` through the flip and
  its flip indices, ``gt_sem_seg``);
* the four synthetic training gates (``configs/quick_schedules/
  <family>_R_18_synthetic_training_acc_test.yaml``) through the port's
  command line (``tools.train_net.main``, in this process) for
  SOLVER.MAX_ITER 4, beside the JAX package's ``DefaultTrainer`` given one
  loader stream (``tests/test_torch_trainer.py``'s ``_OneStream``; ROADMAP
  §3), both from one ``.pth`` of the JAX trainer's initialisation: each
  iteration's losses in the two ``metrics.json`` within 1e-4 relative and
  the learning rates within 2 float32 ulps. The gates' pins cannot be the
  yardstick (ROADMAP §3); their solver stays (rate, clip), with the warmup
  and the milestone brought into the 4 iterations. Sampling is made
  deterministic as in the other parity tests: RPN slots for every anchor
  at positive fraction 1.0 (7758 anchors in the 176x176 bucket, 8192
  slots), and ROI slots for every proposal and ground-truth row (124 + 4
  = 128, which the mask and keypoint picks take whole). Keypoint R-CNN
  runs here; the other three are slow;
* ``semantic_R_50_FPN_training_acc_test.yaml`` on the tiny config
  (``_fpn_tiny``) through both trainers, on the separated panoptic set's
  stuff maps: its stuff-only set has no ground truth in either package
  (ROADMAP §3);
* every entry point raises without a card unless the CPU is asked for.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data.build import build_detection_train_loader as jax_train_loader
from jtsm_tpu.data.datasets.builtin import register_coco_panoptic_separated as jax_register_panoptic
from jtsm_tpu.data.datasets.builtin_meta import _get_builtin_metadata as jax_metadata
from jtsm_tpu.data.datasets.coco import register_coco_instances as jax_register
from jtsm_tpu.engine import DefaultTrainer as JaxDefaultTrainer
from jtsm_tpu.engine import hooks as jax_hooks
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg
from jtsm_tpu_torch.data.build import build_detection_train_loader
from jtsm_tpu_torch.data.datasets.builtin import register_coco_panoptic_separated
from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
from jtsm_tpu_torch.data.datasets.coco import register_coco_instances
from jtsm_tpu_torch.engine import DefaultTrainer
from jtsm_tpu_torch.engine import hooks
from jtsm_tpu_torch.modeling import build_model
from tests.modeling.test_meta_archs import _batch, _fpn_tiny
from tests.test_torch_meta_archs import _tiny
from tests.test_torch_trainer import _metrics, _one_stream, _rel, _write_every_iteration
from tests.test_torch_train_loader import _assert_same, _first_batches, unregister

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PERSON = "torch_families_person"
PANOPTIC = "torch_families_panoptic"  # registers <name>_separated
ITERS = 4  # the losses of iterations 0-2 reach metrics.json at lines 1-3
GATES = ["keypoint_rcnn", "retinanet", "rpn", "panoptic_fpn"]
SEM_YAML = os.path.join(ROOT, "configs/quick_schedules/semantic_R_50_FPN_training_acc_test.yaml")


def _gate_yaml(family):
    return os.path.join(ROOT, "configs", "quick_schedules", f"{family}_R_18_synthetic_training_acc_test.yaml")


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The dev script's ``coco`` tree; its person keypoint set as PERSON and
    its separated panoptic set as PANOPTIC + "_separated", in both
    packages."""
    root = str(tmp_path_factory.mktemp("families_tree"))
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", root,
                    "--num", "8", "--num-varied", "1"], check=True, capture_output=True, cwd=ROOT)
    coco = os.path.join(root, "coco")
    for reg, meta in ((jax_register, jax_metadata), (register_coco_instances, _get_builtin_metadata)):
        reg(PERSON, meta("coco_person"), os.path.join(coco, "annotations/person_keypoints_val2017_100.json"),
            os.path.join(coco, "val2017"))
    for reg, meta in ((jax_register_panoptic, jax_metadata), (register_coco_panoptic_separated, _get_builtin_metadata)):
        reg(PANOPTIC, meta("coco_panoptic_separated"), os.path.join(coco, "val2017"),
            os.path.join(coco, "panoptic_val2017_100"), os.path.join(coco, "annotations/panoptic_val2017_100.json"),
            os.path.join(coco, "panoptic_stuff_val2017_100"),
            os.path.join(coco, "annotations/instances_val2017_100.json"))
    yield root
    unregister([PERSON, PANOPTIC + "_separated", PANOPTIC + "_stuffonly"])


def _train_set(family):
    return PERSON if family == "keypoint_rcnn" else PANOPTIC + "_separated"


def _parity_opts(family, out, weights):
    """The gate in the parity regime (see the module docstring)."""
    return ["DATASETS.TRAIN", f"('{_train_set(family)}',)", "SOLVER.MAX_ITER", str(ITERS),
            "SOLVER.WARMUP_ITERS", "2", "SOLVER.STEPS", "(3,)", "SOLVER.CHECKPOINT_PERIOD", "100",
            "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "8192", "MODEL.RPN.POSITIVE_FRACTION", "1.0",
            "MODEL.RPN.POST_NMS_TOPK_TRAIN", "124", "TPU.MAX_GT_INSTANCES", "4",
            "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "128", "MODEL.ROI_HEADS.POSITIVE_FRACTION", "1.0",
            "TEST.EXPECTED_RESULTS", "[]", "MODEL.WEIGHTS", weights, "OUTPUT_DIR", out]


# -- the train loaders --------------------------------------------------------------


@pytest.mark.parametrize("family", ["keypoint_rcnn", "panoptic_fpn"])
def test_train_loader_keypoints_and_stuff_maps_equal_jax(tree, family):
    """The first 4 batches of each package's train loader on the gate's
    config (SEED 42, the flip): key for key and bit for bit, with
    ``gt_keypoints`` (mirrored and reordered where flipped) or ``gt_sem_seg``."""
    opts = ["DATASETS.TRAIN", f"('{_train_set(family)}',)", "TPU.MAX_GT_INSTANCES", "5"]
    jc, pc = jax_get_cfg(), get_cfg()
    for c in (jc, pc):
        c.merge_from_file(_gate_yaml(family))
        c.merge_from_list(opts)
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_train_loader(jc), 4)
    got = _first_batches(build_detection_train_loader(pc), 4)
    _assert_same(want, got)
    if family == "keypoint_rcnn":
        kp = np.concatenate([b["gt_keypoints"][b["gt_valid"]] for b in got])
        assert kp.shape[1:] == (17, 3) and (kp[..., 2] == 2).mean() > 0.9
        assert "gt_mask_crops" not in got[0]
    else:
        assert all(set(np.unique(b["gt_sem_seg"])) <= {0, 1, 2, 255} for b in got)
        assert "gt_keypoints" not in got[0]


# -- the gates through the command line --------------------------------------------


def _gate_runs(family, tmp, monkeypatch):
    """The JAX trainer (one stream) and the port's command line on the gate
    for ITERS iterations from one .pth of the JAX trainer's initialisation;
    the two metrics.json."""
    weights = str(tmp / "init.pth")
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jc = jax_get_cfg()
    jc.merge_from_file(_gate_yaml(family))
    jc.merge_from_list(_parity_opts(family, out["jax"], weights))
    jax_seed_all_rng(jc.SEED)
    with jax.default_matmul_precision("highest"):
        jt = _one_stream(JaxDefaultTrainer)(jc)
        variables = jax.tree_util.tree_map(np.asarray, jt._trainer.state_variables())
        torch.save({"model": variables_to_state_dict(variables)}, weights)
        jt.resume_or_load(resume=False)
        _write_every_iteration(jt, jax_hooks)
        jt.train()
    from jtsm_tpu_torch.tools import train_net

    real = hooks.PeriodicWriter.__init__
    # a metrics.json line every iteration (the writers flush every 20)
    monkeypatch.setattr(hooks.PeriodicWriter, "__init__", lambda self, writers, period=20: real(self, writers, 1))
    train_net.main(train_net.argument_parser().parse_args(
        ["--device", "cpu", "--config-file", _gate_yaml(family)] + _parity_opts(family, out["port"], weights)))
    return _metrics(os.path.join(out["jax"], "metrics.json")), _metrics(os.path.join(out["port"], "metrics.json"))


LOSSES = {
    "keypoint_rcnn": {"loss_cls", "loss_box_reg", "loss_keypoint", "loss_rpn_cls", "loss_rpn_loc"},
    "retinanet": {"loss_cls", "loss_box_reg"},
    "rpn": {"loss_rpn_cls", "loss_rpn_loc"},
    "panoptic_fpn": {"loss_sem_seg", "loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"},
}


def _same_losses_and_rates(want, got, family):
    assert [m["iteration"] for m in want] == [m["iteration"] for m in got] == list(range(ITERS))
    for w, g in zip(want[1:], got[1:]):
        losses = {k for k in w if k.startswith("loss")}
        assert losses == {k for k in g if k.startswith("loss")} == LOSSES[family]
        for k in sorted(losses) + ["total_loss"]:
            assert np.isfinite(w[k]) and _rel(w[k], g[k]) <= 1e-4, (w["iteration"], k, w[k], g[k])
    for w, g in zip(want, got):
        assert abs(w["lr"] - g["lr"]) <= 2 * np.spacing(np.float32(g["lr"])), (w["iteration"], w["lr"], g["lr"])
    assert len({m["lr"] for m in got}) == 4  # two warmup rates, the base rate, the milestone


@pytest.mark.parametrize("family", [pytest.param(f, marks=() if f == "keypoint_rcnn" else pytest.mark.slow)
                                    for f in GATES])
def test_gate_cli_losses_match_the_jax_trainer(tree, tmp_path, monkeypatch, family):
    want, got = _gate_runs(family, tmp_path, monkeypatch)
    _same_losses_and_rates(want, got, family)
    assert os.path.exists(tmp_path / "port" / "model_final.pth")


def _semantic_cfg(jax_side, out, weights):
    cfg = jax_get_cfg()
    cfg.merge_from_file(SEM_YAML)
    _fpn_tiny(cfg)
    cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 4
    cfg.DATASETS.TRAIN = (PANOPTIC + "_separated",)
    cfg.TPU.IMAGE_BUCKETS = [[64, 64]]
    cfg.INPUT.MIN_SIZE_TRAIN = (48, 56, 64)
    cfg.INPUT.MAX_SIZE_TRAIN = 64
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (3,)
    cfg.SOLVER.MAX_ITER = ITERS
    cfg.SOLVER.CHECKPOINT_PERIOD = 100
    cfg.MODEL.WEIGHTS = weights
    cfg.OUTPUT_DIR = out
    cfg.SEED = 42
    if jax_side:
        return cfg
    port = get_cfg()
    port.merge_from_other_cfg(cfg)
    return port


def test_semantic_trainer_losses_match_jax(tree, tmp_path):
    """The semantic yaml on the tiny config: both DefaultTrainers on the
    stuff maps of the separated panoptic set (things 0, two stuff bands)."""
    weights = str(tmp_path / "init.pth")
    jc = _semantic_cfg(True, str(tmp_path / "jax"), weights)
    jax_seed_all_rng(jc.SEED)
    with jax.default_matmul_precision("highest"):
        jt = _one_stream(JaxDefaultTrainer)(jc)
        variables = jax.tree_util.tree_map(np.asarray, jt._trainer.state_variables())
        torch.save({"model": variables_to_state_dict(variables)}, weights)
        jt.resume_or_load(resume=False)
        _write_every_iteration(jt, jax_hooks)
        jt.train()
    pt = DefaultTrainer(_semantic_cfg(False, str(tmp_path / "port"), weights), device="cpu")
    pt.resume_or_load(resume=False)
    _write_every_iteration(pt, hooks)
    pt.train()
    want, got = _metrics(str(tmp_path / "jax" / "metrics.json")), _metrics(str(tmp_path / "port" / "metrics.json"))
    assert [m["iteration"] for m in want] == [m["iteration"] for m in got] == list(range(ITERS))
    for w, g in zip(want[1:], got[1:]):
        assert _rel(w["loss_sem_seg"], g["loss_sem_seg"]) <= 1e-4, (w["iteration"], w["loss_sem_seg"],
                                                                     g["loss_sem_seg"])


# -- the entry points ------------------------------------------------------------------

TINY = {"retinanet": "retinanet", "rpn": "proposal_network", "keypoint_rcnn": "keypoint_rcnn",
        "panoptic_fpn": "panoptic_fpn", "semantic": "semantic_segmentor"}
ARCHS = {
    "retinanet": "configs/quick_schedules/retinanet_R_18_synthetic_training_acc_test.yaml",
    "rpn": "configs/quick_schedules/rpn_R_18_synthetic_training_acc_test.yaml",
    "keypoint_rcnn": "configs/quick_schedules/keypoint_rcnn_R_18_synthetic_training_acc_test.yaml",
    "panoptic_fpn": "configs/quick_schedules/panoptic_fpn_R_18_synthetic_training_acc_test.yaml",
    "semantic": "configs/quick_schedules/semantic_R_50_FPN_training_acc_test.yaml",
}


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the entry points on a machine without a card")
@pytest.mark.parametrize("family", sorted(ARCHS))
def test_entry_points_raise_without_a_card(family):
    """``build_model`` and ``DefaultTrainer`` default to the card and raise
    here; asked for the CPU, the model trains."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, ARCHS[family]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DefaultTrainer(cfg)
    tiny = get_cfg()
    tiny.merge_from_other_cfg(_tiny(TINY[family]))
    model = build_model(tiny, device="cpu").train()
    losses = model({k: np.asarray(v) for k, v in _batch(masks=True, sem_seg=True, keypoints=True).items()},
                   generator=torch.Generator().manual_seed(0))
    assert model.device.type == "cpu" and all(np.isfinite(v.item()) for v in losses.values())


def test_semantic_python_config_equals_merged_yaml():
    """``semantic_R_50_FPN_cfg()`` (the card's machine has no PyYAML) is
    the yaml merged into ``get_cfg()``, and the JAX package's merge but for
    the device."""
    from jtsm_tpu_torch.config import semantic_R_50_FPN_cfg

    path = os.path.join(ROOT, "configs/Misc/semantic_R_50_FPN_1x.yaml")
    cfg = get_cfg()
    cfg.merge_from_file(path)
    assert semantic_R_50_FPN_cfg().to_dict() == cfg.to_dict()
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(path)
    jcfg.MODEL.DEVICE = "cuda"
    assert jcfg.to_dict() == cfg.to_dict()


def test_train_net_raises_without_a_card(tree, tmp_path):
    from jtsm_tpu_torch.tools import train_net

    args = train_net.argument_parser().parse_args(
        ["--config-file", _gate_yaml("retinanet"), "OUTPUT_DIR", str(tmp_path), "DATASETS.TRAIN",
         f"('{PANOPTIC}_separated',)"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(args)
    assert not os.path.exists(tmp_path / "metrics.json")
