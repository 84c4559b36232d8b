"""The port's trainers, checkpoints and command lines held against the JAX
package on the CPU.

* The trainers: the JAX package's ``DefaultTrainer`` and the port's on the
  tiny FPN Mask R-CNN (``_fpn_tiny``) over the dev script's tree, in the
  parity regime (ROADMAP "Numerics for parity": every anchor and every
  proposal a slot, positive fraction 1.0, so that the sampled sets do not
  depend on the two frameworks' generators), from one ``.pth`` written
  from the JAX initialisation: each iteration's losses in the two
  ``metrics.json`` agree within 1e-4 relative (float32 on both sides, JAX
  matmul precision "highest"; the frameworks round convolutions and sums
  differently and the difference grows with each update), and the
  learning rates within 2 float32 ulps (the JAX package computes its
  schedule in float32 arithmetic, the port in double). The JTSM gate
  trains through both WSL trainers with ITER_SIZE 2 and the DAN's dropout
  0 from the committed gate weights: the same tolerances for the losses
  and the rates, and each update within 1e-4 and 1e-2 of its L2 norm.
* Checkpoints: the Caffe2 renaming, a zoo ``.pkl`` written from the gate
  fixture, the JAX package's ``.ckpt``, resume on the CPU.
* The command lines: training and ``--resume`` through the port's CLI,
  and the JAX CLI's ``--eval-only`` on the port's ``model_final.pth``
  printing the port's own numbers.
"""

import gzip
import json
import os
import pickle
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jtsm_tpu.checkpoint.c2_model_loading import align_and_update_state_dict as jax_align
from jtsm_tpu.checkpoint.c2_model_loading import convert_c2_detectron_names as jax_convert_c2
from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.engine import DefaultTrainer as JaxDefaultTrainer
from jtsm_tpu.engine import hooks as jax_hooks
from jtsm_tpu.modeling import build_model as jax_build_model
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu_torch.checkpoint import (
    DetectionCheckpointer,
    convert_c2_detectron_names,
    load_gate_ckpt,
    variables_to_state_dict,
)
from jtsm_tpu_torch.config import get_cfg, jtsm_gate_cfg, mask_rcnn_gate_cfg, wsl_cfg
from jtsm_tpu_torch.engine import DefaultTrainer
from jtsm_tpu_torch.engine import hooks
from jtsm_tpu_torch.modeling import build_model
from tests.modeling.test_meta_archs import _fpn_tiny
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_train_loader import COCO_NAME, PANOPTIC_NAME, register_trees, unregister

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_CKPT = os.path.join(ROOT, "tests/fixtures/gate_ckpts/mask_rcnn.ckpt.gz")
JTSM_CKPT = os.path.join(ROOT, "tests/fixtures/gate_ckpts/jtsm.ckpt.gz")
MRCNN_TRAIN_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_training_acc_test.yaml")
MRCNN_EVAL_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml")
ITERS = 5  # the losses of iterations 0-3 reach metrics.json at lines 1-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two intra-op threads for the port while this file runs. Its models
    are tiny, and in a parallel test run a pool of one thread per core
    spins at its barriers while other processes hold the cores: beside 7
    busy processes the ITER_SIZE and command-line tests took 158 s and 495
    CPU-seconds at 8 threads, 88 s and 110 at 2 (alone the file takes 95 s
    at 8 threads, 104-108 s at 2)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer_trees"))
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", root,
                    "--num", "8", "--num-varied", "4"], check=True, capture_output=True, cwd=ROOT)
    names = register_trees(root)
    yield root
    unregister(names)


def _rel(want, got):
    want, got = np.asarray(want, np.float64), np.asarray(got, np.float64)
    return float(np.abs(want - got).max() / max(np.abs(want).max(), 1e-30))


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _write_every_iteration(trainer, hook_module):
    """metrics.json lines for every iteration (the writers flush every 20)."""
    for h in trainer._hooks:
        if isinstance(h, hook_module.PeriodicWriter):
            h._period = 1


class _OneStream:
    """A loader iterated once. The JAX package's ``DefaultTrainer`` takes
    its example batch from one iterator of the loader and trains on a
    second: the sampler starts again, and the first iterator's thread still
    draws augmentations from the global ``np.random`` (ROADMAP §3). One
    stream gives the JAX run the batches the port trains on."""

    def __init__(self, loader):
        self._it = iter(loader)

    def __iter__(self):
        return self._it


def _one_stream(trainer_class):
    class OneStream(trainer_class):
        @classmethod
        def build_train_loader(cls, cfg):
            return _OneStream(super().build_train_loader(cfg))

    return OneStream


def _same_losses(want, got, tol=1e-4):
    assert [m["iteration"] for m in want] == [m["iteration"] for m in got] == list(range(ITERS))
    for w, g in zip(want[1:], got[1:]):
        losses = sorted(k for k in w if k.startswith("loss") or k == "total_loss")
        assert losses == sorted(k for k in g if k.startswith("loss") or k == "total_loss")
        for k in losses:
            assert np.isfinite(w[k]) and _rel(w[k], g[k]) <= tol, (w["iteration"], k, w[k], g[k])
    return losses


# -- Mask R-CNN through both DefaultTrainers ---------------------------------------


def _mrcnn_cfg(jax_side, out, weights):
    cfg = _fpn_tiny(jax_get_cfg())
    cfg.MODEL.MASK_ON = True
    cfg.MODEL.BACKBONE.FREEZE_AT = 2
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 80
    # 64x64 buckets: 1023 anchors for 1024 RPN slots; 32 proposals and 4
    # ground-truth rows for the 36 ROI slots
    cfg.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 1024
    cfg.MODEL.RPN.POSITIVE_FRACTION = 1.0
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 36
    cfg.MODEL.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.TPU.MAX_GT_INSTANCES = 4
    cfg.TPU.IMAGE_BUCKETS = [[64, 64]]
    cfg.INPUT.MIN_SIZE_TRAIN = (48, 56, 64)
    cfg.INPUT.MAX_SIZE_TRAIN = 64
    cfg.DATASETS.TRAIN = (COCO_NAME,)
    cfg.SOLVER.IMS_PER_BATCH = 2
    cfg.SOLVER.BASE_LR = 0.002
    cfg.SOLVER.WARMUP_ITERS = 2
    cfg.SOLVER.STEPS = (3,)
    cfg.SOLVER.MAX_ITER = ITERS
    cfg.SOLVER.CHECKPOINT_PERIOD = 2
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 5.0
    cfg.MODEL.WEIGHTS = weights
    cfg.OUTPUT_DIR = out
    cfg.SEED = 42
    if jax_side:
        return cfg
    port = get_cfg()
    port.merge_from_other_cfg(cfg)
    return port


@pytest.fixture(scope="module")
def mrcnn_runs(trees, tmp_path_factory):
    """Both trainers for ITERS iterations from one .pth of the JAX
    trainer's initialisation; returns the output directories and the
    weights."""
    tmp = tmp_path_factory.mktemp("mrcnn_runs")
    weights = str(tmp / "init.pth")
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jc = _mrcnn_cfg(True, out["jax"], weights)
    jax_seed_all_rng(jc.SEED)
    with jax.default_matmul_precision("highest"):
        jt = _one_stream(JaxDefaultTrainer)(jc)
        variables = jax.tree_util.tree_map(np.asarray, jt._trainer.state_variables())
        torch.save({"model": variables_to_state_dict(variables)}, weights)
        jt.resume_or_load(resume=False)
        _write_every_iteration(jt, jax_hooks)
        jt.train()
    pt = DefaultTrainer(_mrcnn_cfg(False, out["port"], weights), device="cpu")
    pt.resume_or_load(resume=False)
    _write_every_iteration(pt, hooks)
    pt.train()
    return dict(out, weights=weights, trainer=pt)


def test_mask_rcnn_trainer_losses_and_lr_match_jax(mrcnn_runs):
    want = _metrics(os.path.join(mrcnn_runs["jax"], "metrics.json"))
    got = _metrics(os.path.join(mrcnn_runs["port"], "metrics.json"))
    losses = _same_losses(want, got)
    assert {"loss_cls", "loss_box_reg", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"} <= set(losses)
    for w, g in zip(want, got):
        assert abs(w["lr"] - g["lr"]) <= 2 * np.spacing(np.float32(g["lr"])), (w["iteration"], w["lr"], g["lr"])
    assert len({m["lr"] for m in got}) == 4  # two warmup rates, the base rate, the milestone


def test_mask_rcnn_checkpoints_and_resume(mrcnn_runs, tmp_path):
    """The trainer wrote model_0000001, model_0000003 and model_final with
    last_checkpoint; a fresh trainer resumed from model_0000003 holds its
    parameters, momentum buffers, generator state and update count, and
    takes the last iteration at the uninterrupted run's learning rate."""
    out = mrcnn_runs["port"]
    assert sorted(f for f in os.listdir(out) if f.endswith(".pth")) == [
        "model_0000001.pth", "model_0000003.pth", "model_final.pth"]
    assert open(os.path.join(out, "last_checkpoint")).read() == "model_final.pth"
    saved = torch.load(os.path.join(out, "model_0000003.pth"), weights_only=False)
    assert saved["iteration"] == 3 and saved["trainer"]["step"] == 4
    resume_dir = str(tmp_path / "resume")
    os.makedirs(resume_dir)
    torch.save(saved, os.path.join(resume_dir, "model_0000003.pth"))
    with open(os.path.join(resume_dir, "last_checkpoint"), "w") as f:
        f.write("model_0000003.pth")
    t = DefaultTrainer(_mrcnn_cfg(False, resume_dir, mrcnn_runs["weights"]), device="cpu")
    t.resume_or_load(resume=True)
    _write_every_iteration(t, hooks)
    assert t.start_iter == 4 and t.state.step == 4
    for k, v in t.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert torch.equal(t.state.generator.get_state(), saved["trainer"]["generator"])
    opt = t.optimizer.state_dict()
    assert len(opt["state"]) == len(saved["optimizer"]["state"]) > 50
    for i, s in saved["optimizer"]["state"].items():
        assert torch.equal(opt["state"][i]["momentum_buffer"], s["momentum_buffer"])
    t.train()
    got = _metrics(os.path.join(resume_dir, "metrics.json"))
    full = _metrics(os.path.join(out, "metrics.json"))
    assert [m["iteration"] for m in got] == [ITERS - 1]
    assert got[0]["lr"] == full[ITERS - 1]["lr"]  # the schedule goes on at the update count


def test_cli_trains_resumes_and_the_jax_cli_scores_its_weights(trees, tmp_path, caplog):
    """The port's command line (``tools.train_net.main``, in this process)
    trains the gate (its committed weights, 2 iterations at a small rate)
    and writes model_final.pth; ``--resume`` goes on from last_checkpoint;
    then its ``--eval-only`` and the JAX package's (``tools/train_net.py``)
    score that file on the tree: every bbox and segm number equal, as the
    JAX command prints them (4 decimals)."""
    from jtsm_tpu_torch.tools import train_net
    from tests.test_torch_scoring import _copypaste

    out = str(tmp_path / "train")
    data = ["DATASETS.TRAIN", f"('{COCO_NAME}',)", "DATASETS.TEST", f"('{COCO_NAME}',)"]
    common = ["--device", "cpu", "--config-file", MRCNN_EVAL_YAML, "MODEL.WEIGHTS", GATE_CKPT, "SOLVER.BASE_LR",
              "0.0002", "SOLVER.CHECKPOINT_PERIOD", "1", "OUTPUT_DIR", out] + data

    def cli(*argv):
        return train_net.main(train_net.argument_parser().parse_args(list(argv)))

    cli(*common, "SOLVER.MAX_ITER", "2")
    with caplog.at_level("INFO", logger="jtsm_tpu_torch.engine.trainer"):
        cli("--resume", *common, "SOLVER.MAX_ITER", "3")
    assert "Starting training from iteration 2" in caplog.text
    final = os.path.join(out, "model_final.pth")
    assert torch.load(final, weights_only=False)["iteration"] == 2
    assert [m["iteration"] for m in _metrics(os.path.join(out, "metrics.json"))] == [1, 2]
    score = ["--config-file", MRCNN_EVAL_YAML, "MODEL.WEIGHTS", final, "TEST.EXPECTED_RESULTS", "[]"]
    jax = subprocess.Popen([sys.executable, os.path.join(ROOT, "tools", "train_net.py"), "--eval-only", *score,
                            "OUTPUT_DIR", str(tmp_path / "jax")], cwd=ROOT, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True,
                           env=dict(os.environ, JTSM_DATASETS=trees, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu"))
    res = cli("--eval-only", "--device", "cpu", *score, "OUTPUT_DIR", str(tmp_path / "port"), *data)
    log = jax.communicate(timeout=900)[0]
    assert jax.returncode == 0, log[-3000:]
    got = {t: {k: float(f"{v:.4f}") for k, v in r.items() if "-" not in k} for t, r in res.items()}
    assert sorted(got) == ["bbox", "segm"] and got["bbox"]["AP"] > 30
    np.testing.assert_equal(got, _copypaste(log))


GATE_SEEDS = (42, 1, 2)


@pytest.mark.slow
def test_training_gate_beside_the_jax_run(trees, tmp_path):
    """The Mask R-CNN training gate as its yaml sets it (80 iterations from
    scratch, then ``--eval-only``) through the JAX CLI and the port's CLI at
    SEEDs 42, 1 and 2. The gate's pins do not reproduce on the JAX package
    here (ROADMAP §3), and the port draws its initialisation and sampling
    from torch's generators, so the runs spread; the test prints both
    packages' numbers. Measured on the CPU: JAX bbox 33.2618 / 37.9592 /
    44.7580 and segm 36.3201 / 38.7952 / 44.2024, the port bbox 39.0718 /
    38.6496 / 44.8110 and segm 40.5996 / 40.0385 / 44.2555 at SEEDs 42 / 1 /
    2 (mean bbox 38.6597 and 40.8441). Held: every run scores, and the
    port's mean bbox AP is at most 10 below the JAX package's."""
    env = dict(os.environ, JTSM_DATASETS=trees, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    from tests.test_torch_scoring import _copypaste

    def run(cmd):
        p = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=1800)
        assert p.returncode == 0, p.stdout[-3000:] + p.stderr[-3000:]
        return p.stdout

    def trained(cli, out, final, seed):
        run(cli + ["SEED", str(seed), "OUTPUT_DIR", out])
        return _copypaste(run(cli + ["--eval-only", "MODEL.WEIGHTS", os.path.join(out, final),
                                     "TEST.EXPECTED_RESULTS", "[]", "OUTPUT_DIR", out + "_eval"]))

    clis = {
        "jax": ([sys.executable, os.path.join(ROOT, "tools", "train_net.py"), "--config-file", MRCNN_TRAIN_YAML],
                "model_final.ckpt"),
        "port": ([sys.executable, "-m", "jtsm_tpu_torch.tools.train_net", "--device", "cpu", "--config-file",
                  MRCNN_TRAIN_YAML], "model_final.pth"),
    }
    res = {k: {seed: trained(cli, str(tmp_path / f"{k}_{seed}"), final, seed) for seed in GATE_SEEDS}
           for k, (cli, final) in clis.items()}
    mean = {}
    for k, runs in res.items():
        for seed, r in runs.items():
            print(f"{k} (SEED {seed}):", {t: r[t]["AP"] for t in ("bbox", "segm")})
            assert all(np.isfinite(r[t]["AP"]) for t in ("bbox", "segm"))
        mean[k] = np.mean([r["bbox"]["AP"] for r in runs.values()])
    print("mean bbox AP:", mean)
    assert mean["port"] >= mean["jax"] - 10, mean


# -- JTSM through both WSL trainers ---------------------------------------------------


def _jtsm_cfg(jax_side, trees, out):
    cfg = _jax_cfg(jtsm_gate_cfg()) if jax_side else jtsm_gate_cfg()
    cfg.merge_from_list([
        "DATASETS.TRAIN", f"('{PANOPTIC_NAME}_separated',)", "DATASETS.PROPOSAL_FILES_TRAIN",
        f"('{os.path.join(trees, 'cocovar', 'proposals_val2017_100.pkl')}',)",
        "MODEL.WEIGHTS", JTSM_CKPT, "WSL.ITER_SIZE", "2", "SOLVER.MAX_ITER", str(ITERS),
        "SOLVER.CHECKPOINT_PERIOD", "100", "OUTPUT_DIR", out, "TEST.EXPECTED_RESULTS", "[]",
        # a solver under which each fault of the accumulation moves the
        # updates: the mini-batches' gradient norms (215 and 146, then 210
        # and 60 on this tree) lie above the clip and their means' (133,
        # then 108) below it, so a clip of each mini-batch or of their sum
        # acts where the clip of the mean does not; the warmup spans the 2
        # updates, so a schedule counted in mini-batches takes other rates;
        # momentum carries into the second update
        "SOLVER.BASE_LR", "0.001", "SOLVER.WARMUP_ITERS", "2", "SOLVER.WARMUP_FACTOR", "0.5",
        "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "175.0",
    ])
    return cfg


KEPT = ("start", 0, 1, 3)  # before training, after the first mini-batch, after each update


def _keep_params(trainer, to_state_dict, hook):
    """Registers a hook that keeps the parameters at KEPT."""
    kept = {}

    def after_step(tr):
        if tr.iter in KEPT:
            kept[tr.iter] = to_state_dict()

    trainer.register_hooks([hook(before_train=lambda tr: kept.update(start=to_state_dict()), after_step=after_step)])
    return kept


class _PortCallback(hooks.HookBase):
    def __init__(self, before_train, after_step):
        self._before_train, self._after_step = before_train, after_step

    def before_train(self):
        self._before_train(self.trainer)

    def after_step(self):
        self._after_step(self.trainer)


def _flat(params, names):
    return np.concatenate([np.asarray(params[n], np.float64).ravel() for n in names])


def test_jtsm_trainer_iter_size_matches_jax(trees, tmp_path):
    """The JTSM gate config, ITER_SIZE 2, from the gate weights, against
    the JAX package's optax.MultiSteps: each mini-batch's losses and logged
    learning rate agree, the parameters do not move after the first
    mini-batch of an update, and each update (the parameters' change
    across it, an L2 norm of 0.066 and 0.13) agrees with the JAX package's:
    the first within 1e-4 of its norm (measured 8.2e-6), the second within
    1e-2 (measured 1.5e-3: the mining meets near-ties, so the
    trajectories part once the parameters differ in their last bits; at
    unchanged parameters, BASE_LR 0, that mini-batch's gradients agree
    within 2e-5). Faults planted in the accumulation, each caught
    (the first and second update's difference): the sum of the gradients
    for their mean (0.32, 0.49), a clip of each mini-batch (0.15, 0.15),
    the schedule counted in mini-batches (0.50, 0.54), no update (1, 1),
    and momentum and weight decay applied at each mini-batch (9.4e-5,
    0.069; the losses stay within 3.4e-6 of JAX's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("jax_wsl_train_net", os.path.join(ROOT, "projects/WSL/tools/train_net.py"))
    jax_wsl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_wsl)
    from jtsm_tpu_torch.wsl.train_net import Trainer

    class JaxTrainer(_one_stream(jax_wsl.Trainer)):
        @classmethod
        def build_model(cls, cfg):
            m = super().build_model(cfg)
            return m.clone(roi_heads=m.roi_heads.clone(dan_dropout=0.0))

    jc = _jtsm_cfg(True, trees, str(tmp_path / "jax"))
    jax_seed_all_rng(jc.SEED)
    with jax.default_matmul_precision("highest"):
        jt = JaxTrainer(jc)
        jt.resume_or_load(resume=False)
        _write_every_iteration(jt, jax_hooks)
        want = _keep_params(
            jt, lambda: variables_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": jt.state.params})),
            jax_hooks.CallbackHook)
        jt.train()
    pt = Trainer(_jtsm_cfg(False, trees, str(tmp_path / "port")), device="cpu")
    pt.resume_or_load(resume=False)
    pt.model.roi_heads.dan.dropout = 0.0
    _write_every_iteration(pt, hooks)
    got = _keep_params(pt, lambda: {n: p.detach().numpy().copy() for n, p in pt.model.named_parameters()},
                       _PortCallback)
    pt.train()
    assert sorted(want, key=str) == sorted(got, key=str) == sorted(KEPT, key=str)
    names = sorted(got["start"])
    assert all(np.array_equal(got["start"][n], got[0][n]) for n in names)
    assert all(np.array_equal(got["start"][n], want["start"][n].numpy()) for n in names)
    jm, gm = _metrics(str(tmp_path / "jax" / "metrics.json")), _metrics(str(tmp_path / "port" / "metrics.json"))
    _same_losses(jm, gm)
    for w, g in zip(jm, gm):
        assert abs(w["lr"] - g["lr"]) <= 2 * np.spacing(np.float32(g["lr"])), (w["iteration"], w["lr"], g["lr"])
    for a, b, tol in (("start", 1, 1e-4), (1, 3, 1e-2)):
        dw = _flat(want[b], names) - _flat(want[a], names)
        dg = _flat(got[b], names) - _flat(got[a], names)
        err = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        print(f"update at iteration {b}: norm {np.linalg.norm(dw):.4g}, port against JAX {err:.3g}")
        assert err <= tol, (b, err)
    assert pt.state.step == 2


# -- initialisation ------------------------------------------------------------------


@pytest.mark.parametrize("which", ["mask_rcnn", "jtsm"])
def test_initialisation_follows_the_jax_package(which, request):
    """A model built from scratch draws each parameter from the JAX
    package's initialiser for it (the tiny FPN Mask R-CNN with masks, and
    the JTSM gate): the same zero biases, and for every kernel of at least
    1000 elements a standard deviation within 10% of the JAX package's
    initial one and a largest magnitude within 25% (which tells a
    truncated normal, a normal and a uniform apart)."""
    import jax.numpy as jnp

    from tests.test_torch_jtsm_train import _gate_train_batch

    if which == "mask_rcnn":  # the JAX trainer's initial weights
        jc = _mrcnn_cfg(True, "", "")
        want = torch.load(request.getfixturevalue("mrcnn_runs")["weights"], weights_only=False)["model"]
    else:
        jc = _jax_cfg(jtsm_gate_cfg())
        batch = {k: jnp.asarray(v) for k, v in _gate_train_batch().items()}
        jm = jax_build_model(jc)
        rngs = {"params": jax.random.key(0), "sampling": jax.random.key(1), "dropout": jax.random.key(2)}
        want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, jax.jit(
            lambda: jm.init(rngs, batch, train=True))()))
    cfg = wsl_cfg() if which == "jtsm" else get_cfg()
    cfg.merge_from_other_cfg(jc)
    torch.manual_seed(0)
    got = build_model(cfg, device="cpu").state_dict()
    assert sorted(want) == sorted(got)
    compared = 0
    for k, w in want.items():
        w, g = w.numpy().astype(np.float64), got[k].numpy().astype(np.float64)
        if not w.any():
            assert not g.any(), k
        elif w.size >= 1000:
            assert abs(g.std() / w.std() - 1) <= 0.10, (k, g.std(), w.std())
            assert abs(np.abs(g).max() / np.abs(w).max() - 1) <= 0.25, (k, np.abs(g).max(), np.abs(w).max())
            compared += 1
    assert compared >= (20 if which == "mask_rcnn" else 12)


# -- checkpoint formats ----------------------------------------------------------------

C2_NAMES = ["conv1_w", "res_conv1_bn_s", "res_conv1_bn_b", "res2_0_branch1_w", "res2_0_branch1_bn_s",
            "res2_0_branch2a_w", "res2_0_branch2a_bn_rm", "res2_0_branch2a_bn_riv", "res3_1_branch2c_bn_b",
            "res5_2_branch2b_w", "fc1000_w", "fc1000_b", "bbox_pred_w", "cls_score_b", "res4_5_branch2b_bn_gamma",
            "res4_5_branch2b_bn_beta", "res4_5_branch2b_bn_running_mean", "res4_5_branch2b_bn_running_var",
            "res2_0_branch2a_w_momentum"]


def test_c2_names_equal_jax():
    weights = {k: np.zeros(1) for k in C2_NAMES}
    want, got = jax_convert_c2(weights), convert_c2_detectron_names(weights)
    assert sorted(want) == sorted(got) and "res2.0.conv1.weight" in got and "stem.conv1.weight" in got


def _c2_name(d2_name):
    """The Caffe2 zoo name of an ImageNet backbone's detectron2 name."""
    name = d2_name.replace("stem.conv1.norm.", "res_conv1_bn.").replace("stem.conv1.", "conv1.")
    m = re.match(r"^res(\d)\.(\d+)\.(conv[123]|shortcut)\.(.*)$", name)
    if m:
        stage, block, conv, rest = m.groups()
        branch = "branch1" if conv == "shortcut" else "branch2" + "abc"[int(conv[-1]) - 1]
        name = f"res{stage}_{block}_{branch}.{rest}"
    for d2, c2 in ((".norm.weight", "_bn_s"), (".norm.bias", "_bn_b"), (".norm.running_mean", "_bn_rm"),
                   (".norm.running_var", "_bn_riv"), ("_bn.weight", "_bn_s"), ("_bn.bias", "_bn_b"),
                   ("_bn.running_mean", "_bn_rm"), ("_bn.running_var", "_bn_riv"), (".weight", "_w"),
                   (".bias", "_b")):
        if name.endswith(d2):
            return name[: -len(d2)] + c2
    return name


@pytest.mark.parametrize("fmt", ["detectron2", "caffe2_backbone"])
def test_pkl_loads_the_same_weights_as_jax(fmt, tmp_path):
    """A zoo ``.pkl`` written from the Mask R-CNN gate fixture: in
    detectron2's format every tensor, in Caffe2's ImageNet form the
    backbone's (renamed, put under ``backbone.bottom_up``); the port loads
    what the JAX package loads, and nothing else moves."""
    state = variables_to_state_dict(load_gate_ckpt(GATE_CKPT))
    if fmt == "detectron2":
        blob = {"model": {k: v.numpy() for k, v in state.items()}, "__author__": "detectron2"}
    else:
        prefix = "backbone.bottom_up."
        blob = {_c2_name(k[len(prefix):]): v.numpy() for k, v in state.items() if k.startswith(prefix)}
        blob["fc1000_w"] = np.zeros((10, 4), np.float32)
    path = str(tmp_path / "weights.pkl")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    cfg = mask_rcnn_gate_cfg()
    model = build_model(cfg, device="cpu")
    before = {k: v.clone() for k, v in model.state_dict().items()}
    DetectionCheckpointer(model).load(path)
    jc = jax_get_cfg()
    jc.merge_from_other_cfg(cfg)
    jm = jax_build_model(jc)
    template = jax.eval_shape(lambda: jm.init({"params": jax.random.key(0), "sampling": jax.random.key(0)},
                                              _gate_input(), train=False))
    template = jax.tree_util.tree_map(lambda s: np.full(s.shape, 7.0, s.dtype), template)
    want = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, jax_align(template, path)))
    got = model.state_dict()
    loaded = 0
    for k, w in want.items():
        if (w == 7.0).all():  # the JAX package left it at the template
            assert torch.equal(got[k], before[k]), k
        else:
            assert torch.equal(got[k], w), k
            loaded += 1
    assert loaded == (len(state) if fmt == "detectron2" else sum(k.startswith("backbone.bottom_up.") for k in state)
                      - 4)  # Caffe2's res_conv1_bn_* stay unmatched, in both packages (ROADMAP §3)


def _gate_input():
    return {"image": np.zeros((1, 128, 176, 3), np.float32), "image_sizes": np.array([[128, 176]], np.int32),
            "orig_sizes": np.array([[128, 176]], np.int32)}


def test_jax_ckpt_and_load_weights_formats(tmp_path):
    """The JAX package's ``.ckpt`` (its optimizer state pickled beside the
    variables) loads to the gate's weights, as do the fixture's
    ``.ckpt.gz`` and the port's own ``.pth``, through the command line's
    ``load_weights``; formats it does not know raise."""
    import optax

    from jtsm_tpu_torch.tools.train_net import load_weights

    with gzip.open(GATE_CKPT, "rb") as f:
        data = pickle.load(f)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), data["variables"]["params"])
    data["opt_state"] = jax.tree_util.tree_map(np.asarray, optax.sgd(0.1, momentum=0.9).init(params))
    ckpt = str(tmp_path / "model_final.ckpt")
    with open(ckpt, "wb") as f:
        pickle.dump(data, f)
    want = variables_to_state_dict(load_gate_ckpt(GATE_CKPT))
    pth = str(tmp_path / "model.pth")
    torch.save({"model": want, "iteration": 3}, pth)
    for path in (ckpt, GATE_CKPT, pth):
        model = build_model(mask_rcnn_gate_cfg(), device="cpu")
        load_weights(model, path)
        for k, v in model.state_dict().items():
            assert torch.equal(v, want[k]), (path, k)
    with pytest.raises(Exception):
        load_weights(build_model(mask_rcnn_gate_cfg(), device="cpu"), str(tmp_path / "missing.pth"))


def test_tta_wrappers_run_on_the_card_unless_asked():
    """The test-time augmentation wrappers take the port's default device,
    the card, as its other entry points do."""
    import inspect

    from jtsm_tpu_torch.modeling.test_time_augmentation import TTAWrapperBase

    assert inspect.signature(TTAWrapperBase.__init__).parameters["device"].default == "cuda"
