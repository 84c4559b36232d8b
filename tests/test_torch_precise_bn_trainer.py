"""``DefaultTrainer`` on the tiny SyncBN Mask R-CNN with TEST.PRECISE_BN,
held against the JAX package's trainer on the CPU.

Both trainers run ``_mrcnn_cfg`` of ``tests/test_torch_trainer.py`` (the
dev tree, the parity regime, one ``.pth`` of the JAX initialisation,
batch statistics included) with SyncBN in the ResNet, the FPN and both
heads, PreciseBN every 2 iterations over 2 batches (the scoring hook
taken out of both), for 5 iterations; the JAX trainer is given one loader
stream (``_OneStream``), so PreciseBN reads the same batches on both
sides. Held: each iteration's losses within 1e-4 relative; every batch
norm's statistics after the run (two PreciseBN updates and the steps
between) within 1e-4 (the means of the activations' scale, the variances
of their own), the tolerance of the losses, since the statistics carry
every update's rounding as the losses do; the checkpoints hold the running
statistics, a resumed trainer starts from them, and the JAX package's
checkpointer loads the port's ``model_final.pth`` with its
``batch_stats``; TensorBoard's event files hold every scalar of
``metrics.json`` at its iteration.
"""

import os

import jax
import numpy as np
import pytest
import torch

from jtsm_tpu.checkpoint import DetectionCheckpointer as JaxDetectionCheckpointer
from jtsm_tpu.engine import DefaultTrainer as JaxDefaultTrainer
from jtsm_tpu.engine import hooks as jax_hooks
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu_torch.checkpoint import variables_to_state_dict
from jtsm_tpu_torch.engine import DefaultTrainer
from jtsm_tpu_torch.engine import hooks
from jtsm_tpu_torch.layers import batch_norms
from tests.test_torch_syncbn_train import stats_errors
from tests.test_torch_trainer import (  # noqa: F401  (the fixture)
    ITERS,
    _metrics,
    _mrcnn_cfg,
    _one_stream,
    _same_losses,
    _write_every_iteration,
    trees,
)

TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads_ieee_convolutions():
    """As in ``tests/test_torch_syncbn_train.py``: two threads, PyTorch's
    own CPU convolutions (oneDNN's lose digits under batch statistics)."""
    n, mkldnn = torch.get_num_threads(), torch.backends.mkldnn.enabled
    torch.set_num_threads(2)
    torch.backends.mkldnn.enabled = False
    yield
    torch.set_num_threads(n)
    torch.backends.mkldnn.enabled = mkldnn


def _cfg(jax_side, out, weights):
    cfg = _mrcnn_cfg(jax_side, out, weights)
    m = cfg.MODEL
    for node in (m.RESNETS, m.FPN, m.ROI_BOX_HEAD, m.ROI_MASK_HEAD):
        node.NORM = "SyncBN"
    m.ROI_BOX_HEAD.NUM_CONV = 2
    m.ROI_BOX_HEAD.CONV_DIM = 32
    cfg.TEST.PRECISE_BN.ENABLED = True
    cfg.TEST.PRECISE_BN.NUM_ITER = 2
    cfg.TEST.EVAL_PERIOD = 2
    return cfg


def _without_scoring(trainer, hook_module):
    trainer._hooks = [h for h in trainer._hooks if not isinstance(h, hook_module.EvalHook)]
    assert sum(isinstance(h, hook_module.PreciseBN) for h in trainer._hooks) == 1


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("precise_bn_runs")
    weights = str(tmp / "init.pth")
    out = {"jax": str(tmp / "jax"), "port": str(tmp / "port")}
    jc = _cfg(True, out["jax"], weights)
    jax_seed_all_rng(jc.SEED)
    with jax.default_matmul_precision("highest"):
        jt = _one_stream(JaxDefaultTrainer)(jc)
        variables = jax.tree_util.tree_map(np.asarray, jt._trainer.state_variables())
        assert "batch_stats" in variables
        torch.save({"model": variables_to_state_dict(variables)}, weights)
        jt.resume_or_load(resume=False)
        _write_every_iteration(jt, jax_hooks)
        _without_scoring(jt, jax_hooks)
        jt.train()
    pt = DefaultTrainer(_cfg(False, out["port"], weights), device="cpu")
    pt.resume_or_load(resume=False)
    _write_every_iteration(pt, hooks)
    _without_scoring(pt, hooks)
    calls = []
    update = pt._trainer.update_precise_bn
    pt._trainer.update_precise_bn = lambda n: (calls.append((pt.iter, n)), update(n))
    pt.train()
    return dict(out, weights=weights, jax_trainer=jt, trainer=pt, calls=calls,
                init=variables_to_state_dict(variables),
                jax_stats=variables_to_state_dict(
                    {"batch_stats": jax.tree_util.tree_map(np.asarray, jt._trainer.state.batch_stats)}))


def test_trainer_losses_and_precise_bn_statistics_match_jax(runs):
    _same_losses(_metrics(os.path.join(runs["jax"], "metrics.json")),
                 _metrics(os.path.join(runs["port"], "metrics.json")))
    assert runs["calls"] == [(1, 2), (3, 2)]
    got = runs["trainer"].model.state_dict()
    want = dict(runs["jax_stats"])
    assert len(want) == 2 * len(batch_norms(runs["trainer"].model)) > 60
    errs = stats_errors(want, got)
    assert max(max(e) for e in errs.values()) <= TOL, sorted(errs.items(), key=lambda x: -max(x[1]))[:3]
    for name in errs:  # every statistic moved, the frozen stem's too
        assert not torch.equal(runs["init"][f"{name}.running_var"], got[f"{name}.running_var"]), name


def test_checkpoints_keep_the_running_statistics_and_jax_loads_them(runs, tmp_path):
    pt = runs["trainer"]
    final = os.path.join(pt.cfg.OUTPUT_DIR, "model_final.pth")
    saved = torch.load(final, weights_only=False)
    model_state = pt.model.state_dict()
    stats = [k for k in saved["model"] if k.endswith(("running_mean", "running_var"))]
    assert len(stats) == len(runs["jax_stats"])
    for k in stats:
        assert torch.equal(saved["model"][k], model_state[k]), k
    # resume from model_0000003: the statistics come back
    mid = torch.load(os.path.join(pt.cfg.OUTPUT_DIR, "model_0000003.pth"), weights_only=False)
    resume_dir = str(tmp_path / "resume")
    os.makedirs(resume_dir)
    torch.save(mid, os.path.join(resume_dir, "model_0000003.pth"))
    with open(os.path.join(resume_dir, "last_checkpoint"), "w") as f:
        f.write("model_0000003.pth")
    t = DefaultTrainer(_cfg(False, resume_dir, runs["weights"]), device="cpu")
    t.resume_or_load(resume=True)
    assert t.start_iter == ITERS - 1
    for k in stats:
        assert torch.equal(t.model.state_dict()[k], mid["model"][k]), k
    t._trainer.close()
    # the JAX package's checkpointer reads the port's file, batch_stats too
    template = jax.tree_util.tree_map(np.asarray, runs["jax_trainer"]._trainer.state_variables())
    ck = JaxDetectionCheckpointer(template)
    ck.load(final)
    back = variables_to_state_dict(jax.tree_util.tree_map(np.asarray, ck.variables))
    for k in stats:
        np.testing.assert_array_equal(back[k].numpy(), saved["model"][k].numpy(), err_msg=k)


def test_tensorboard_events_hold_the_metrics(runs):
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    out = runs["port"]
    files = [f for f in os.listdir(out) if f.startswith("events.out.tfevents")]
    assert len(files) == 1
    acc = EventAccumulator(os.path.join(out, files[0]), size_guidance={"scalars": 0})
    acc.Reload()
    events = {tag: {e.step: e.value for e in acc.Scalars(tag)} for tag in acc.Tags()["scalars"]}
    lines = _metrics(os.path.join(out, "metrics.json"))
    count = 0
    for line in lines:
        it = line["iteration"]
        for k, v in line.items():
            if k == "iteration":
                continue
            assert events[k][it] == np.float32(v), (it, k)
            count += 1
    assert count >= 5 * len(lines) and {"loss_mask", "lr", "data_time", "total_loss"} <= set(events)
