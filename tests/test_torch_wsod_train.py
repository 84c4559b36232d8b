"""The WSOD baselines trained through both WSL trainers on the CPU (WSDDN
here; OICR and PCL in ``tests/test_torch_wsod_train_oicr.py`` and
``tests/test_torch_wsod_train_pcl.py``, one file each for the parallel
test run's sake, since each JAX trainer compiles its step for about 20 s): the
narrow WSR-18 configurations of WSDDN, OICR and PCL
(``config.wsod_WSR_18_narrow_cfg``) on the VOC tree of
``tests/test_torch_voc.py`` with its detectron2 proposal pickle, from the
same random weights (a ``.pth`` of the port's ``random_state_dict``),
WSL.ITER_SIZE 2 over 5 mini-batches, the DAN's dropout off on both sides
(``tests/test_torch_wsod.py`` sets out how), the JAX trainer given one
loader stream (``tests/test_torch_trainer.py::_OneStream``, ROADMAP §3).

Each mini-batch's losses in the two ``metrics.json`` agree within 1e-4
relative (at most 3.5e-5, float32 on both sides); the parameters do not
move after the first mini-batch of an update, and each of the 2 updates
(the parameters' change across it, L2 norms 0.0018-0.016) agrees with the
JAX package's optax step within 1e-3 of its norm (at most 1.2e-4: the
random weights' large gradients round differently in the two
frameworks). Faults planted in the port's accumulation, each caught by
both checks (update errors; losses' worst relative difference): the
first update skipped (1.0; 0.20-8.1), the sum of the mini-batches'
gradients for their mean (1.0; 0.035-4.0), the schedule one update ahead
(0.50; 0.015-1.5). Both commands' ``--eval-only`` then score the port's
``model_final.pth`` (the parameters of the last update) to the same numbers
(within 1e-4; the JAX evaluator given back VOC's string ids, as in
``tests/test_torch_wsod_cli.py``). The port runs on two threads, as the
trainer tests do."""

import functools
import os

import jax
import numpy as np
import pytest
import torch

from jtsm_tpu.engine import default_argument_parser
from jtsm_tpu.engine import hooks as jax_hooks
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw
from jtsm_tpu.wsl.modeling import wsod_zoo as jax_zoo
from jtsm_tpu_torch.checkpoint import random_state_dict, variables_to_state_dict
from jtsm_tpu_torch.config import wsod_WSR_18_narrow_cfg
from jtsm_tpu_torch.engine import hooks
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.tools.train_net import argument_parser
from jtsm_tpu_torch.wsl import train_net as port_cli
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_trainer import (
    ITERS,
    KEPT,
    _flat,
    _keep_params,
    _metrics,
    _one_stream,
    _PortCallback,
    _rel,
    _write_every_iteration,
)
from tests.test_torch_voc import (  # noqa: F401  (the fixtures)
    NAME,
    _same_numbers,
    _string_ids_for_jax,
    _two_torch_threads,
    jax_cli,
    tree,
)

TOL = 1e-4
UPDATE_TOL = 1e-3
# PCL's gradients are an order of magnitude smaller than WSDDN's and OICR's
# (L2 norms 35-260 against 700-2600 on this tree), so at 1e-5 its updates
# come near the float32 rounding of the parameters
BASE_LR = {"WSDDNROIHeads": "1e-5", "OICRROIHeads": "1e-5", "PCLROIHeads": "1e-4", "CMILROIHeads": "1e-5"}


@pytest.fixture(autouse=True)
def _jax_dan_without_dropout(monkeypatch):
    no_dropout = functools.partial(jax_rhw.DiscriminativeAdaptionNeck, dropout=0.0)
    monkeypatch.setattr(jax_rhw, "DiscriminativeAdaptionNeck", no_dropout)
    monkeypatch.setattr(jax_zoo, "DiscriminativeAdaptionNeck", no_dropout)


def _cfg(head, tree, weights, out, narrow=None):
    cfg = narrow() if narrow else wsod_WSR_18_narrow_cfg(head)
    cfg.merge_from_list([
        "DATASETS.TRAIN", f"('{NAME}',)", "DATASETS.PROPOSAL_FILES_TRAIN", f"('{tree['pkl']}',)",
        "DATASETS.TEST", f"('{NAME}',)", "DATASETS.PROPOSAL_FILES_TEST", f"('{tree['pkl']}',)",
        "MODEL.WEIGHTS", weights, "WSL.ITER_SIZE", "2", "SOLVER.MAX_ITER", str(ITERS),
        "SOLVER.CHECKPOINT_PERIOD", "100", "OUTPUT_DIR", out,
        # the WSR yamls' solver (no clip, decay 5e-4) with the biases
        # grouped as the JAX package groups them (ROADMAP §3; the bias rule
        # has its own test in tests/test_torch_wsod.py), at a rate under
        # which each update moves the next mini-batches' losses well past
        # the tolerance; the warmup spans the 2 updates, so a schedule
        # counted in mini-batches takes other rates; momentum carries into
        # the second update
        "SOLVER.CLIP_GRADIENTS.ENABLED", "False", "SOLVER.BIAS_LR_FACTOR", "1.0",
        "SOLVER.WEIGHT_DECAY_BIAS", "0.0005", "SOLVER.WEIGHT_DECAY", "0.0005",
        "SOLVER.BASE_LR", BASE_LR[head], "SOLVER.WARMUP_ITERS", "2", "SOLVER.WARMUP_FACTOR", "0.5",
    ])
    return cfg


def train_and_score(head, tree, jax_cli, tmp_path, monkeypatch, narrow=None):
    """Both trainers on ``head``'s narrow configuration (``narrow()``, by
    default ``wsod_WSR_18_narrow_cfg(head)``), then both commands on the
    port's ``model_final.pth`` (see the module docstring)."""
    weights = str(tmp_path / "init.pth")
    torch.manual_seed(0)
    first = narrow() if narrow else wsod_WSR_18_narrow_cfg(head)
    torch.save({"model": random_state_dict(build_model(first, device="cpu"), seed=1)}, weights)
    jc = _jax_cfg(_cfg(head, tree, weights, str(tmp_path / "jax"), narrow))
    jax_seed_all_rng(jc.SEED)
    with jax.default_matmul_precision("highest"):
        jt = _one_stream(jax_cli.Trainer)(jc)
        jt.resume_or_load(resume=False)
        _write_every_iteration(jt, jax_hooks)
        want_params = _keep_params(
            jt, lambda: variables_to_state_dict(jax.tree_util.tree_map(np.asarray, {"params": jt.state.params})),
            jax_hooks.CallbackHook)
        jt.train()
    pt = port_cli.Trainer(_cfg(head, tree, weights, str(tmp_path / "port"), narrow), device="cpu")
    pt.resume_or_load(resume=False)
    pt.model.roi_heads.dan.dropout = 0.0
    _write_every_iteration(pt, hooks)
    got_params = _keep_params(pt, lambda: {n: p.detach().numpy().copy() for n, p in pt.model.named_parameters()},
                              _PortCallback)
    pt.train()
    assert pt.state.step == ITERS // 2

    assert sorted(want_params, key=str) == sorted(got_params, key=str) == sorted(KEPT, key=str)
    names = sorted(got_params["start"])
    assert all(np.array_equal(got_params["start"][n], got_params[0][n]) for n in names)
    assert all(np.array_equal(got_params["start"][n], want_params["start"][n].numpy()) for n in names)
    for a, b in (("start", 1), (1, 3)):
        dw = _flat(want_params[b], names) - _flat(want_params[a], names)
        dg = _flat(got_params[b], names) - _flat(got_params[a], names)
        err = np.linalg.norm(dg - dw) / np.linalg.norm(dw)
        print(f"{head} update at iteration {b}: norm {np.linalg.norm(dw):.4g}, port against JAX {err:.3g}")
        assert err <= UPDATE_TOL, (b, err)

    want, got = _metrics(str(tmp_path / "jax" / "metrics.json")), _metrics(str(tmp_path / "port" / "metrics.json"))
    assert [m["iteration"] for m in want] == [m["iteration"] for m in got] == list(range(ITERS))
    expected = {"loss_mil"} | ({"loss_refine_cls0", "loss_refine_cls1"} if head != "WSDDNROIHeads" else set())
    worst = 0.0
    for w, g in zip(want[1:], got[1:]):
        losses = {k for k in w if k.startswith("loss")}
        assert losses == {k for k in g if k.startswith("loss")} == expected
        for k in sorted(losses) + ["total_loss"]:
            assert np.isfinite(w[k])
            worst = max(worst, _rel(w[k], g[k]))
    print(head, "losses", worst)
    assert worst <= TOL

    _string_ids_for_jax(monkeypatch)
    final = str(tmp_path / "port" / "model_final.pth")
    assert os.path.exists(final)
    yaml = str(tmp_path / "config.yaml")
    with open(yaml, "w") as f:
        f.write(jc.dump())
    args = ["--eval-only", "--config-file", yaml, "MODEL.WEIGHTS", final, "WSL.ITER_SIZE", "1"]
    scored = port_cli.main(argument_parser().parse_args(args[:1] + ["--device", "cpu"] + args[1:]
                                                         + ["OUTPUT_DIR", str(tmp_path / "score_port")]))
    with jax.default_matmul_precision("highest"):
        jax_scored = jax_cli.main(default_argument_parser().parse_args(args + ["OUTPUT_DIR", str(tmp_path / "score_jax")]))
    _same_numbers(jax_scored, scored)


def test_wsddn_trainers_match_and_both_commands_score_the_result(tree, jax_cli, tmp_path, monkeypatch):
    train_and_score("WSDDNROIHeads", tree, jax_cli, tmp_path, monkeypatch)
