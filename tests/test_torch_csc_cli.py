"""CSC on VGG16 (``csc_V_16_DC5_1x.yaml``, narrow:
``csc_V_16_DC5_cfg(narrow=True)``) through both WSL trainers and both
commands, the case of ``tests/test_torch_wsod_train.py`` (its docstring sets
it out) with the class-peak-gradient pass before each step until
WSL.CSC_MAX_ITER 2 of the 5 mini-batches: ``loss_cls_pos`` and
``loss_cls_neg`` for mini-batches 0-2, the plain ``loss_mil`` after them, on
both sides (metrics.json puts a mini-batch's losses on the next line; the
updates measured 3.4e-4 of their norm from JAX's, the losses 2.6e-7; the
gate shuts every map at these random weights, so the maps are zero on both
sides and the CSC weights 1). Then UWSOD's train loaders: with its yaml's MODEL.LOAD_PROPOSALS and no
DATASETS.PROPOSAL_FILES_TRAIN both packages' loaders fail alike; with
LOAD_PROPOSALS False both load, and the port's model takes a train step on
the batch."""

import pytest
import torch

import jtsm_tpu.wsl  # noqa: F401  (registers the WSL modules)
from jtsm_tpu.wsl import data as jax_wsl_data
from jtsm_tpu.wsl.modeling import wsjds as jax_wsjds
from jtsm_tpu_torch.config import csc_V_16_DC5_cfg, uwsod_V_16_DC5_cfg
from jtsm_tpu_torch.engine import create_train_state, make_train_step
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer
from jtsm_tpu_torch.wsl.data import build_wsl_train_loader
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_voc import NAME, _two_torch_threads, jax_cli, tree  # noqa: F401  (the fixtures)
from tests.test_torch_wsod_train import _jax_dan_without_dropout, train_and_score  # noqa: F401

CSC_MAX_ITER = 2


@pytest.fixture(autouse=True)
def _jax_wsjds_dan_without_dropout(_jax_dan_without_dropout, monkeypatch):
    from jtsm_tpu.wsl.modeling import roi_heads_wsl as jax_rhw

    monkeypatch.setattr(jax_wsjds, "DiscriminativeAdaptionNeck", jax_rhw.DiscriminativeAdaptionNeck)


def test_csc_trainers_match_across_csc_max_iter_and_both_commands_score(tree, jax_cli, tmp_path, monkeypatch):
    def narrow():
        cfg = csc_V_16_DC5_cfg(narrow=True)
        cfg.WSL.CSC_MAX_ITER = CSC_MAX_ITER
        return cfg

    def expected(line):
        return {"loss_cls_pos", "loss_cls_neg"} if line - 1 <= CSC_MAX_ITER else {"loss_mil"}

    train_and_score("CSCROIHeads", tree, jax_cli, tmp_path, monkeypatch, narrow=narrow, expected=expected)


def test_uwsod_loaders_without_proposal_files(tree):
    cfg = uwsod_V_16_DC5_cfg(narrow=True)
    cfg.DATASETS.TRAIN = (NAME,)
    assert cfg.MODEL.LOAD_PROPOSALS and cfg.DATASETS.PROPOSAL_FILES_TRAIN == ()
    with pytest.raises(AssertionError):
        build_wsl_train_loader(cfg)
    with pytest.raises(AssertionError):
        jax_wsl_data.build_wsl_train_loader(_jax_cfg(cfg))
    cfg.MODEL.LOAD_PROPOSALS = False
    batch = next(iter(build_wsl_train_loader(cfg)))
    want = next(iter(jax_wsl_data.build_wsl_train_loader(_jax_cfg(cfg))))
    assert "proposals" not in batch and "proposals" not in want
    assert sorted(batch) == sorted(want)
    model = build_model(cfg, device="cpu")
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    metrics = make_train_step(model, optimizer, build_lr_schedule(cfg))(
        state, {k: v for k, v in batch.items() if k != "image_ids"})
    assert {"loss_rpn_cls", "loss_rpn_loc", "loss_mil"} <= set(metrics)
    assert all(torch.isfinite(v) for v in metrics.values()) and state.step == 1
