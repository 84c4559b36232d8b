"""CMIL (``cmil_WSR_18_DC5_1x.yaml``, narrow: ``cmil_WSR_18_DC5_cfg(narrow=
True)``) through both WSL trainers and both commands: the case of
``tests/test_torch_wsod_train.py`` (its docstring sets it out: each
mini-batch's losses within 1e-4 relative, each update within 1e-3 of its
norm, then both commands' ``--eval-only`` on the port's
``model_final.pth``, the JAX evaluator given VOC's string ids back) for
``CMILROIHeads``: its merges at lambda 1.0 (no caller passes an
iteration, in either package) and ROILabel's supervision."""

from jtsm_tpu_torch.config import cmil_WSR_18_DC5_cfg
from tests.test_torch_voc import _two_torch_threads, jax_cli, tree  # noqa: F401  (the fixtures)
from tests.test_torch_wsod_train import _jax_dan_without_dropout, train_and_score  # noqa: F401


def test_cmil_trainers_match_and_both_commands_score_the_result(tree, jax_cli, tmp_path, monkeypatch):
    train_and_score("CMILROIHeads", tree, jax_cli, tmp_path, monkeypatch, narrow=lambda: cmil_WSR_18_DC5_cfg(narrow=True))
