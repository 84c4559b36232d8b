"""OICR through both WSL trainers and both commands: the case of
``tests/test_torch_wsod_train.py`` (its docstring sets it out) for
``OICRROIHeads``."""

from tests.test_torch_voc import _two_torch_threads, jax_cli, tree  # noqa: F401  (the fixtures)
from tests.test_torch_wsod_train import _jax_dan_without_dropout, train_and_score  # noqa: F401


def test_oicr_trainers_match_and_both_commands_score_the_result(tree, jax_cli, tmp_path, monkeypatch):
    train_and_score("OICRROIHeads", tree, jax_cli, tmp_path, monkeypatch)
