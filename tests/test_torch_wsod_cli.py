"""The acceptance test of the WSOD slice: the port's WSL command and the
JAX package's ``--eval-only`` side by side on the VOC tree of
``tests/test_torch_voc.py`` (its docstring sets out the cases, the weights
and the tolerances), and the JAX command's loss of VOC's string image ids
without TEST.AUG (ROADMAP §3)."""

import pytest

from tests.test_torch_voc import (  # noqa: F401  (the fixtures)
    CONFIGS,
    _command_files,
    _run_both,
    _same_detections,
    _same_numbers,
    _string_ids_for_jax,
    _two_torch_threads,
    jax_cli,
    tree,
)


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_both_commands_score_the_same(tree, jax_cli, tmp_path, monkeypatch, case):
    _string_ids_for_jax(monkeypatch)
    yaml, opts = _command_files(tree, str(tmp_path), case, seed=sorted(CONFIGS).index(case))
    want, got, want_seen, got_seen = _run_both(jax_cli, yaml, opts, str(tmp_path))
    print(case, got)
    _same_numbers(want, got)
    assert _same_detections(want_seen, got_seen) > 100
    assert got["bbox"]["AP50"] > 0


def test_jax_command_loses_voc_ids_without_tta(tree, jax_cli, tmp_path):
    """Unpatched, the JAX command scores the VOC set 0 without TEST.AUG: its
    detections carry integer ids that match no ground truth. The port's
    does not (ROADMAP §3)."""
    yaml, opts = _command_files(tree, str(tmp_path), "wsddn", seed=4)
    want, got, want_seen, got_seen = _run_both(jax_cli, yaml, opts, str(tmp_path))
    assert all(v == 0 for task in want.values() for v in task.values()), want
    assert got["bbox"]["AP50"] > 0
    assert all(isinstance(d["image_id"], int) for p in want_seen[0].values() for d in p)


