"""The port's command line scores the inference gates of the other core
meta-architectures on the CPU: ``python -m jtsm_tpu_torch.tools.train_net
--eval-only --device cpu`` on each ``configs/quick_schedules/
<family>_R_18_synthetic_inference_acc_test.yaml`` over the synthetic COCO
tree of ``dev/make_synthetic_coco.py --num 8``, with its committed fixture
weights.

Each run must print "Results verification passed." (the config's
TEST.EXPECTED_RESULTS, ±0.02) and each pinned number within 5e-5: the JAX
package's own number to the pin's four decimals. Slow: the JAX package's
``tools/train_net.py --eval-only`` beside it, every number of each result
dict equal.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch


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
PINS = {
    "panoptic_fpn": {("bbox", "AP"): 21.5726, ("segm", "AP"): 21.6414, ("sem_seg", "mIoU"): 53.4529,
                     ("panoptic_seg", "PQ"): 21.9175},
    "retinanet": {("bbox", "AP"): 38.2114},
    "rpn": {("box_proposals", "AR@1000"): 52.3810},
    "keypoint_rcnn": {("bbox", "AP"): 6.3899, ("keypoints", "AP"): 10.3519},
}
TOL_PIN = 5e-5


def _yaml(family):
    return os.path.join(ROOT, "configs", "quick_schedules", f"{family}_R_18_synthetic_inference_acc_test.yaml")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("gates") / "datasets"
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8", "--num-varied", "1"], check=True, capture_output=True, cwd=ROOT,
                   env=dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=ROOT))
    return root


def _run(commands, root, tmp):
    """Each command (name -> argv + OUTPUT_DIR under ``tmp``) at once, two
    intra-op threads each; {name: (return code, log)}."""
    env = dict(os.environ, JTSM_DATASETS=str(root), PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    procs = {k: subprocess.Popen(c + ["OUTPUT_DIR", str(tmp / k)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True) for k, c in commands.items()}
    return {k: (p.wait(timeout=900), p.stdout.read()) for k, p in procs.items()}


def _port(family):
    return [sys.executable, "-m", "jtsm_tpu_torch.tools.train_net", "--eval-only", "--device", "cpu",
            "--config-file", _yaml(family)]


@pytest.fixture(scope="module")
def port_runs(tree, tmp_path_factory):
    """The port's four gate runs, side by side."""
    return _run({f: _port(f) for f in PINS}, tree, tmp_path_factory.mktemp("port"))


def _copypaste(log):
    """{task: {metric: value}} from the ``copypaste:`` lines."""
    lines = [ln.split("copypaste: ", 1)[1] for ln in log.splitlines() if "copypaste: " in ln]
    tasks = {}
    for i, ln in enumerate(lines):
        m = re.match(r"Task: (\w+)", ln)
        if m:
            tasks[m.group(1)] = dict(zip(lines[i + 1].split(","), map(float, lines[i + 2].split(","))))
    return tasks


@pytest.mark.parametrize("family", sorted(PINS))
def test_port_cli_reproduces_the_gate_pins(port_runs, family):
    rc, log = port_runs[family]
    assert rc == 0, log[-4000:]
    assert "Results verification passed." in log
    stats = _copypaste(log)
    for (task, metric), pin in PINS[family].items():
        assert abs(stats[task][metric] - pin) <= TOL_PIN, (task, metric, stats[task][metric], pin)


@pytest.mark.slow
def test_port_cli_results_equal_the_jax_cli(tree, tmp_path):
    """Every number of each gate's result dict equal to the JAX CLI's."""
    jax_cli = [sys.executable, os.path.join(ROOT, "tools", "train_net.py"), "--eval-only", "--config-file"]
    commands = {}
    for f in PINS:
        commands[f"port_{f}"] = _port(f)
        commands[f"jax_{f}"] = jax_cli + [_yaml(f)]
    runs = _run(commands, tree, tmp_path)
    for f in PINS:
        for side in ("port", "jax"):
            assert runs[f"{side}_{f}"][0] == 0, runs[f"{side}_{f}"][1][-4000:]
        np.testing.assert_equal(_copypaste(runs[f"port_{f}"][1]), _copypaste(runs[f"jax_{f}"][1]))
