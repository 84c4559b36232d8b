"""The port's scoring slice end to end on the CPU: ``python -m
jtsm_tpu_torch.tools.train_net --eval-only --device cpu`` on the gate
config over the synthetic COCO tree that ``dev/make_synthetic_coco.py
--num 8`` writes, beside the JAX package's ``tools/train_net.py
--eval-only`` on the same tree.

The port must reproduce the gate's pins (bbox AP 63.5662, segm AP 64.9523,
each within 0.02: the config's TEST.EXPECTED_RESULTS, which
``verify_results`` checks), and its COCO result list must be the JAX
package's: the same detections in the same order, boxes within 1e-3 px,
scores within 1e-4 (float32 on both sides, different summation orders),
masks equal.
"""

import json
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
GATE_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml")
PINS = {"bbox": (63.5662, 0.02), "segm": (64.9523, 0.02)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One run of each command, read by every test here."""
    tmp = tmp_path_factory.mktemp("scoring")
    root = tmp / "datasets"
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8", "--num-varied", "1"], check=True, capture_output=True, cwd=ROOT)
    env = dict(os.environ, JTSM_DATASETS=str(root), PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    commands = {
        "port": [sys.executable, "-m", "jtsm_tpu_torch.tools.train_net", "--eval-only", "--device", "cpu",
                 "--config-file", GATE_YAML, "OUTPUT_DIR", str(tmp / "port")],
        "jax": [sys.executable, os.path.join(ROOT, "tools", "train_net.py"), "--eval-only",
                "--config-file", GATE_YAML, "OUTPUT_DIR", str(tmp / "jax")],
    }
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, c in commands.items()}
    out = {}
    for k, p in procs.items():
        text = p.communicate(timeout=900)[0]
        results = os.path.join(str(tmp / k), "inference", "coco_instances_results.json")
        out[k] = {"rc": p.returncode, "log": text,
                  "results": json.load(open(results)) if os.path.exists(results) else None}
    return out


def _copypaste(log):
    """{task: {metric: value}} from the ``copypaste:`` lines."""
    lines = [ln.split("copypaste: ", 1)[1] for ln in log.splitlines() if "copypaste: " in ln]
    tasks = {}
    for i, ln in enumerate(lines):
        m = re.match(r"Task: (\w+)", ln)
        if m:
            tasks[m.group(1)] = dict(zip(lines[i + 1].split(","), map(float, lines[i + 2].split(","))))
    return tasks


def test_port_scores_the_gate_pins(runs):
    port = runs["port"]
    assert port["rc"] == 0, port["log"][-4000:]
    assert "Results verification passed." in port["log"]
    stats = _copypaste(port["log"])
    for task, (pin, tol) in PINS.items():
        assert abs(stats[task]["AP"] - pin) <= tol, (task, stats[task]["AP"])
    assert len(stats["bbox"]) == len(stats["segm"]) == 12


def test_port_numbers_equal_the_jax_package(runs):
    assert runs["jax"]["rc"] == 0, runs["jax"]["log"][-4000:]
    want, got = _copypaste(runs["jax"]["log"]), _copypaste(runs["port"]["log"])
    np.testing.assert_equal(got, want)  # all 12 numbers of each task, nan where JAX has nan


def test_port_result_list_matches_the_jax_package(runs):
    want, got = runs["jax"]["results"], runs["port"]["results"]
    assert got is not None and want is not None
    assert len(got) == len(want) > 20
    for g, w in zip(got, want):
        assert (g["image_id"], g["category_id"]) == (w["image_id"], w["category_id"])
        np.testing.assert_allclose(g["bbox"], w["bbox"], rtol=0, atol=1e-3)
        assert abs(g["score"] - w["score"]) <= 1e-4
        assert g["segmentation"] == w["segmentation"]


def test_cli_without_eval_only_names_what_is_missing():
    """Without --eval-only the command trains (tests/test_torch_trainer.py);
    a train option that is not ported yet stops it with its name."""
    proc = subprocess.run([sys.executable, "-m", "jtsm_tpu_torch.tools.train_net", "--device", "cpu",
                           "--config-file", GATE_YAML, "MODEL.ANCHOR_GENERATOR.NAME", "RotatedAnchorGenerator"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode != 0
    assert "anchor generator 'RotatedAnchorGenerator' is not ported yet" in proc.stderr


def test_bf16_outputs_reach_the_paste_in_float32():
    """In TPU.COMPUTE_DTYPE bfloat16 the boxes, scores and masks leave the
    model in float32."""
    import torch

    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.data.datasets.synthetic import make_synthetic_coco
    from jtsm_tpu_torch.data.transforms import ResizeTransform
    from jtsm_tpu_torch.modeling import build_model

    cfg = mask_rcnn_gate_cfg()
    cfg.TPU.COMPUTE_DTYPE = "bfloat16"
    model = build_model(cfg, device="cpu")
    model.load_state_dict(variables_to_state_dict(load_gate_ckpt(os.path.join(ROOT, cfg.MODEL.WEIGHTS))))
    _, images = make_synthetic_coco(1, 0)
    img = images[0][:, :, ::-1]
    h, w = img.shape[:2]
    small = ResizeTransform(h, w, 128, int(w * 128 / h + 0.5)).apply_image(img).astype(np.float32)
    batch = {"image": np.zeros((1, 128, 176, 3), np.float32), "image_sizes": np.array([small.shape[:2]], np.int32),
             "orig_sizes": np.array([[h, w]], np.int32)}
    batch["image"][0, :, : small.shape[1]] = small
    out = model.inference(batch)
    assert model.compute_dtype == torch.bfloat16
    assert {k: out[k].dtype for k in ("boxes", "scores", "masks")} == dict.fromkeys(("boxes", "scores", "masks"),
                                                                                    torch.float32)
    assert int(out["valid"].sum()) > 0
