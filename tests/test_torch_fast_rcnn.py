"""Fast R-CNN (MODEL.PROPOSAL_GENERATOR ``PrecomputedProposals``) in the port
held against the JAX package on the CPU:

* the narrow model (``fast_rcnn_R_50_FPN_cfg(narrow=True)``) on a batch's
  ``proposals`` and ``proposal_scores`` (the second image's last four slots
  unused, -inf), seeded weights on both sides: serving detections, the train
  step's losses (no RPN losses) and every gradient, at the tolerances of
  ``tests/test_torch_cascade.py`` (measured: boxes 1.5e-5 px, scores
  1.4e-6, losses 1.8e-7, gradients 1.2e-6), and its bf16 losses (7.2e-5);
* the port's core command ``--eval-only`` beside the JAX package's (its
  command with the proposal slots in the batch it initialises on) on the
  Mask R-CNN gate's synthetic COCO set (``dev/make_synthetic_coco.py
  --num 8``) with the gate's committed weights (without the RPN and
  the mask head, as a ``.pth`` both commands read), the masks off and the
  proposals read from a pickle written here (each image's ground truth
  boxes jittered, and random boxes, 64 an image): every bbox number equal
  within 1e-4 (measured equal, AP 65.7554), in the manner of
  ``tests/test_torch_c4_cli.py``.
"""

import json
import os
import pickle
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
from jtsm_tpu_torch.config import fast_rcnn_R_50_FPN_cfg
from tests.test_torch_cascade import batch_of, check_bf16_losses, check_model, deterministic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE_YAML = os.path.join(ROOT, "configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml")
TOL_AP = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def proposal_batch(cfg, seed):
    """``batch_of`` with 16 proposal slots an image: the ground truth boxes
    jittered by 4 px, then boxes of 16-80 px inside the image; the second
    image's last four slots unused (-inf)."""
    batch = batch_of(cfg, seed=seed)
    rng = np.random.default_rng(seed)
    k = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN
    props = np.zeros((2, k, 4), np.float32)
    for i, (h, w) in enumerate(batch["image_sizes"]):
        g = batch["gt_boxes"][i]
        jit = g + rng.normal(0, 4, g.shape)
        xy = rng.uniform(0, [w - 80, h - 80], (k - len(g), 2))
        rand = np.concatenate([xy, xy + rng.uniform(16, 80, (k - len(g), 2))], 1)
        props[i] = np.clip(np.concatenate([jit, rand]), 0, [w, h, w, h])
    scores = np.sort(rng.normal(size=(2, k)), axis=1)[:, ::-1].astype(np.float32)
    scores[1, -4:] = -np.inf
    batch["proposals"], batch["proposal_scores"] = props, np.ascontiguousarray(scores)
    return batch


def test_fast_rcnn_serves_and_trains_on_batch_proposals_as_jax():
    cfg = deterministic(fast_rcnn_R_50_FPN_cfg(narrow=True))
    losses, tm = check_model(cfg, proposal_batch(cfg, 3), seed=3)
    assert sorted(losses) == ["loss_box_reg", "loss_cls"]
    assert tm.proposal_generator is None


def test_fast_rcnn_bf16_losses_as_jax():
    cfg = deterministic(fast_rcnn_R_50_FPN_cfg(narrow=True))
    check_bf16_losses(cfg, proposal_batch(cfg, 4), seed=4)


def test_fast_rcnn_needs_the_batch_proposals():
    from jtsm_tpu_torch.modeling import build_model

    cfg = fast_rcnn_R_50_FPN_cfg(narrow=True)
    model = build_model(cfg, device="cpu")
    batch = proposal_batch(cfg, 5)
    del batch["proposals"]
    with pytest.raises(ValueError, match="PrecomputedProposals: the batch has no proposals"):
        model.inference(batch)


def _copypaste(log):
    lines = [ln.split("copypaste: ", 1)[1] for ln in log.splitlines() if "copypaste: " in ln]
    tasks = {}
    for i, ln in enumerate(lines):
        m = re.match(r"Task: (\w+)", ln)
        if m:
            tasks[m.group(1)] = dict(zip(lines[i + 1].split(","), map(float, lines[i + 2].split(","))))
    return tasks


def write_proposals(ann_file, path, per_image=64, seed=0):
    """A detectron2 proposal pickle for the images of ``ann_file``: each
    ground truth box jittered 3 times (3 px), then random boxes, XYXY in the
    image's pixels, with descending objectness logits."""
    coco = json.load(open(ann_file))
    rng = np.random.default_rng(seed)
    by_image = {}
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        by_image.setdefault(a["image_id"], []).append([x, y, x + w, y + h])
    ids, boxes, logits = [], [], []
    for img in coco["images"]:
        gt = np.asarray(by_image.get(img["id"], np.zeros((0, 4))), np.float64).reshape(-1, 4)
        jit = np.concatenate([gt + rng.normal(0, 3, gt.shape) for _ in range(3)])[:per_image]
        n = per_image - len(jit)
        xy = rng.uniform(0, [img["width"] * 0.7, img["height"] * 0.7], (n, 2))
        rand = np.concatenate([xy, xy + rng.uniform(16, 0.3 * min(img["width"], img["height"]), (n, 2))], 1)
        b = np.clip(np.concatenate([jit, rand]), 0, [img["width"], img["height"]] * 2).astype(np.float32)
        ids.append(img["id"])
        boxes.append(b)
        logits.append(np.sort(rng.uniform(size=len(b)))[::-1].astype(np.float32))
    with open(path, "wb") as f:
        pickle.dump({"ids": ids, "boxes": boxes, "objectness_logits": logits, "bbox_mode": 0}, f)


# The JAX package's ``tools/train_net.py --eval-only`` with one change: the
# batch it initialises the model on carries PRECOMPUTED_PROPOSAL_TOPK_TEST
# unused proposal slots. Its own initialises without them and stops with a
# KeyError under PrecomputedProposals (ROADMAP §3).
JAX_EVAL_ONLY = """
import json, os, sys
import jax, jax.numpy as jnp
from jtsm_tpu.checkpoint import DetectionCheckpointer
from jtsm_tpu.config import get_cfg
from jtsm_tpu.engine import DefaultTrainer
from jtsm_tpu.modeling import build_model
cfg = get_cfg()
cfg.merge_from_file(sys.argv[1])
cfg.merge_from_list(sys.argv[2:])
os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
model = build_model(cfg)
bh, bw = (max(b[i] for b in cfg.TPU.IMAGE_BUCKETS) for i in (0, 1))
k = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
dummy = {"image": jnp.zeros((1, bh, bw, 3)), "image_sizes": jnp.asarray([[bh, bw]], jnp.int32),
         "orig_sizes": jnp.asarray([[bh, bw]], jnp.int32), "proposals": jnp.zeros((1, k, 4)),
         "proposal_scores": jnp.full((1, k), -jnp.inf)}
variables = jax.jit(lambda r: model.init({"params": r, "sampling": r}, dummy, train=False))(jax.random.key(0))
checkpointer = DetectionCheckpointer(dict(variables), cfg.OUTPUT_DIR)
checkpointer.resume_or_load(cfg.MODEL.WEIGHTS, resume=False)
res = DefaultTrainer.test(cfg, model, variables=checkpointer.variables)
print("RESULTS " + json.dumps({t: dict(m) for t, m in res.items()}))
"""


def test_eval_only_cli_equals_the_jax_package(tmp_path):
    """The port's core command ``--eval-only`` on the gate's synthetic set
    as a Fast R-CNN (the gate's weights, MASK_ON False,
    PrecomputedProposals over a written pickle) beside the JAX package's
    (``JAX_EVAL_ONLY``): the same bbox numbers."""
    root = tmp_path / "datasets"
    subprocess.run([sys.executable, os.path.join(ROOT, "dev", "make_synthetic_coco.py"), "--root", str(root),
                    "--num", "8", "--num-varied", "1"], check=True, capture_output=True, cwd=ROOT)
    pkl = tmp_path / "proposals.pkl"
    write_proposals(root / "coco" / "annotations" / "instances_val2017_100.json", pkl)
    weights = tmp_path / "fast_rcnn_gate.pth"  # the gate's weights without its RPN and mask head
    state = variables_to_state_dict(load_gate_ckpt(os.path.join(ROOT, "tests/fixtures/gate_ckpts/mask_rcnn.ckpt.gz")))
    torch.save({k: v for k, v in state.items() if not k.startswith(("proposal_generator.", "roi_heads.mask_head."))},
               weights)
    opts = ["MODEL.WEIGHTS", str(weights), "MODEL.MASK_ON", "False", "MODEL.LOAD_PROPOSALS", "True",
            "MODEL.PROPOSAL_GENERATOR.NAME", "PrecomputedProposals", "DATASETS.PROPOSAL_FILES_TEST", f"('{pkl}',)",
            "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "64", "TEST.EXPECTED_RESULTS", "[]"]
    env = dict(os.environ, JTSM_DATASETS=str(root), PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    commands = {
        "port": [sys.executable, "-m", "jtsm_tpu_torch.tools.train_net", "--eval-only", "--device", "cpu",
                 "--config-file", GATE_YAML, *opts, "OUTPUT_DIR", str(tmp_path / "port")],
        "jax": [sys.executable, "-c", JAX_EVAL_ONLY, GATE_YAML, *opts, "OUTPUT_DIR", str(tmp_path / "jax")],
    }
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, c in commands.items()}
    logs = {k: p.communicate(timeout=600)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, (k, logs[k][-4000:])
    want = json.loads([ln for ln in logs["jax"].splitlines() if ln.startswith("RESULTS ")][-1][len("RESULTS "):])
    want = {t: {m: float("nan") if v is None else v for m, v in ms.items()} for t, ms in want.items()}
    got = _copypaste(logs["port"])
    assert sorted(got) == sorted(want) == ["bbox"]
    assert len(got["bbox"]) == 12 and got["bbox"]["AP"] > 10
    print("bbox", got["bbox"])
    for metric, value in want["bbox"].items():
        assert abs(got["bbox"][metric] - value) <= TOL_AP or (np.isnan(value) and np.isnan(got["bbox"][metric])), (
            metric, got["bbox"][metric], value)
