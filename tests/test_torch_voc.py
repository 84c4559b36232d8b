"""Pascal VOC detection in the port held against the JAX package on the
CPU: ``load_voc_instances``, ``PascalVOCDetectionEvaluator`` (AP and
CorLoc), the WSL loaders over a detectron2 proposal pickle, PCL under
TEST.AUG, and the port's command line; with the helpers of the WSOD
slice's acceptance test (``tests/test_torch_wsod_cli.py``): the port's WSL
command and the JAX package's (``projects/WSL/tools/train_net.py``)
``--eval-only`` side by side, on a VOC tree that the test writes (``data.datasets.synthetic_voc``:
8 seeded scenes of 96x128 with difficult objects, JPEGs, XML annotations,
``ImageSets/Main``, 64 proposals an image), with the same random weights
(the port's ``random_state_dict`` written as ``.pth``, which the JAX
command loads through its detectron2-name converter), for WSDDN, OICR and
PCL on WSR-18 DC5 and OICR on VGG16 DC5 (their narrow configurations), and
OICR with TEST.AUG (one short side and its flip). Every number equal
within 1e-4, and every detection the evaluators see: image, class and
score within 1e-4, box within 1e-3 px.

The JAX test loader casts each image id to int64 (``jtsm_tpu/data/
build.py:272``), so that VOC's "000005" reaches its evaluator as 5 and
misses its ground truth: without TEST.AUG the JAX command scores every VOC
set 0 (``tests/test_torch_wsod_cli.py``; ROADMAP §3). The
port keeps the string ids. For the side-by-side numbers the JAX evaluator
is given the string ids back (its ``process`` maps each integer to its
zero-padded file id). The commands run in this process (the JAX command's
``main`` through importlib, as ``tests/test_torch_trainer.py`` loads it),
and the port's once more as ``python -m jtsm_tpu_torch.wsl.train_net``.
"""

import importlib.util
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data.datasets.pascal_voc import load_voc_instances as jax_load_voc_instances
from jtsm_tpu.data.datasets.pascal_voc import register_pascal_voc as jax_register_pascal_voc
from jtsm_tpu.engine import default_argument_parser
from jtsm_tpu.evaluation import pascal_voc_evaluation as jax_voc
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu.wsl import add_wsl_config
from jtsm_tpu.wsl.data import build_wsl_test_loader as jax_wsl_test_loader
from jtsm_tpu.wsl.data import build_wsl_train_loader as jax_wsl_train_loader
from jtsm_tpu_torch.checkpoint import random_state_dict
from jtsm_tpu_torch.config import wsod_V_16_narrow_cfg, wsod_WSR_18_narrow_cfg
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data.datasets import load_voc_instances, register_pascal_voc
from jtsm_tpu_torch.data.datasets.synthetic_voc import write_synthetic_voc
from jtsm_tpu_torch.evaluation import PascalVOCDetectionEvaluator
from jtsm_tpu_torch.evaluation import pascal_voc_evaluation as port_voc
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.tools.train_net import argument_parser
from jtsm_tpu_torch.wsl import train_net as port_cli
from jtsm_tpu_torch.wsl.data import build_wsl_test_loader, build_wsl_train_loader
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_train_loader import _assert_same, _first_batches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "voc_2007_synthetic_test"
NAME_2012 = "voc_2012_synthetic_test"
TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """The VOC tree and its proposal pickle, registered in both packages as
    a 2007 and a 2012 set."""
    root = str(tmp_path_factory.mktemp("voc"))
    pkl = write_synthetic_voc(root, num=8, seed=0, image_hw=(96, 128), num_proposals=64)
    voc = os.path.join(root, "VOC2007")
    for name, year in ((NAME, 2007), (NAME_2012, 2012)):
        register_pascal_voc(name, voc, "test", year)
        jax_register_pascal_voc(name, voc, "test", year)
    yield {"root": root, "voc": voc, "pkl": pkl}
    for catalog in (JaxDatasetCatalog, JaxMetadataCatalog, DatasetCatalog, MetadataCatalog):
        for name in (NAME, NAME_2012):
            if name in catalog:
                catalog.remove(name)


# -- the dataset and the evaluator -------------------------------------------------


def test_load_voc_instances_equals_jax(tree):
    want = jax_load_voc_instances(tree["voc"], "test")
    got = load_voc_instances(tree["voc"], "test")
    assert len(got) == 8 and got == want
    assert all(isinstance(d["image_id"], str) for d in got)
    anns = [a for d in got for a in d["annotations"]]
    assert any(a["difficult"] for a in anns) and not all(a["difficult"] for a in anns)
    meta = MetadataCatalog.get(NAME)
    assert (meta.dirname, meta.split, meta.year, meta.evaluator_type) == (tree["voc"], "test", 2007, "pascal_voc")


def _crafted_detections(seed):
    """Per image of the tree: copies of its boxes (jittered, some exact,
    some duplicated, difficult ones included) with random classes now and
    then, and boxes off every object, scored at random with ties."""
    rng = np.random.RandomState(seed)
    records = DatasetCatalog.get(NAME)
    d = 24
    out = {"boxes": np.zeros((len(records), d, 4), np.float32), "scores": np.zeros((len(records), d), np.float32),
           "classes": np.zeros((len(records), d), np.int32), "valid": np.zeros((len(records), d), bool)}
    for i, r in enumerate(records):
        k = 0
        for a in r["annotations"]:
            box = np.asarray(a["bbox"], np.float32)
            size = np.array([box[2] - box[0], box[3] - box[1]] * 2, np.float32)
            for j in range(4):
                jitter = 0 if j == 0 else rng.randn(4) * size * 0.08 * j
                out["boxes"][i, k] = box + jitter
                out["classes"][i, k] = a["category_id"] if rng.rand() < 0.8 else rng.randint(20)
                k += 1
        for _ in range(4):
            xy = rng.rand(2) * [100, 70]
            out["boxes"][i, k] = np.concatenate([xy, xy + 20])
            out["classes"][i, k] = rng.randint(20)
            k += 1
        out["scores"][i, :k] = np.round(rng.rand(k), 2)
        out["valid"][i, :k] = True
    return [r["image_id"] for r in records], out


@pytest.mark.parametrize("name", [NAME, NAME_2012])
@pytest.mark.parametrize("seed", [0, 1])
def test_voc_evaluator_equals_jax(tree, name, seed):
    """AP (the 11-point metric for 2007, the interpolated area for 2012) and
    CorLoc over IoU 0.50:0.05:0.95 of crafted detections: equal to the JAX
    evaluator's, fed two images at a time."""
    ids, out = _crafted_detections(seed)
    want_eval, got_eval = jax_voc.PascalVOCDetectionEvaluator(name), PascalVOCDetectionEvaluator(name)
    for e in (want_eval, got_eval):
        e.reset()
        for a in range(0, len(ids), 2):
            e.process({"image_ids": np.asarray(ids[a:a + 2])}, {k: v[a:a + 2] for k, v in out.items()})
    want, got = want_eval.evaluate(), got_eval.evaluate()
    assert want == got
    assert 0 < got["bbox"]["AP"] < 100 and 0 < got["bbox CorLoc"]["CL50"] < 100, got


def test_voc_class_functions_equal_jax():
    """``voc_eval_class`` and ``voc_eval_corloc_class`` on their own: a
    difficult match, a duplicate, an image without the class and one whose
    boxes of it are all difficult."""
    gts = {"a": {"bbox": [[0, 0, 10, 10], [20, 20, 30, 30]], "difficult": [False, True]},
           "b": {"bbox": [], "difficult": []},
           "c": {"bbox": [[5, 5, 15, 15]], "difficult": [True]},
           "d": {"bbox": [[0, 0, 8, 8]], "difficult": [False]}}
    dets = [{"image_id": "a", "bbox": [0, 0, 10, 10], "score": 0.9},
            {"image_id": "a", "bbox": [0, 0, 10, 11], "score": 0.8},
            {"image_id": "a", "bbox": [20, 20, 30, 30], "score": 0.7},
            {"image_id": "b", "bbox": [0, 0, 5, 5], "score": 0.95},
            {"image_id": "c", "bbox": [5, 5, 15, 15], "score": 0.99},
            {"image_id": "d", "bbox": [4, 4, 12, 12], "score": 0.6},
            {"image_id": "d", "bbox": [0, 0, 8, 8], "score": 0.5}]
    for thresh in (0.5, 0.75):
        for use_07 in (True, False):
            w, g = jax_voc.voc_eval_class(dets, gts, thresh, use_07), port_voc.voc_eval_class(dets, gts, thresh, use_07)
            for a, b in zip(w, g):
                np.testing.assert_array_equal(a, b)
        assert jax_voc.voc_eval_corloc_class(dets, gts, thresh) == port_voc.voc_eval_corloc_class(dets, gts, thresh)
    assert port_voc.voc_eval_corloc_class(dets, gts, 0.5) == 0.5


# -- the WSL loaders over a detectron2 proposal pickle -----------------------------


def _loader_cfgs(tree, opts=()):
    pc = wsod_WSR_18_narrow_cfg("OICRROIHeads")
    pc.merge_from_list(["DATASETS.TRAIN", f"('{NAME}',)", "DATASETS.TEST", f"('{NAME}',)",
                        "DATASETS.PROPOSAL_FILES_TRAIN", f"('{tree['pkl']}',)",
                        "DATASETS.PROPOSAL_FILES_TEST", f"('{tree['pkl']}',)", *opts])
    jc = jax_get_cfg()
    add_wsl_config(jc)
    jc.merge_from_other_cfg(pc)
    return jc, pc


def _without_ids(batches):
    return [{k: v for k, v in b.items() if k != "image_ids"} for b in batches]


def test_proposal_pickle_through_both_wsl_loaders(tree):
    """A plain detectron2 proposal pickle (ids, boxes, objectness_logits,
    bbox_mode: no superpixels) through ``build_wsl_test_loader`` and
    ``build_wsl_train_loader`` (two short sides and the flip): every batch
    equal to the JAX package's, key for key, but for the image ids, which
    the port keeps as VOC's strings."""
    jc, pc = _loader_cfgs(tree, ["INPUT.MIN_SIZE_TRAIN", "(112, 128)"])
    want = list(jax_wsl_test_loader(jc, NAME))
    got = list(build_wsl_test_loader(pc, NAME))
    assert len(got) == 8
    _assert_same(_without_ids(want), _without_ids(got))
    assert [str(i) for b in got for i in b["image_ids"]] == [f"{n:06d}" for n in range(1, 9)]
    assert [int(i) for b in want for i in b["image_ids"]] == list(range(1, 9))
    assert {"proposals", "proposal_scores"} <= set(got[0]) and not {"superpixels", "oh_labels"} & set(got[0])
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_wsl_train_loader(jc), 4)
    got = _first_batches(build_wsl_train_loader(pc), 4)
    _assert_same(_without_ids(want), _without_ids(got))
    assert {"gt_classes", "gt_valid", "proposals"} <= set(got[0])


# -- the acceptance test: both commands side by side -----------------------------------

CONFIGS = {
    "wsddn": (wsod_WSR_18_narrow_cfg, "WSDDNROIHeads", False),
    "oicr": (wsod_WSR_18_narrow_cfg, "OICRROIHeads", False),
    "pcl": (wsod_WSR_18_narrow_cfg, "PCLROIHeads", False),
    "vgg_oicr": (wsod_V_16_narrow_cfg, "OICRROIHeads", False),
    "oicr_tta": (wsod_WSR_18_narrow_cfg, "OICRROIHeads", True),
}
# the TTA case's views: one short side and its flip (the JAX command
# compiles a pass for each bucket that a view lands in)
TTA_OPTS = ["TEST.AUG.MIN_SIZES", "(128,)"]


@pytest.fixture(scope="module")
def jax_cli():
    spec = importlib.util.spec_from_file_location("jax_wsl_train_net", os.path.join(ROOT, "projects/WSL/tools/train_net.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _command_files(tree, tmp, case, seed):
    """The case's configuration as a yaml file and its random weights as a
    ``.pth``; the command line's KEY VALUE pairs."""
    fn, head, aug = CONFIGS[case]
    cfg = fn(head)
    cfg.merge_from_list(["DATASETS.TRAIN", f"('{NAME}',)", "DATASETS.TEST", f"('{NAME}',)",
                         "DATASETS.PROPOSAL_FILES_TRAIN", f"('{tree['pkl']}',)",
                         "DATASETS.PROPOSAL_FILES_TEST", f"('{tree['pkl']}',)"])
    weights = os.path.join(tmp, f"{case}.pth")
    torch.manual_seed(0)
    torch.save({"model": random_state_dict(build_model(cfg, device="cpu"), seed=seed)}, weights)
    yaml = os.path.join(tmp, f"{case}.yaml")
    with open(yaml, "w") as f:
        f.write(_jax_cfg(cfg).dump())
    return yaml, ["MODEL.WEIGHTS", weights, *TTA_OPTS, "TEST.AUG.ENABLED", str(aug)]


class _Recorded:
    """Wraps an evaluator class's ``evaluate`` to keep what it was fed."""

    def __init__(self, cls):
        self.cls, self.seen = cls, []

    def __enter__(self):
        self.orig = self.cls.evaluate
        seen = self.seen

        def evaluate(ev):
            seen.append({c: list(p) for c, p in ev._predictions.items()})
            return self.orig(ev)

        self.cls.evaluate = evaluate
        return self

    def __exit__(self, *exc):
        self.cls.evaluate = self.orig


def _string_ids_for_jax(monkeypatch):
    """The JAX evaluator given back the string ids its loader cast."""
    orig = jax_voc.PascalVOCDetectionEvaluator.process

    def process(ev, inputs, outputs):
        ids = [i if isinstance(i, str) else f"{int(i):06d}" for i in inputs["image_ids"]]
        return orig(ev, dict(inputs, image_ids=np.asarray(ids)), outputs)

    monkeypatch.setattr(jax_voc.PascalVOCDetectionEvaluator, "process", process)


def _run_both(jax_cli, yaml, opts, tmp):
    with _Recorded(PascalVOCDetectionEvaluator) as port_rec:
        got = port_cli.main(argument_parser().parse_args(
            ["--eval-only", "--device", "cpu", "--config-file", yaml, "OUTPUT_DIR", os.path.join(tmp, "port"), *opts]))
    with _Recorded(jax_voc.PascalVOCDetectionEvaluator) as jax_rec, jax.default_matmul_precision("highest"):
        want = jax_cli.main(default_argument_parser().parse_args(
            ["--eval-only", "--config-file", yaml, "OUTPUT_DIR", os.path.join(tmp, "jax"), *opts]))
    return want, got, jax_rec.seen, port_rec.seen


def _same_numbers(want, got):
    assert sorted(want) == sorted(got) == ["bbox", "bbox CorLoc"]
    for task in want:
        assert sorted(want[task]) == sorted(got[task])
        for k in want[task]:
            assert abs(want[task][k] - got[task][k]) <= TOL, (task, k, want[task][k], got[task][k])


def _same_detections(want, got):
    assert len(want) == len(got) == 1 and sorted(want[0]) == sorted(got[0])
    n = 0
    for c in want[0]:
        w = sorted(want[0][c], key=lambda d: (d["image_id"], -d["score"]))
        g = sorted(got[0][c], key=lambda d: (d["image_id"], -d["score"]))
        assert len(w) == len(g), c
        for a, b in zip(w, g):
            assert a["image_id"] == b["image_id"] and abs(a["score"] - b["score"]) <= TOL, (c, a, b)
            assert np.abs(np.subtract(a["bbox"], b["bbox"])).max() <= 1e-3, (c, a, b)
        n += len(w)
    return n


def test_pcl_with_tta_fails_in_both_commands(tree, jax_cli, tmp_path):
    """``pcl_WSR_18_DC5_1x.yaml`` enables TEST.AUG through its base, and
    PCL returns no per-proposal class scores for TTA-AVG to average: the
    JAX command fails with a KeyError, the port's with a ValueError that
    says so (ROADMAP §3)."""
    yaml, opts = _command_files(tree, str(tmp_path), "pcl", seed=0)
    opts[-1] = "True"
    with pytest.raises(ValueError, match="proposal_class_scores"):
        port_cli.main(argument_parser().parse_args(
            ["--eval-only", "--device", "cpu", "--config-file", yaml, "OUTPUT_DIR", str(tmp_path / "port"), *opts]))
    with pytest.raises(KeyError, match="proposal_class_scores"):
        jax_cli.main(default_argument_parser().parse_args(
            ["--eval-only", "--config-file", yaml, "OUTPUT_DIR", str(tmp_path / "jax"), *opts]))


def test_port_command_line_prints_the_numbers(tree, tmp_path):
    """``python -m jtsm_tpu_torch.wsl.train_net --eval-only --device cpu``
    on the builtin ``voc_2007_test`` under ``$JTSM_DATASETS`` prints the
    in-process run's numbers in its copypaste lines."""
    yaml, opts = _command_files(tree, str(tmp_path), "oicr", seed=sorted(CONFIGS).index("oicr"))
    want = port_cli.main(argument_parser().parse_args(
        ["--eval-only", "--device", "cpu", "--config-file", yaml, "OUTPUT_DIR", str(tmp_path / "a"), *opts]))
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2", JTSM_DATASETS=tree["root"])
    proc = subprocess.run([sys.executable, "-m", "jtsm_tpu_torch.wsl.train_net", "--eval-only", "--device", "cpu",
                           "--config-file", yaml, "OUTPUT_DIR", str(tmp_path / "b"), *opts,
                           "DATASETS.TEST", "('voc_2007_test',)"],
                          cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [ln.split("copypaste: ", 1)[1] for ln in (proc.stdout + proc.stderr).splitlines() if "copypaste: " in ln]
    printed = {}
    for i, ln in enumerate(lines):
        m = re.match(r"Task: (.+)$", ln)
        if m:
            printed[m.group(1)] = dict(zip(lines[i + 1].split(","), map(float, lines[i + 2].split(","))))
    assert sorted(printed) == ["bbox", "bbox CorLoc"]
    for task in want:
        for k, v in want[task].items():
            assert abs(printed[task][k] - v) <= 5e-5, (task, k)
