"""The seven LVIS and Cityscapes yamls through the command lines on the CPU,
on tiny sets written here (``datasets.synthetic_lvis``,
``datasets.synthetic_cityscapes``) under ``$JTSM_DATASETS``:

* the port's core command trains each yaml for one iteration (narrow
  overrides, ``NARROW``: the Mask R-CNN gate's widths, sizes and buckets,
  its clipped solver; the X-101's 32 groups of width 1) from neutral
  weights (``_neutral_weights``) and scores the result with the yaml's
  evaluator;
* ``--eval-only`` of the LVIS v1 R50 yaml beside the JAX package's command
  on the Mask R-CNN gate's weights carried onto LVIS's classes
  (``checkpoint.select_class_rows``: COCO's 80 as LVIS 1-80), 30 detections
  an image: every number equal to 4 decimals (measured equal);
* Cityscapes: the JAX command cannot score a Cityscapes set (its test
  loader casts the string image ids to int64, ROADMAP §3), so the port's
  ``--eval-only`` (the gate's weights on Cityscapes' 8 classes, each the
  gate's class that the scenes paint it as) runs in process with the JAX
  package's ``CityscapesInstanceEvaluator`` given the same detections, as
  ``tests/test_torch_c4_cli.py`` does for VOC: equal numbers.

``-m slow``: each LVIS yaml's one-iteration weights also scored by both
commands (6 JAX runs, about 3 minutes).
"""

import copy
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.data.build import build_detection_test_loader as jax_test_loader
from jtsm_tpu.data.datasets.cityscapes import load_cityscapes_instances as jax_load_instances
from jtsm_tpu.evaluation import cityscapes_evaluation as jax_city
from jtsm_tpu_torch.checkpoint import load_gate_ckpt, select_class_rows, variables_to_state_dict
from jtsm_tpu_torch.config import get_cfg, mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg
from jtsm_tpu_torch.data.datasets.synthetic import COCO_80
from jtsm_tpu_torch.data.datasets.cityscapes import CITYSCAPES_THING_CLASSES
from jtsm_tpu_torch.data.datasets.synthetic_cityscapes import CITY_TO_COCO, write_synthetic_cityscapes
from jtsm_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
from jtsm_tpu_torch.evaluation import CityscapesInstanceEvaluator
from jtsm_tpu_torch.modeling import build_model
from tests.test_torch_lvis import _same_results

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GATE = os.path.join(ROOT, "tests/fixtures/gate_ckpts/mask_rcnn.ckpt.gz")
LVIS_YAMLS = [f"configs/LVISv{v}-InstanceSegmentation/mask_rcnn_{m}_FPN_1x.yaml"
              for v in ("1", "0.5") for m in ("R_50", "R_101", "X_101_32x8d")]
CITY_YAML = "configs/Cityscapes/mask_rcnn_R_50_FPN.yaml"


def _literal(v):
    return str(list(v)) if isinstance(v, (list, tuple)) else str(v)


def _gate_narrow():
    """The Mask R-CNN gate's model and input settings as command-line
    options (its differences from the flagship, without weights)."""
    base, gate = mask_rcnn_R_50_FPN_cfg().to_dict(), mask_rcnn_gate_cfg().to_dict()
    opts = []

    def walk(a, b, prefix):
        for k in sorted(b):
            if isinstance(b[k], dict):
                walk(a[k], b[k], prefix + k + ".")
            elif a[k] != b[k] and prefix.split(".")[0] in ("MODEL", "INPUT", "TPU") and k != "WEIGHTS":
                opts.extend([prefix + k, _literal(b[k])])

    walk(base, gate, "")
    return opts


# the gate's solver (its clip keeps the first step of an untrained model small)
NARROW = _gate_narrow() + ["SOLVER.IMS_PER_BATCH", "2", "DATALOADER.NUM_WORKERS", "0", "TEST.DETECTIONS_PER_IMAGE",
                           "30", "SOLVER.WARMUP_ITERS", "1", "TEST.EVAL_PERIOD", "0", "SOLVER.BASE_LR", "0.002",
                           "SOLVER.CLIP_GRADIENTS.ENABLED", "True", "SOLVER.CLIP_GRADIENTS.CLIP_TYPE", "norm",
                           "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", "5.0"]
EXTRA = {"X_101": ["MODEL.RESNETS.WIDTH_PER_GROUP", "1"]}


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """``lvis/lvis_v{1,0.5}_{train,val}.json`` over ``coco/`` and the
    Cityscapes train and val splits."""
    root = str(tmp_path_factory.mktemp("lvis_city"))
    for version in ("v1", "v0.5"):
        for split, seed, first_id in (("train", 1, 1000), ("val", 0, 0)):
            write_synthetic_lvis(root, f"lvis_{version}_{split}", num=8 if split == "val" else 4, seed=seed,
                                 version=version, first_id=first_id)
    write_synthetic_cityscapes(root, "train", num=4, seed=1)
    write_synthetic_cityscapes(root, "val", num=8, seed=0)
    return root


def _opts(yaml):
    return NARROW + next((v for k, v in EXTRA.items() if k in yaml), [])


def _port(args, env_root, monkeypatch):
    """The port's core command in process, ``$JTSM_DATASETS`` at the tree
    (the builtin splits were registered at import from the default root,
    so they are registered again here)."""
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets import builtin
    from jtsm_tpu_torch.tools import train_net

    import jtsm_tpu_torch.data.catalog as catalog

    fresh = (catalog._DatasetCatalog(), catalog._MetadataCatalog())
    for module in [m for name, m in sys.modules.items() if name.startswith("jtsm_tpu_torch") and m is not None]:
        for attr, new in zip(("DatasetCatalog", "MetadataCatalog"), fresh):
            if getattr(module, attr, None) in (DatasetCatalog, MetadataCatalog):
                monkeypatch.setattr(module, attr, new)
    for register in (builtin.register_all_lvis, builtin.register_cityscapes):
        register(env_root)
    return train_net.main(train_net.argument_parser().parse_args(args))


def _gate_weights(path, rows, num_classes):
    state = variables_to_state_dict(load_gate_ckpt(GATE))
    torch.save(select_class_rows(state, rows, num_classes), path)
    return str(path)


def _neutral_weights(yaml, path):
    """The port's initialisation of ``yaml``'s narrow model with each
    residual branch's last norm scale zero (the blocks start as identities),
    and the RPN's and the box head's deltas and the classifier's weights
    zero: boxes stay on their anchors and proposals and every class scores
    alike, so that the model detects something before it has learnt
    anything (from its initialisation the deep stacks of FrozenBN blocks
    saturate the classifier, or overflow, and throw every box off the
    image)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(ROOT, yaml))
    cfg.merge_from_list(copy.copy(_opts(yaml)))
    state = build_model(cfg, device="cpu").state_dict()
    for k in ("proposal_generator.rpn_head.anchor_deltas.weight", "roi_heads.box_predictor.bbox_pred.weight",
              "roi_heads.box_predictor.cls_score.weight"):
        state[k] = torch.zeros_like(state[k])
    for k in [k for k in state if k.endswith("conv3.norm.weight")]:
        state[k] = torch.zeros_like(state[k])
    torch.save(state, path)
    return str(path)


@pytest.mark.parametrize("yaml", LVIS_YAMLS + [CITY_YAML])
def test_yaml_trains_one_iteration_and_scores(yaml, datasets, tmp_path, monkeypatch):
    out = tmp_path / "out"
    base = ["--device", "cpu", "--config-file", os.path.join(ROOT, yaml), *_opts(yaml)]
    start = _neutral_weights(yaml, tmp_path / "start.pth")
    _port(base + ["MODEL.WEIGHTS", start, "SOLVER.MAX_ITER", "1", "OUTPUT_DIR", str(out)], datasets, monkeypatch)
    weights = out / "model_final.pth"
    assert weights.exists()
    res = _port(["--eval-only"] + base + ["MODEL.WEIGHTS", str(weights), "OUTPUT_DIR", str(out)], datasets,
                monkeypatch)
    print(yaml, res)
    if "LVIS" in yaml:
        assert sorted(res) == ["bbox", "segm"] and {"APr", "APc", "APf", "AR300"} <= set(res["bbox"])
    else:
        assert sorted(res) == ["segm"] and sorted(res["segm"]) == ["AP", "AP50"]


def _copypaste(log):
    lines = [ln.split("copypaste: ", 1)[1] for ln in log.splitlines() if "copypaste: " in ln]
    tasks = {}
    for i, ln in enumerate(lines):
        m = re.match(r"Task: (\w+)", ln)
        if m:
            tasks[m.group(1)] = dict(zip(lines[i + 1].split(","), map(float, lines[i + 2].split(","))))
    return tasks


def _both_commands(yaml, weights, root, out):
    env = dict(os.environ, JTSM_DATASETS=root, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2")
    args = ["--eval-only", "--config-file", os.path.join(ROOT, yaml), *_opts(yaml), "MODEL.WEIGHTS", weights]
    commands = {"port": [sys.executable, "-m", "jtsm_tpu_torch.tools.train_net", "--device", "cpu", *args,
                         "OUTPUT_DIR", str(out / "port")],
                "jax": [sys.executable, os.path.join(ROOT, "tools", "train_net.py"), *args,
                        "OUTPUT_DIR", str(out / "jax")]}
    procs = {k: subprocess.Popen(c, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for k, c in commands.items()}
    logs = {k: p.communicate(timeout=900)[0] for k, p in procs.items()}
    for k, p in procs.items():
        assert p.returncode == 0, (k, logs[k][-4000:])
    return _copypaste(logs["jax"]), _copypaste(logs["port"])


def _round4(res):
    return {t: {k: round(v, 4) for k, v in m.items()} for t, m in res.items()}


def test_lvis_eval_only_equals_the_jax_command(datasets, tmp_path):
    yaml = LVIS_YAMLS[0]
    weights = _gate_weights(tmp_path / "gate_lvis.pth", list(range(80)), 1203)
    want, got = _both_commands(yaml, weights, datasets, tmp_path)
    print(got)
    _same_results(_round4(want), _round4(got))
    assert sorted(got) == ["bbox", "segm"] and got["bbox"]["AP"] > 20
    assert all(got["bbox"][k] > 0 for k in ("APr", "APc", "APf"))


@pytest.mark.slow
@pytest.mark.parametrize("yaml", LVIS_YAMLS)
def test_lvis_yaml_after_one_iteration_scores_as_the_jax_command(yaml, datasets, tmp_path, monkeypatch):
    out = tmp_path / "train"
    _port(["--device", "cpu", "--config-file", os.path.join(ROOT, yaml), *_opts(yaml), "MODEL.WEIGHTS",
           _neutral_weights(yaml, tmp_path / "start.pth"), "SOLVER.MAX_ITER", "1", "OUTPUT_DIR", str(out)],
          datasets, monkeypatch)
    want, got = _both_commands(yaml, str(out / "model_final.pth"), datasets, tmp_path)
    _same_results(_round4(want), _round4(got))


def test_cityscapes_eval_only_equals_the_jax_evaluator(datasets, tmp_path, monkeypatch):
    rows = [COCO_80.index(CITY_TO_COCO[c]) for c in CITYSCAPES_THING_CLASSES]
    weights = _gate_weights(tmp_path / "gate_city.pth", rows, 8)
    # the JAX command's test loader cannot batch a Cityscapes set
    jc = jax_get_cfg()
    jc.merge_from_file(os.path.join(ROOT, CITY_YAML))
    jc.merge_from_list(copy.copy(_opts(CITY_YAML)))
    name = "jax_city_val_written"
    JaxDatasetCatalog.register(name, lambda: jax_load_instances(os.path.join(datasets, "cityscapes/leftImg8bit/val"),
                                                                os.path.join(datasets, "cityscapes/gtFine/val")))
    JaxMetadataCatalog.get(name).set(thing_classes=list(CITYSCAPES_THING_CLASSES), evaluator_type="cityscapes_instance")
    loader = jax_test_loader(jc, name)
    loader.prefetch = 0  # batch in this thread, so that the error reaches the test
    with pytest.raises(ValueError, match="invalid literal for int"):
        next(iter(loader))
    jax_eval = jax_city.CityscapesInstanceEvaluator(name)
    jax_eval.reset()
    process = CityscapesInstanceEvaluator.process

    def both(ev, inputs, outputs):
        jax_eval.process({k: np.asarray(v) for k, v in inputs.items()},
                         {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in outputs.items()})
        return process(ev, inputs, outputs)

    monkeypatch.setattr(CityscapesInstanceEvaluator, "process", both)
    monkeypatch.setattr(jax_city.comm, "gather", lambda x, dst=0: [x])
    got = _port(["--eval-only", "--device", "cpu", "--config-file", os.path.join(ROOT, CITY_YAML), *_opts(CITY_YAML),
                 "MODEL.WEIGHTS", weights, "OUTPUT_DIR", str(tmp_path / "out")], datasets, monkeypatch)
    want = jax_eval.evaluate()
    print(got)
    _same_results(want, got)
    assert got["segm"]["AP50"] > 10
