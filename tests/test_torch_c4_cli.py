"""The slice's yamls through the command lines on the CPU:

* the core command (``python -m jtsm_tpu_torch.tools.train_net
  --eval-only``) on the narrowed core VOC C4 yaml
  (``faster_rcnn_R_50_C4_voc_cfg(narrow=True)``, random weights from a
  seed) over the in-memory synthetic VOC set
  (``data.datasets.synthetic_voc.register_synthetic_voc``): its VOC AP and
  CorLoc equal to what the JAX package's ``PascalVOCDetectionEvaluator``
  makes of the same detections, handed to it with VOC's string ids (its
  test loader would cast them to integers and score 0, ROADMAP §3);
* both packages' WSL loaders under the fully supervised WS-ResNet yamls
  (MODEL.LOAD_PROPOSALS False, boxes in the annotations): equal batches;
* Trident OICR (``oicr_TRD_WSR_18_DC5_cfg(narrow=True)``) through both WSL
  commands' ``--eval-only`` on the VOC tree of ``tests/test_torch_voc.py``
  (its helpers, fixtures and tolerances: every number within 1e-4, each
  detection's score within 1e-4 and box within 1e-3 px).
"""

import numpy as np
import pytest
import torch

from jtsm_tpu.config import get_cfg as jax_get_cfg
from jtsm_tpu.data import DatasetCatalog as JaxDatasetCatalog
from jtsm_tpu.data import MetadataCatalog as JaxMetadataCatalog
from jtsm_tpu.evaluation import pascal_voc_evaluation as jax_voc
from jtsm_tpu.utils.env import seed_all_rng as jax_seed_all_rng
from jtsm_tpu.wsl.data import build_wsl_test_loader as jax_wsl_test_loader
from jtsm_tpu.wsl.data import build_wsl_train_loader as jax_wsl_train_loader
from jtsm_tpu_torch.checkpoint import random_state_dict
from jtsm_tpu_torch.config import (
    faster_rcnn_R_50_C4_voc_cfg,
    faster_rcnn_WSR_50_C4_cfg,
    faster_rcnn_WSR_50_FPN_cfg,
    oicr_TRD_WSR_18_DC5_cfg,
)
from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
from jtsm_tpu_torch.data.datasets.pascal_voc import voc_metadata
from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
from jtsm_tpu_torch.evaluation import PascalVOCDetectionEvaluator
from jtsm_tpu_torch.modeling import build_model
from jtsm_tpu_torch.tools import train_net as core_cli
from jtsm_tpu_torch.wsl.data import build_wsl_test_loader, build_wsl_train_loader
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_train_loader import _assert_same, _first_batches
from tests.test_torch_voc import (  # noqa: F401  (the fixtures)
    NAME,
    _run_both,
    _same_detections,
    _same_numbers,
    _string_ids_for_jax,
    _two_torch_threads,
    jax_cli,
    tree,
)

MEMORY = "voc_2007_synthetic_in_memory"


@pytest.fixture
def in_memory_voc():
    """The in-memory VOC set in the port, and its records in the JAX
    package's catalogs for its evaluator."""
    register_synthetic_voc(MEMORY, num=8, seed=1, image_hw=(112, 160))
    JaxDatasetCatalog.register(MEMORY, lambda: DatasetCatalog.get(MEMORY))
    JaxMetadataCatalog.get(MEMORY).set(**voc_metadata(None, "test", 2007))
    yield MEMORY
    for catalog in (JaxDatasetCatalog, JaxMetadataCatalog, DatasetCatalog, MetadataCatalog):
        if MEMORY in catalog:
            catalog.remove(MEMORY)


def _weights(cfg, tmp_path, seed, cls_gain=1.0):
    """Seeded random weights of ``cfg``'s model as a ``.pth`` file, the box
    classifier's kernel times ``cls_gain``."""
    path = str(tmp_path / "weights.pth")
    torch.manual_seed(0)
    state = random_state_dict(build_model(cfg, device="cpu"), seed=seed)
    for k in state:
        if k.endswith("cls_score.weight"):
            state[k] *= cls_gain
    torch.save({"model": state}, path)
    return path


def test_core_command_scores_voc_c4_as_the_jax_evaluator(in_memory_voc, tmp_path, monkeypatch):
    cfg = faster_rcnn_R_50_C4_voc_cfg(narrow=True)
    cfg.DATASETS.TEST = (in_memory_voc,)
    # every proposal of the yaml's 1000 and 1000 detections an image scored,
    # so that random weights find some objects
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST, cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 6000, 1000
    cfg.TEST.DETECTIONS_PER_IMAGE = 1000
    # at random weights res5's mean saturates the classifier: one class an image
    cfg.MODEL.WEIGHTS = _weights(cfg, tmp_path, seed=5, cls_gain=0.01)
    yaml = str(tmp_path / "voc_c4.yaml")
    jc = jax_get_cfg()
    jc.merge_from_other_cfg(cfg)
    with open(yaml, "w") as f:
        f.write(jc.dump())
    jax_eval = jax_voc.PascalVOCDetectionEvaluator(in_memory_voc)
    process = PascalVOCDetectionEvaluator.process

    def both(ev, inputs, outputs):
        jax_eval.process({"image_ids": np.asarray([str(i) for i in inputs["image_ids"]])},
                         {k: v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v) for k, v in outputs.items()})
        return process(ev, inputs, outputs)

    monkeypatch.setattr(PascalVOCDetectionEvaluator, "process", both)
    got = core_cli.main(core_cli.argument_parser().parse_args(
        ["--eval-only", "--device", "cpu", "--config-file", yaml, "OUTPUT_DIR", str(tmp_path / "out")]))
    want = jax_eval.evaluate()
    print(got)
    _same_numbers(want, got)
    assert got["bbox"]["AP50"] > 0
    assert sum(len(p) for p in jax_eval._predictions.values()) > 8 * 100
    assert all(isinstance(d["image_id"], str) for p in jax_eval._predictions.values() for d in p)


@pytest.mark.parametrize("builder", [faster_rcnn_WSR_50_C4_cfg, faster_rcnn_WSR_50_FPN_cfg])
def test_wsl_loaders_of_the_supervised_yamls_equal_jax(tree, builder):
    """No proposals (MODEL.LOAD_PROPOSALS False): the test batches and the
    train batches (boxes, classes, validity; two short sides and the
    flip) equal to the JAX package's, key for key, but for the ids."""
    cfg = builder(narrow=True)
    cfg.merge_from_list(["DATASETS.TRAIN", f"('{NAME}',)", "DATASETS.TEST", f"('{NAME}',)",
                         "INPUT.MIN_SIZE_TRAIN", "(112, 128)"])
    assert not cfg.MODEL.LOAD_PROPOSALS
    jc = _jax_cfg(cfg)
    strip = lambda batches: [{k: v for k, v in b.items() if k != "image_ids"} for b in batches]  # noqa: E731
    _assert_same(strip(jax_wsl_test_loader(jc, NAME)), strip(build_wsl_test_loader(cfg, NAME)))
    jax_seed_all_rng(jc.SEED)
    want = _first_batches(jax_wsl_train_loader(jc), 2)
    got = _first_batches(build_wsl_train_loader(cfg), 2)
    _assert_same(strip(want), strip(got))
    assert {"gt_boxes", "gt_classes", "gt_valid"} <= set(got[0]) and "proposals" not in got[0]


def test_trident_through_both_wsl_commands(tree, jax_cli, tmp_path, monkeypatch):
    _string_ids_for_jax(monkeypatch)
    cfg = oicr_TRD_WSR_18_DC5_cfg(narrow=True)
    cfg.merge_from_list(["DATASETS.TRAIN", f"('{NAME}',)", "DATASETS.TEST", f"('{NAME}',)",
                         "DATASETS.PROPOSAL_FILES_TRAIN", f"('{tree['pkl']}',)",
                         "DATASETS.PROPOSAL_FILES_TEST", f"('{tree['pkl']}',)"])
    weights = _weights(cfg, tmp_path, seed=2)
    yaml = str(tmp_path / "trident.yaml")
    with open(yaml, "w") as f:
        f.write(_jax_cfg(cfg).dump())
    want, got, want_seen, got_seen = _run_both(jax_cli, yaml, ["MODEL.WEIGHTS", weights], str(tmp_path))
    print(got)
    _same_numbers(want, got)
    assert _same_detections(want_seen, got_seen) > 100
