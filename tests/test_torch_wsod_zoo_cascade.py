"""Cascade OICR (``reg_all/oicr_CA_WSR_18_DC5_1x.yaml``) and ContextLocNet
(``contextlocnet_WSR_18_DC5_1x.yaml``) on the narrow WSR-18 DC5 against the
JAX package, as ``tests/test_torch_wsod_zoo.py`` sets out; and the yamls of
the WSOD zoo (``config.WSOD_ZOO``: seven, and the five of CSC, CSC-OICR and
UWSOD): each equal to its Python builder, built at full width on the CPU,
and raising without a card."""

import os

import pytest
import torch

from jtsm_tpu_torch.config import WSOD_ZOO, wsl_cfg
from jtsm_tpu_torch.modeling import build_model
from tests.test_torch_jtsm import _jax_cfg
from tests.test_torch_wsod import VOC_DET, _jax_dan_without_dropout, _two_torch_threads  # noqa: F401  (the fixtures)
from tests.test_torch_wsod_zoo import check_head_case

HEADS = {"oicr_CA_WSR_18": "CascadeOICRROIHeads", "oicr_SP_WSR_18": "OICRROIHeads", "pcl_gam_WSR_18": "PCLROIHeads",
         "contextlocnet_WSR_18": "ContextLocNetROIHeads", "contextlocnet_V_16": "ContextLocNetROIHeads",
         "cmil_WSR_18": "CMILROIHeads", "cmil_V_16": "CMILROIHeads", "csc_WSR_18": "CSCROIHeads",
         "csc_V_16": "CSCROIHeads", "csc_oicr_V_16": "CSCOICRROIHeads", "csc_oicr_reg_last_V_16": "CSCOICRROIHeads",
         "uwsod_V_16": "UWSODROIHeads"}
# the yamls whose heads have no refinement branches
NO_BRANCHES = ("contextlocnet_WSR_18", "contextlocnet_V_16", "csc_WSR_18", "csc_V_16")


@pytest.mark.parametrize("case", ["oicr_ca", "contextlocnet"])
def test_heads_detections_losses_and_gradients_match_jax(case):
    want_losses, tm = check_head_case(case)
    if case == "oicr_ca":
        assert "loss_refine_cls1_cascade" in want_losses and float(want_losses["loss_refine_cls1_cascade"]) > 0
    else:
        assert sorted(want_losses) == ["loss_mil"]


@pytest.mark.parametrize("name", sorted(WSOD_ZOO))
def test_zoo_yamls_equal_their_builders_and_build(name):
    """The yaml merged into the WSL defaults equals its Python builder (and
    the JAX package reads the same tree); its narrow form keeps the head,
    the meta-architecture and the branches the narrow configurations
    keep."""
    yaml, builder = WSOD_ZOO[name]
    cfg = wsl_cfg()
    cfg.merge_from_file(os.path.join(VOC_DET, yaml))
    assert builder().to_dict() == cfg.to_dict()
    assert _jax_cfg(cfg).to_dict() == cfg.to_dict()
    assert cfg.MODEL.ROI_HEADS.NAME == HEADS[name]
    narrow = builder(narrow=True)
    assert (narrow.MODEL.META_ARCHITECTURE, narrow.MODEL.ROI_HEADS.NAME) == ("GeneralizedRCNNWSL", HEADS[name])
    assert narrow.WSL.REFINE_NUM == 2 and narrow.MODEL.ROI_BOX_HEAD.DAN_DIM == [64, 64]


def test_zoo_yamls_build_at_full_width_on_the_cpu_and_raise_without_a_card():
    """Each of the zoo's yamls builds its full-width model with
    ``device="cpu"``, with the head it names, GAM only under WSL.HAS_GAM,
    and the branches it asks for; without ``device`` and without a card
    the build raises."""
    for name, (yaml, _) in sorted(WSOD_ZOO.items()):
        cfg = wsl_cfg()
        cfg.merge_from_file(os.path.join(VOC_DET, yaml))
        model = build_model(cfg, device="cpu")
        heads = model.roi_heads
        assert type(heads).__name__ == HEADS[name]
        assert (getattr(heads, "gam", None) is not None) == (name == "pcl_gam_WSR_18")
        branches = len(getattr(heads, "refine", []))
        assert branches == {"oicr_CA_WSR_18": 4, "oicr_SP_WSR_18": 4}.get(
            name, 0 if name in NO_BRANCHES else cfg.WSL.REFINE_NUM), name
        del model
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build_model(cfg)
