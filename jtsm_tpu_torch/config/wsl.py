"""The JTSM configurations, set in Python so that a machine without PyYAML
builds them. A test holds each equal to its merged yaml files."""

from __future__ import annotations

from .cfgnode import CfgNode as CN
from .defaults import get_cfg


def wsl_cfg() -> CN:
    """The default tree with the WSL keys (``add_wsl_config``)."""
    from ..wsl.config import add_wsl_config

    cfg = get_cfg()
    add_wsl_config(cfg)
    return cfg


def jtsm_WSR_18_DC5_cfg() -> CN:
    """The JTSM flagship,
    ``projects/WSL/configs/PascalVOC-PanopticSegmentation/jtsm_WSR_18_DC5_1x.yaml``
    over ``PascalVOC-Detection/oicr_WSR_18_DC5_1x.yaml`` and
    ``Base-WSL-WSR.yaml``: WSR-18 with the res5 dilation of DC5, 4000 MCG
    proposals with superpixels, MOIPool, the 4096-wide DAN, MIL over 21
    joint classes, 4 refinement branches, the mask refinery and the
    two-class stuff head."""
    cfg = wsl_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedMCNNWSL"
    m.WEIGHTS = "models/DRN-WSOD/resnet18_ws_model_120_d2.pkl"
    m.MASK_ON = True
    m.LOAD_PROPOSALS = True
    m.BACKBONE.NAME = "build_wsl_resnet_v2_backbone"
    m.BACKBONE.FREEZE_AT = 5
    m.RESNETS.DEPTH = 18
    m.RESNETS.OUT_FEATURES = ["res5"]
    m.RESNETS.RES5_DILATION = 2
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    m.PROPOSAL_GENERATOR.MIN_SIZE = 20
    m.ROI_HEADS.NAME = "JTSMROIHeads"
    m.ROI_HEADS.NUM_CLASSES = 20
    m.ROI_HEADS.IN_FEATURES = ["res5"]
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.00001
    m.ROI_HEADS.NMS_THRESH_TEST = 0.3
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_BOX_HEAD.POOLER_TYPE = "MOIPool"
    m.ROI_BOX_HEAD.DAN_DIM = [4096, 4096]
    m.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleWSLHead"
    m.SEM_SEG_HEAD.NAME = "TwoClassHead"
    m.SEM_SEG_HEAD.IN_FEATURES = ["res5"]
    m.SEM_SEG_HEAD.NUM_CLASSES = 2
    cfg.INPUT.MIN_SIZE_TRAIN = (480, 576, 688, 864, 1200)
    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    cfg.INPUT.MAX_SIZE_TRAIN = 2000
    cfg.INPUT.MIN_SIZE_TEST = 688
    cfg.INPUT.MAX_SIZE_TEST = 4000
    d = cfg.DATASETS
    d.TRAIN = ("voc_2012_train_panoptic_separated", "sbd_9118_panoptic_separated")
    d.PROPOSAL_FILES_TRAIN = (
        "datasets/proposals/mcg_voc_2012_train_instance_segmentation_d2",
        "datasets/proposals/mcg_sbd_9118_instance_segmentation_d2",
    )
    d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 4000
    d.TEST = ("voc_2012_val_panoptic_separated",)
    d.PROPOSAL_FILES_TEST = ("datasets/proposals/mcg_voc_2012_val_instance_segmentation_d2",)
    d.PRECOMPUTED_PROPOSAL_TOPK_TEST = 4000
    s = cfg.SOLVER
    s.IMS_PER_BATCH = 4
    s.BASE_LR = 0.01
    s.STEPS = (35000, 50000)
    s.MAX_ITER = 50000
    s.WEIGHT_DECAY = 0.0005
    s.BIAS_LR_FACTOR = 2.0
    s.WEIGHT_DECAY_BIAS = 0.0
    t = cfg.TEST
    t.EVAL_PERIOD = 1000
    t.DETECTIONS_PER_IMAGE = 100
    t.AUG.ENABLED = True
    t.AUG.MIN_SIZES = (480, 576, 688, 864, 1200)
    t.AUG.MAX_SIZE = 4000
    t.AUG.FLIP = True
    cfg.VIS_PERIOD = 32
    cfg.VERSION = 2
    w = cfg.WSL
    w.ITER_SIZE = 4
    w.REFINE_NUM = 4
    w.REFINE_REG = [True, True, True, True]
    w.PS_ON = True
    w.SP_ON = True
    return cfg


def jtsm_gate_cfg() -> CN:
    """``projects/WSL/configs/quick_schedules/jtsm_synthetic_inference_acc_test.yaml``
    over ``jtsm_synthetic_training_acc_test.yaml``: the narrow JTSM of the
    committed ``tests/fixtures/gate_ckpts/jtsm.ckpt.gz`` weights (R18 with a
    16-wide stem, DAN 128, 2 refinement branches, the learned FPN stuff
    head over 54 classes), 64 proposals and 512 superpixels an image."""
    cfg = wsl_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedMCNNWSL"
    m.WEIGHTS = "tests/fixtures/gate_ckpts/jtsm.ckpt.gz"
    m.MASK_ON = True
    m.LOAD_PROPOSALS = True
    m.BACKBONE.NAME = "build_wsl_resnet_backbone"
    m.BACKBONE.FREEZE_AT = 0
    m.RESNETS.DEPTH = 18
    m.RESNETS.OUT_FEATURES = ["res5"]
    m.RESNETS.RES5_DILATION = 2
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.STEM_OUT_CHANNELS = 16
    m.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    m.ROI_HEADS.NAME = "JTSMROIHeads"
    m.ROI_HEADS.NUM_CLASSES = 80
    m.ROI_HEADS.IN_FEATURES = ["res5"]
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.0001
    m.ROI_HEADS.NMS_THRESH_TEST = 0.3
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_BOX_HEAD.DAN_DIM = [128, 128]
    m.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    m.ROI_MASK_HEAD.NUM_CONV = 1
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    m.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
    m.SEM_SEG_HEAD.IN_FEATURES = ["res5"]
    m.SEM_SEG_HEAD.NUM_CLASSES = 54
    m.SEM_SEG_HEAD.CONVS_DIM = 32
    m.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.002
    w = cfg.WSL
    w.REFINE_NUM = 2
    w.MEAN_LOSS = False
    w.REFINE_REG = [True, True]
    w.PS_ON = True
    w.SP_ON = True
    w.MAX_SUPERPIXELS = 512
    w.MASK_CAPACITY = 8
    d = cfg.DATASETS
    d.TRAIN = ("coco_2017_varied_100_panoptic_separated",)
    d.TEST = ("coco_2017_varied_100_panoptic_separated",)
    d.PROPOSAL_FILES_TRAIN = ("$JTSM_DATASETS/cocovar/proposals_val2017_100.pkl",)
    d.PROPOSAL_FILES_TEST = ("$JTSM_DATASETS/cocovar/proposals_val2017_100.pkl",)
    d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 64
    d.PRECOMPUTED_PROPOSAL_TOPK_TEST = 64
    cfg.INPUT.MIN_SIZE_TRAIN = (128,)
    cfg.INPUT.MAX_SIZE_TRAIN = 176
    cfg.INPUT.MIN_SIZE_TEST = 128
    cfg.INPUT.MAX_SIZE_TEST = 176
    cfg.TPU.IMAGE_BUCKETS = [[128, 176], [176, 176]]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    s = cfg.SOLVER
    s.IMS_PER_BATCH = 2
    s.BASE_LR = 0.01
    s.MAX_ITER = 1200
    s.STEPS = (1040,)
    s.WARMUP_ITERS = 200
    s.WARMUP_FACTOR = 0.01
    s.CLIP_GRADIENTS.ENABLED = True
    s.CLIP_GRADIENTS.CLIP_TYPE = "full_model"
    s.CLIP_GRADIENTS.CLIP_VALUE = 1.0
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS = False
    cfg.TEST.AUG.ENABLED = False
    cfg.TEST.EXPECTED_RESULTS = [
        ["bbox", "AP", 25.1932, 0.02],
        ["segm", "AP", 25.5954, 0.02],
        ["sem_seg", "mIoU", 7.9448, 0.02],
        ["panoptic_seg", "PQ", 3.4049, 0.02],
    ]
    cfg.SEED = 42
    cfg.VERSION = 2
    return cfg


# the WSOD baselines' ROI heads and the prefix of their yamls
WSOD_HEADS = {"WSDDNROIHeads": "wsddn", "OICRROIHeads": "oicr", "PCLROIHeads": "pcl"}
# the heads of the WSOD zoo's further yamls (``WSOD_ZOO``)
_ZOO_HEADS = ("CascadeOICRROIHeads", "ContextLocNetROIHeads", "CMILROIHeads")


def _wsod_cfg(head: str) -> CN:
    """What ``Base-WSL-WSR.yaml`` and ``Base-WSL-VGG16.yaml`` share, with
    ``head`` as the ROI heads; the WSDDN yamls sum the MIL loss over the
    classes (WSL.MEAN_LOSS False)."""
    if head not in WSOD_HEADS and head not in _ZOO_HEADS:
        raise ValueError(f"{head!r} is not one of the WSOD heads {sorted(WSOD_HEADS) + sorted(_ZOO_HEADS)}")
    cfg = wsl_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNNWSL"
    m.LOAD_PROPOSALS = True
    m.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    m.ROI_HEADS.NAME = head
    m.ROI_HEADS.NUM_CLASSES = 20
    m.ROI_HEADS.SCORE_THRESH_TEST = 0.00001
    m.ROI_HEADS.NMS_THRESH_TEST = 0.3
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_BOX_HEAD.DAN_DIM = [4096, 4096]
    d = cfg.DATASETS
    d.TRAIN = ("voc_2007_trainval",)
    d.TEST = ("voc_2007_test",)
    d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
    d.PRECOMPUTED_PROPOSAL_TOPK_TEST = 2000
    s = cfg.SOLVER
    s.IMS_PER_BATCH = 4
    s.STEPS = (35000,)
    s.MAX_ITER = 50000
    cfg.INPUT.MIN_SIZE_TRAIN = (480, 576, 688, 864, 1200)
    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    cfg.INPUT.MAX_SIZE_TRAIN = 2000
    cfg.INPUT.MIN_SIZE_TEST = 688
    cfg.INPUT.MAX_SIZE_TEST = 4000
    cfg.VERSION = 2
    if head == "WSDDNROIHeads":
        cfg.WSL.MEAN_LOSS = False
    return cfg


def wsod_WSR_18_DC5_cfg(head: str) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/{wsddn,oicr,pcl}_WSR_18_DC5_1x.yaml``
    over ``Base-WSL-WSR.yaml``: WSR-18 with the res5 dilation of DC5
    (FREEZE_AT 5), 2000 precomputed proposals on VOC 2007, the 4096-wide
    DAN and ``head`` (``WSDDNROIHeads``, ``OICRROIHeads`` or
    ``PCLROIHeads``), ITER_SIZE 4, biases at twice the rate without decay,
    test-time augmentation over 5 scales and the flips."""
    cfg = _wsod_cfg(head)
    m = cfg.MODEL
    m.WEIGHTS = "models/DRN-WSOD/resnet18_ws_model_120_d2.pkl"
    m.BACKBONE.NAME = "build_wsl_resnet_backbone"
    m.BACKBONE.FREEZE_AT = 5
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.RES5_DILATION = 2
    m.RESNETS.OUT_FEATURES = ["res5"]
    m.PROPOSAL_GENERATOR.MIN_SIZE = 20
    m.ROI_HEADS.IN_FEATURES = ["res5"]
    m.ROI_BOX_HEAD.POOLER_TYPE = "ROIPool"  # the WSOD heads pool by ROIAlignV2 whatever it says
    s = cfg.SOLVER
    s.BASE_LR = 0.01
    s.WEIGHT_DECAY = 0.0005
    s.BIAS_LR_FACTOR = 2.0
    s.WEIGHT_DECAY_BIAS = 0.0
    t = cfg.TEST
    t.AUG.ENABLED = True
    t.AUG.MIN_SIZES = (480, 576, 688, 864, 1200)
    t.AUG.MAX_SIZE = 4000
    t.AUG.FLIP = True
    t.EVAL_PERIOD = 10000
    cfg.WSL.ITER_SIZE = 4
    return cfg


def wsod_V_16_DC5_cfg(head: str) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/{wsddn,oicr,pcl}_V_16_DC5_1x.yaml``
    over ``Base-WSL-VGG16.yaml``: VGG16 with conv5 dilated (``plain5`` at
    stride 8, FREEZE_AT 2), 2000 precomputed proposals on VOC 2007, the
    4096-wide DAN and ``head``, no test-time augmentation."""
    cfg = _wsod_cfg(head)
    m = cfg.MODEL
    m.WEIGHTS = "models/VGG/VGG_ILSVRC_16_layers_v1_d2.pkl"
    m.BACKBONE.NAME = "build_vgg_backbone"
    m.VGG.DEPTH = 16
    m.VGG.CONV5_DILATION = 2
    m.VGG.OUT_FEATURES = ["plain5"]
    m.ROI_HEADS.IN_FEATURES = ["plain5"]
    cfg.SOLVER.BASE_LR = 0.001
    return cfg


def _wsod_narrow(cfg: CN) -> CN:
    """The narrow form of a WSOD configuration for tests and the card's
    checks against the CPU, cut as ``jtsm_gate_cfg`` cuts the JTSM
    flagship: its short side 128 (long side at most 176, in its buckets),
    64 proposals an image, a DAN 64 wide, 2 refinement branches, float32,
    2 images a batch and its solver (no bias rule, the full-model clip),
    no test-time augmentation and no expected results."""
    gate = jtsm_gate_cfg()
    cfg.MODEL.WEIGHTS = ""
    cfg.MODEL.ROI_BOX_HEAD.DAN_DIM = [64, 64]
    cfg.WSL.REFINE_NUM = 2
    cfg.WSL.ITER_SIZE = 1
    d = cfg.DATASETS
    d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = gate.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN
    d.PRECOMPUTED_PROPOSAL_TOPK_TEST = gate.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    for k in ("MIN_SIZE_TRAIN", "MAX_SIZE_TRAIN", "MIN_SIZE_TEST", "MAX_SIZE_TEST"):
        cfg.INPUT[k] = gate.INPUT[k]
    cfg.TPU.IMAGE_BUCKETS = gate.TPU.IMAGE_BUCKETS
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.SOLVER = gate.SOLVER.clone()
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.TEST.AUG.ENABLED = False
    cfg.TEST.AUG.MIN_SIZES = (112, 128)
    cfg.TEST.AUG.MAX_SIZE = 176
    cfg.TEST.EVAL_PERIOD = 0
    cfg.TEST.EXPECTED_RESULTS = []
    cfg.SEED = gate.SEED
    return cfg


def wsod_WSR_18_narrow_cfg(head: str) -> CN:
    """``wsod_WSR_18_DC5_cfg(head)`` cut by ``_wsod_narrow``, its stem 16
    wide and every stage training (FREEZE_AT 0), as the JTSM gate's."""
    cfg = _wsod_narrow(wsod_WSR_18_DC5_cfg(head))
    cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
    cfg.MODEL.BACKBONE.FREEZE_AT = 0
    return cfg


def wsod_V_16_narrow_cfg(head: str) -> CN:
    """``wsod_V_16_DC5_cfg(head)`` cut by ``_wsod_narrow``; VGG16 keeps its
    widths and FREEZE_AT 2."""
    return _wsod_narrow(wsod_V_16_DC5_cfg(head))


def _zoo_narrow(cfg: CN, narrow: bool) -> CN:
    """``cfg``, or with ``narrow`` its narrow form: ``_wsod_narrow``, and
    WSR-18's stem 16 wide with every stage training, as
    ``wsod_WSR_18_narrow_cfg`` cuts it."""
    if not narrow:
        return cfg
    cfg = _wsod_narrow(cfg)
    if cfg.MODEL.BACKBONE.NAME != "build_vgg_backbone":
        cfg.MODEL.RESNETS.STEM_OUT_CHANNELS = 16
        cfg.MODEL.BACKBONE.FREEZE_AT = 0
    return cfg


def cascade_oicr_WSR_18_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/reg_all/oicr_CA_WSR_18_DC5_1x.yaml``
    over ``oicr_WSR_18_DC5_1x.yaml``: Cascade OICR on WSR-18 DC5, 4
    refinement branches, each regressing class-specific boxes, and the
    cascade's mined rows (WSL.CASCADE_ON). ``narrow``: its narrow form
    (``_wsod_narrow``, 2 branches)."""
    cfg = wsod_WSR_18_DC5_cfg("CascadeOICRROIHeads")
    cfg.WSL.REFINE_NUM = 4
    cfg.WSL.REFINE_REG = [True, True, True, True]
    cfg.WSL.CASCADE_ON = True
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
    cfg.TEST.EVAL_PERIOD = 10001
    return _zoo_narrow(cfg, narrow)


def oicr_sampling_WSR_18_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/reg_all/oicr_SP_WSR_18_DC5_1x.yaml``
    over ``oicr_WSR_18_DC5_1x.yaml``: OICR on WSR-18 DC5, 4 regressing
    branches, branch k labelling its proposals at IoU 0.3, 0.4, 0.5, 0.6
    and sampling them (WSL.SAMPLING)."""
    cfg = wsod_WSR_18_DC5_cfg("OICRROIHeads")
    cfg.WSL.REFINE_NUM = 4
    cfg.WSL.REFINE_REG = [True, True, True, True]
    s = cfg.WSL.SAMPLING
    s.SAMPLING_ON = True
    s.IOU_THRESHOLDS = [[0.3], [0.4], [0.5], [0.6]]
    s.IOU_LABELS = [[0, 1], [0, 1], [0, 1], [0, 1]]
    return _zoo_narrow(cfg, narrow)


def pcl_gam_WSR_18_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/reg_last/pcl_WSR_18_DC5_1x.yaml``
    over ``Base-WSL-WSR.yaml``: PCL on WSR-18 DC5 with the guided attention
    module (WSL.HAS_GAM; its WSL.REFINE_REG, which PCL's branches do not
    read)."""
    cfg = wsod_WSR_18_DC5_cfg("PCLROIHeads")
    cfg.WSL.REFINE_REG = [False, False, True, True]
    cfg.WSL.HAS_GAM = True
    return _zoo_narrow(cfg, narrow)


def contextlocnet_WSR_18_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/contextlocnet_WSR_18_DC5_1x.yaml``:
    ContextLocNet on WSR-18 DC5, the MIL loss summed over the classes."""
    cfg = wsod_WSR_18_DC5_cfg("ContextLocNetROIHeads")
    cfg.WSL.MEAN_LOSS = False
    return _zoo_narrow(cfg, narrow)


def contextlocnet_V_16_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/contextlocnet_V_16_DC5_1x.yaml``:
    ContextLocNet on VGG16 DC5."""
    return _zoo_narrow(wsod_V_16_DC5_cfg("ContextLocNetROIHeads"), narrow)


def cmil_WSR_18_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/cmil_WSR_18_DC5_1x.yaml``:
    CMIL on WSR-18 DC5 (WSL.CMIL, epochs of 5000 iterations)."""
    cfg = wsod_WSR_18_DC5_cfg("CMILROIHeads")
    cfg.WSL.CMIL = True
    cfg.WSL.SIZE_EPOCH = 5000
    return _zoo_narrow(cfg, narrow)


def cmil_V_16_DC5_cfg(narrow: bool = False) -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/cmil_V_16_DC5_1x.yaml``:
    CMIL on VGG16 DC5."""
    cfg = wsod_V_16_DC5_cfg("CMILROIHeads")
    cfg.WSL.CMIL = True
    cfg.WSL.SIZE_EPOCH = 5000
    return _zoo_narrow(cfg, narrow)


# the WSOD zoo's further configurations: name -> (its yaml under
# projects/WSL/configs/PascalVOC-Detection/, its builder)
WSOD_ZOO = {
    "oicr_CA_WSR_18": ("reg_all/oicr_CA_WSR_18_DC5_1x.yaml", cascade_oicr_WSR_18_DC5_cfg),
    "oicr_SP_WSR_18": ("reg_all/oicr_SP_WSR_18_DC5_1x.yaml", oicr_sampling_WSR_18_DC5_cfg),
    "pcl_gam_WSR_18": ("reg_last/pcl_WSR_18_DC5_1x.yaml", pcl_gam_WSR_18_DC5_cfg),
    "contextlocnet_WSR_18": ("contextlocnet_WSR_18_DC5_1x.yaml", contextlocnet_WSR_18_DC5_cfg),
    "contextlocnet_V_16": ("contextlocnet_V_16_DC5_1x.yaml", contextlocnet_V_16_DC5_cfg),
    "cmil_WSR_18": ("cmil_WSR_18_DC5_1x.yaml", cmil_WSR_18_DC5_cfg),
    "cmil_V_16": ("cmil_V_16_DC5_1x.yaml", cmil_V_16_DC5_cfg),
}


def wsddn_R_18_DC5_cfg() -> CN:
    """``projects/WSL/configs/PascalVOC-Detection/wsddn_R_18_DC5_1x.yaml``
    over ``Base-RCNN-DilatedC5.yaml`` (both of them), set in Python: WSDDN
    over the plain ResNet-18 with the res5 dilation of DC5 (FREEZE_AT 2:
    res3 to res5 train), 4000 MCG proposals on VOC 2007, the 4096-wide
    DAN, 24 train scales from 480 to 1216 with INPUT.CROP (relative_range
    0.9) first, test-time augmentation over 8 scales and the flips."""
    cfg = wsl_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNNWSL"
    m.WEIGHTS = "models/DRN-WSOD/resnet18_model_120.pkl"
    m.PIXEL_MEAN = [102.9801, 115.9465, 122.7717]
    m.LOAD_PROPOSALS = True
    m.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    m.PROPOSAL_GENERATOR.MIN_SIZE = 20
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    m.RESNETS.RES5_DILATION = 2
    m.RESNETS.OUT_FEATURES = ["res5"]
    m.RPN.IN_FEATURES = ["res5"]
    h = m.ROI_HEADS
    h.NAME = "WSDDNROIHeads"
    h.IN_FEATURES = ["res5"]
    h.NUM_CLASSES = 20
    h.BATCH_SIZE_PER_IMAGE = 4096
    h.POSITIVE_FRACTION = 1.0
    h.PROPOSAL_APPEND_GT = False
    h.SCORE_THRESH_TEST = 0.000000001
    m.ROI_BOX_HEAD.NAME = "DiscriminativeAdaptionNeck"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NUM_CONV = 4
    d = cfg.DATASETS
    d.TRAIN = ("voc_2007_train", "voc_2007_val")
    d.PROPOSAL_FILES_TRAIN = ("datasets/proposals/mcg_voc_2007_train_d2.pkl",
                              "datasets/proposals/mcg_voc_2007_val_d2.pkl")
    d.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 4000
    d.TEST = ("voc_2007_test",)
    d.PROPOSAL_FILES_TEST = ("datasets/proposals/mcg_voc_2007_test_d2.pkl",)
    d.PRECOMPUTED_PROPOSAL_TOPK_TEST = 4000
    i = cfg.INPUT
    i.MIN_SIZE_TRAIN = tuple(range(480, 1217, 32))
    i.MAX_SIZE_TRAIN = 2000
    i.MIN_SIZE_TEST = 688
    i.MAX_SIZE_TEST = 2000
    i.CROP.ENABLED = True
    s = cfg.SOLVER
    s.STEPS = (35000, 35000)
    s.MAX_ITER = 35000
    s.WARMUP_ITERS = 0
    s.IMS_PER_BATCH = 4
    s.BASE_LR = 0.001
    s.WEIGHT_DECAY = 0.0005
    s.BIAS_LR_FACTOR = 2.0
    s.WEIGHT_DECAY_BIAS = 0.0
    t = cfg.TEST
    t.AUG.ENABLED = True
    t.AUG.MIN_SIZES = (480, 576, 672, 768, 864, 960, 1056, 1152)
    t.AUG.MAX_SIZE = 4000
    t.AUG.FLIP = True
    t.EVAL_PERIOD = 10000
    return cfg


def wsddn_R_18_narrow_cfg() -> CN:
    """``wsddn_R_18_DC5_cfg()`` cut by ``_wsod_narrow`` (its short side 128,
    64 proposals, a DAN 64 wide, float32), keeping the yaml's INPUT.CROP
    and FREEZE_AT 2."""
    return _wsod_narrow(wsddn_R_18_DC5_cfg())
