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
