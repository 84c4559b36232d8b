"""Default configuration tree.

A copy of the JAX package's ``config/defaults.py``: the same keys and values,
so every yaml in ``configs/`` merges as it does there (reference:
detectron2/config/defaults.py:24-624). ``MODEL.DEVICE`` names the card here.
The keys under ``TPU`` are kept so the shipped yamls load; of them the port
reads none.
"""

from .cfgnode import CfgNode as CN

_C = CN()

_C.VERSION = 2

_C.MODEL = CN()
_C.MODEL.DEVICE = "cuda"
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.WEIGHTS = ""
_C.MODEL.MASK_ON = False
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.LOAD_PROPOSALS = False
# BGR means of the Caffe2-heritage zoo weights (reference defaults.py:61-69)
_C.MODEL.PIXEL_MEAN = [103.530, 116.280, 123.675]
_C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]

# ---------------------------------------------------------------------------
# Input
# ---------------------------------------------------------------------------
_C.INPUT = CN()
_C.INPUT.MIN_SIZE_TRAIN = (800,)
_C.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
_C.INPUT.MAX_SIZE_TRAIN = 1333
_C.INPUT.MIN_SIZE_TEST = 800
_C.INPUT.MAX_SIZE_TEST = 1333
_C.INPUT.RANDOM_FLIP = "horizontal"
_C.INPUT.CROP = CN()
_C.INPUT.CROP.ENABLED = False
_C.INPUT.CROP.TYPE = "relative_range"
_C.INPUT.CROP.SIZE = [0.9, 0.9]
# < 1.0 switches to RandomCrop_CategoryAreaConstraint (sem-seg crops must
# keep category diversity; reference augmentation_impl.py:291)
_C.INPUT.CROP.SINGLE_CATEGORY_MAX_AREA = 1.0
_C.INPUT.FORMAT = "BGR"
_C.INPUT.MASK_FORMAT = "polygon"

# ---------------------------------------------------------------------------
# Datasets
# ---------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.TRAIN = ()
_C.DATASETS.PROPOSAL_FILES_TRAIN = ()
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
_C.DATASETS.TEST = ()
_C.DATASETS.PROPOSAL_FILES_TEST = ()
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000

_C.DATALOADER = CN()
_C.DATALOADER.NUM_WORKERS = 0
_C.DATALOADER.ASPECT_RATIO_GROUPING = True
_C.DATALOADER.SAMPLER_TRAIN = "TrainingSampler"
_C.DATALOADER.REPEAT_THRESHOLD = 0.0
_C.DATALOADER.FILTER_EMPTY_ANNOTATIONS = True

# ---------------------------------------------------------------------------
# Backbone
# ---------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.NAME = "build_resnet_backbone"
_C.MODEL.BACKBONE.FREEZE_AT = 2

_C.MODEL.FPN = CN()
_C.MODEL.FPN.IN_FEATURES = []
_C.MODEL.FPN.OUT_CHANNELS = 256
_C.MODEL.FPN.NORM = ""
_C.MODEL.FPN.FUSE_TYPE = "sum"

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.DEPTH = 50
_C.MODEL.RESNETS.OUT_FEATURES = ["res4"]
_C.MODEL.RESNETS.NUM_GROUPS = 1
_C.MODEL.RESNETS.NORM = "FrozenBN"
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True
_C.MODEL.RESNETS.RES5_DILATION = 1
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
_C.MODEL.RESNETS.DEFORM_MODULATED = False
_C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

_C.MODEL.VGG = CN()
_C.MODEL.VGG.DEPTH = 16
_C.MODEL.VGG.OUT_FEATURES = ["plain5"]
_C.MODEL.VGG.CONV5_DILATION = 1

# ---------------------------------------------------------------------------
# Proposal generator / anchors / RPN
# ---------------------------------------------------------------------------
_C.MODEL.PROPOSAL_GENERATOR = CN()
_C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
_C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

_C.MODEL.ANCHOR_GENERATOR = CN()
_C.MODEL.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
_C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
_C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
_C.MODEL.ANCHOR_GENERATOR.OFFSET = 0.0
_C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]

_C.MODEL.RPN = CN()
_C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
_C.MODEL.RPN.IN_FEATURES = ["res4"]
_C.MODEL.RPN.BOUNDARY_THRESH = -1
_C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
_C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.BBOX_REG_LOSS_TYPE = "smooth_l1"
_C.MODEL.RPN.BBOX_REG_LOSS_WEIGHT = 1.0
_C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RPN.SMOOTH_L1_BETA = 0.0
_C.MODEL.RPN.LOSS_WEIGHT = 1.0
_C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7
_C.MODEL.RPN.CONV_DIMS = [-1]

# ---------------------------------------------------------------------------
# ROI heads
# ---------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
_C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
_C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
_C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.NAME = ""
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "smooth_l1"
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 1.0
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
_C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
_C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
_C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NORM = ""
_C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False
_C.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = False

_C.MODEL.ROI_BOX_CASCADE_HEAD = CN()
_C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)
_C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = (0.5, 0.6, 0.7)

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
_C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
_C.MODEL.ROI_MASK_HEAD.NORM = ""
_C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
_C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"

_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = tuple(512 for _ in range(8))
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
_C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
_C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
_C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"

# ---------------------------------------------------------------------------
# RetinaNet
# ---------------------------------------------------------------------------
_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CLASSES = 80
_C.MODEL.RETINANET.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.IOU_THRESHOLDS = [0.4, 0.5]
_C.MODEL.RETINANET.IOU_LABELS = [0, -1, 1]
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
_C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
_C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
_C.MODEL.RETINANET.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1
_C.MODEL.RETINANET.BBOX_REG_LOSS_TYPE = "smooth_l1"
_C.MODEL.RETINANET.NORM = ""

# ---------------------------------------------------------------------------
# Semantic segmentation / panoptic
# ---------------------------------------------------------------------------
_C.MODEL.SEM_SEG_HEAD = CN()
_C.MODEL.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
_C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
_C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = 255
_C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
_C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
_C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
_C.MODEL.SEM_SEG_HEAD.NORM = "GN"
_C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0

_C.MODEL.PANOPTIC_FPN = CN()
_C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
_C.MODEL.PANOPTIC_FPN.COMBINE = CN()
_C.MODEL.PANOPTIC_FPN.COMBINE.ENABLED = True
_C.MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH = 0.5
_C.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 4096
_C.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5

# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.MOMENTUM = 0.9
# "SGD" or "ADAM" (Panoptic-DeepLab uses ADAM)
_C.SOLVER.OPTIMIZER = "SGD"
_C.SOLVER.NESTEROV = False
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.REFERENCE_WORLD_SIZE = 0
_C.SOLVER.BIAS_LR_FACTOR = 1.0
_C.SOLVER.WEIGHT_DECAY_BIAS = 0.0001
_C.SOLVER.CLIP_GRADIENTS = CN()
_C.SOLVER.CLIP_GRADIENTS.ENABLED = False
_C.SOLVER.CLIP_GRADIENTS.CLIP_TYPE = "value"
_C.SOLVER.CLIP_GRADIENTS.CLIP_VALUE = 1.0
_C.SOLVER.CLIP_GRADIENTS.NORM_TYPE = 2.0
_C.SOLVER.AMP = CN()
_C.SOLVER.AMP.ENABLED = True  # bf16 compute path on TPU

# ---------------------------------------------------------------------------
# Test
# ---------------------------------------------------------------------------
_C.TEST = CN()
_C.TEST.EXPECTED_RESULTS = []
_C.TEST.EVAL_PERIOD = 0
# Eval images per step. >1 is the TPU-native analog of the reference's
# 1-image-per-GPU distributed eval: the batch is sharded over the data mesh
# when its size divides the device count (the final partial batch is padded
# on device and trimmed host-side before the evaluators see it).
_C.TEST.IMS_PER_BATCH = 1
_C.TEST.KEYPOINT_OKS_SIGMAS = []
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.AUG = CN()
_C.TEST.AUG.ENABLED = False
_C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
_C.TEST.AUG.MAX_SIZE = 4000
_C.TEST.AUG.FLIP = True
_C.TEST.PRECISE_BN = CN()
_C.TEST.PRECISE_BN.ENABLED = False
_C.TEST.PRECISE_BN.NUM_ITER = 200

# ---------------------------------------------------------------------------
# TPU-specific
# ---------------------------------------------------------------------------
_C.TPU = CN()
# Static padded image buckets (H, W) the compiled graph supports; images are
# resized by the usual policy then padded to the smallest fitting bucket so
# XLA compiles a bounded number of programs.
_C.TPU.IMAGE_BUCKETS = [[800, 1344], [1344, 800], [1024, 1024]]
# Fixed capacities that replace dynamic shapes (see SURVEY.md §7):
_C.TPU.MAX_GT_INSTANCES = 100
# dtype of the compute path: "bfloat16" or "float32"
_C.TPU.COMPUTE_DTYPE = "bfloat16"
# mesh axis names and sizes; -1 means "all remaining devices"
_C.TPU.MESH_AXES = ["data"]
_C.TPU.MESH_SHAPE = [-1]
# FSDP / ZeRO-3: shard large params + optimizer buffers over the data axis
_C.TPU.FSDP = False
# Activation rematerialization (jax.checkpoint): module scopes whose
# intermediates are recomputed on the backward pass instead of stored —
# the HBM lever for larger per-chip train batches. Valid scopes:
#   "backbone_blocks"  each trainable residual block (fine-grained)
#   "backbone"         the whole backbone(+FPN) call — only the output
#                      feature maps are stored
#   "rpn_head"         the RPN conv tower (res2-resolution activations)
#   "box_head" / "mask_head" / "keypoint_head"   per-ROI head stacks
_C.TPU.REMAT = []
# Post-training int8 inference (jtsm_tpu/export/quantize.py): top-level
# module scopes whose convs run s8 x s8 -> s32 on the MXU after activation
# calibration, e.g. ["backbone"]. Empty = full bf16/f32 inference.
# DefaultPredictor calibrates lazily on the first image; evaluation via
# DefaultTrainer.test calibrates on the first test batch.
_C.TPU.INT8_SCOPES = []
# Persistent XLA compilation cache: compiled programs are keyed by HLO and
# reused across process invocations, so a second `train_net.py`/demo run on
# the same config skips the 20-40s TPU compile. "" disables; the
# JTSM_XLA_CACHE_DIR environment variable overrides the config value.
_C.TPU.COMPILATION_CACHE_DIR = "/tmp/jtsm_xla_cache"

_C.OUTPUT_DIR = "./output"
_C.SEED = -1
# reference-compat key (torch concept): accepted so reference yamls load,
# intentionally inert on TPU — like MODEL.DEVICE and GLOBAL.HACK below.
_C.CUDNN_BENCHMARK = False
_C.VIS_PERIOD = 0

_C.GLOBAL = CN()
_C.GLOBAL.HACK = 1.0


def get_cfg() -> CN:
    """Return a fresh copy of the default config (reference config.py:84)."""
    return _C.clone()


def mask_rcnn_R_50_FPN_cfg() -> CN:
    """``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml`` over
    ``configs/Base-RCNN-FPN.yaml``, set in Python so that a machine without
    PyYAML builds the flagship model. A test holds it equal to the merged
    yaml files."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.WEIGHTS = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    m.MASK_ON = True
    m.BACKBONE.NAME = "build_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.RPN.PRE_NMS_TOPK_TRAIN = 2000
    m.RPN.PRE_NMS_TOPK_TEST = 1000
    m.RPN.POST_NMS_TOPK_TRAIN = 1000
    m.RPN.POST_NMS_TOPK_TEST = 1000
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
    m.ROI_MASK_HEAD.NUM_CONV = 4
    m.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
    cfg.DATASETS.TRAIN = ("coco_2017_train",)
    cfg.DATASETS.TEST = ("coco_2017_val",)
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.STEPS = (60000, 80000)
    cfg.SOLVER.MAX_ITER = 90000
    cfg.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
    cfg.VERSION = 2
    return cfg


def _narrow_gate(cfg: CN, family: str, expected_results, max_iter: int = 80, steps=(70,),
                 base_lr: float = 0.002) -> CN:
    """What the synthetic gates of ``configs/quick_schedules/`` share: the
    narrow bottleneck R50 of ``tests/fixtures/gate_ckpts/<family>.ckpt.gz``
    (32 channels to the FPN), scenes at short side 128 in two buckets,
    float32, the gates' solver and their pins."""
    m = cfg.MODEL
    m.WEIGHTS = f"tests/fixtures/gate_ckpts/{family}.ckpt.gz"
    m.BACKBONE.FREEZE_AT = 0
    m.RESNETS.STEM_OUT_CHANNELS = 32
    m.RESNETS.RES2_OUT_CHANNELS = 32
    m.RESNETS.WIDTH_PER_GROUP = 8
    m.FPN.OUT_CHANNELS = 32
    cfg.INPUT.MIN_SIZE_TRAIN = (128,)
    cfg.INPUT.MAX_SIZE_TRAIN = 176
    cfg.INPUT.MIN_SIZE_TEST = 128
    cfg.INPUT.MAX_SIZE_TEST = 176
    cfg.TPU.IMAGE_BUCKETS = [[128, 176], [176, 176]]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    s = cfg.SOLVER
    s.IMS_PER_BATCH = 4
    s.BASE_LR = base_lr
    s.MAX_ITER = max_iter
    s.STEPS = steps
    s.WARMUP_ITERS = 40
    s.WARMUP_FACTOR = 0.01
    s.CLIP_GRADIENTS.ENABLED = True
    s.CLIP_GRADIENTS.CLIP_TYPE = "norm"
    s.CLIP_GRADIENTS.CLIP_VALUE = 5.0
    cfg.DATALOADER.NUM_WORKERS = 0
    cfg.TEST.EXPECTED_RESULTS = expected_results
    cfg.SEED = 42
    return cfg


def _rpn_gate_topk(cfg: CN, train=(512, 128), test=(256, 64)) -> None:
    r = cfg.MODEL.RPN
    r.PRE_NMS_TOPK_TRAIN, r.POST_NMS_TOPK_TRAIN = train
    r.PRE_NMS_TOPK_TEST, r.POST_NMS_TOPK_TEST = test


def mask_rcnn_gate_cfg() -> CN:
    """``configs/quick_schedules/mask_rcnn_R_18_FPN_synthetic_inference_acc_test.yaml``
    (over its training twin and ``Base-RCNN-FPN.yaml``), set in Python: the
    narrow bottleneck R50 of the committed ``tests/fixtures/gate_ckpts/
    mask_rcnn.ckpt.gz`` weights. A test holds it equal to the merged yamls."""
    cfg = _narrow_gate(mask_rcnn_R_50_FPN_cfg(), "mask_rcnn",
                       [["bbox", "AP", 63.5662, 0.02], ["segm", "AP", 64.9523, 0.02]], 200, (180,))
    m = cfg.MODEL
    _rpn_gate_topk(cfg)
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.FC_DIM = 64
    m.ROI_MASK_HEAD.NUM_CONV = 1
    m.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.DATASETS.TRAIN = ("coco_2017_val_100",)
    cfg.DATASETS.TEST = ("coco_2017_val_100",)
    return cfg


def mask_rcnn_R_50_FPN_giou_cfg() -> CN:
    """``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x_giou.yaml``,
    set in Python: the flagship with the GIoU box loss in the RPN (weight
    2) and the ROI heads (weight 10, which the JAX package does not read,
    ROADMAP §3)."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    m = cfg.MODEL
    m.RPN.BBOX_REG_LOSS_TYPE = "giou"
    m.RPN.BBOX_REG_LOSS_WEIGHT = 2.0
    m.ROI_BOX_HEAD.BBOX_REG_LOSS_TYPE = "giou"
    m.ROI_BOX_HEAD.BBOX_REG_LOSS_WEIGHT = 10.0
    return cfg


def mask_rcnn_R_50_FPN_pred_boxes_cfg() -> CN:
    """``configs/quick_schedules/mask_rcnn_R_50_FPN_pred_boxes_training_acc_test.yaml``
    (over ``mask_rcnn_R_50_FPN_training_acc_test.yaml``), set in Python:
    the mask branch trains on the box head's predicted boxes."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 256
    cfg.MODEL.ROI_BOX_HEAD.TRAIN_ON_PRED_BOXES = True
    cfg.DATASETS.TRAIN = ("coco_2017_val_100",)
    cfg.DATASETS.TEST = ("coco_2017_val_100",)
    i = cfg.INPUT
    i.MIN_SIZE_TRAIN = (600,)
    i.MAX_SIZE_TRAIN = 1000
    i.MIN_SIZE_TEST = 800
    i.MAX_SIZE_TEST = 1000
    s = cfg.SOLVER
    s.WARMUP_FACTOR = 0.3333333
    s.WARMUP_ITERS = 100
    s.STEPS = (5500, 5800)
    s.MAX_ITER = 6000
    cfg.TEST.EXPECTED_RESULTS = [["bbox", "AP", 42.6, 1.0], ["segm", "AP", 35.8, 0.8]]
    return cfg


def mask_rcnn_R_50_FPN_syncbn_cfg() -> CN:
    """``configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml``, set in Python:
    SyncBN in the ResNet (stride in the 3x3), the FPN, a box head of four
    convolutions and one fc, and the mask head; the 3x schedule."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    m = cfg.MODEL
    m.RESNETS.NORM = "SyncBN"
    m.RESNETS.STRIDE_IN_1X1 = False
    m.FPN.NORM = "SyncBN"
    m.ROI_BOX_HEAD.NUM_CONV = 4
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.NORM = "SyncBN"
    m.ROI_MASK_HEAD.NORM = "SyncBN"
    cfg.SOLVER.STEPS = (210000, 250000)
    cfg.SOLVER.MAX_ITER = 270000
    return cfg


def panoptic_fpn_R_50_cfg() -> CN:
    """``configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml`` (over
    ``Base-Panoptic-FPN.yaml`` and ``Base-RCNN-FPN.yaml``), set in Python."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.META_ARCHITECTURE = "PanopticFPN"
    cfg.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 0.5
    cfg.DATASETS.TRAIN = ("coco_2017_train_panoptic_separated",)
    cfg.DATASETS.TEST = ("coco_2017_val_panoptic_separated",)
    cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS = False
    return cfg


def retinanet_R_50_FPN_cfg() -> CN:
    """``configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml`` (over
    ``Base-RetinaNet.yaml``), set in Python: P3-P7, the P6/P7 convolutions
    from res5, three sizes by three ratios of anchors a level."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "RetinaNet"
    m.WEIGHTS = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    m.BACKBONE.NAME = "build_retinanet_resnet_fpn_backbone"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res3", "res4", "res5"]
    m.FPN.IN_FEATURES = ["res3", "res4", "res5"]
    # sizes x, x * 2**(1/3), x * 2**(2/3), as the yaml writes them out
    m.ANCHOR_GENERATOR.SIZES = [
        [32.0, 40.3174735966, 50.796833663], [64.0, 80.6349471933, 101.593667326],
        [128.0, 161.2698943865, 203.1873346519], [256.0, 322.5397887731, 406.3746693039],
        [512.0, 645.0795775462, 812.7493386077],
    ]
    m.RETINANET.SMOOTH_L1_LOSS_BETA = 0.0
    cfg.DATASETS.TRAIN = ("coco_2017_train",)
    cfg.DATASETS.TEST = ("coco_2017_val",)
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.SOLVER.BASE_LR = 0.01
    cfg.SOLVER.STEPS = (60000, 80000)
    cfg.SOLVER.MAX_ITER = 90000
    cfg.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
    cfg.VERSION = 2
    return cfg


def rpn_R_50_FPN_cfg() -> CN:
    """``configs/COCO-Detection/rpn_R_50_FPN_1x.yaml`` (over
    ``Base-RCNN-FPN.yaml``), set in Python: the RPN alone."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.META_ARCHITECTURE = "ProposalNetwork"
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 2000
    return cfg


def keypoint_rcnn_R_50_FPN_cfg() -> CN:
    """``configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml`` (over
    ``Base-Keypoint-RCNN-FPN.yaml`` and ``Base-RCNN-FPN.yaml``), set in
    Python: one class, the keypoint head, no masks."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    m = cfg.MODEL
    m.KEYPOINT_ON = True
    m.MASK_ON = False
    m.ROI_HEADS.NUM_CLASSES = 1
    m.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.5
    m.RPN.POST_NMS_TOPK_TRAIN = 1500
    cfg.DATASETS.TRAIN = ("keypoints_coco_2017_train",)
    cfg.DATASETS.TEST = ("keypoints_coco_2017_val",)
    return cfg


def semantic_R_50_FPN_cfg() -> CN:
    """``configs/Misc/semantic_R_50_FPN_1x.yaml`` (over
    ``Base-RCNN-FPN.yaml``), set in Python: the FPN and the sem-seg head
    alone, on COCO's stuff maps."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
    cfg.MODEL.MASK_ON = False
    cfg.DATASETS.TRAIN = ("coco_2017_train_panoptic_stuffonly",)
    cfg.DATASETS.TEST = ("coco_2017_val_panoptic_stuffonly",)
    return cfg


def panoptic_fpn_gate_cfg() -> CN:
    """``configs/quick_schedules/panoptic_fpn_R_18_synthetic_inference_acc_test.yaml``
    (the narrow R50 of ``panoptic_fpn.ckpt.gz``), set in Python."""
    cfg = _narrow_gate(panoptic_fpn_R_50_cfg(), "panoptic_fpn", [
        ["bbox", "AP", 21.5726, 0.02], ["segm", "AP", 21.6414, 0.02], ["sem_seg", "mIoU", 53.4529, 0.02],
        ["panoptic_seg", "PQ", 21.9175, 0.02]])
    m = cfg.MODEL
    _rpn_gate_topk(cfg)
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.FC_DIM = 64
    m.ROI_MASK_HEAD.NUM_CONV = 1
    m.ROI_MASK_HEAD.CONV_DIM = 32
    m.SEM_SEG_HEAD.CONVS_DIM = 32
    m.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.2
    cfg.DATASETS.TRAIN = ("coco_2017_val_100_panoptic_separated",)
    cfg.DATASETS.TEST = ("coco_2017_val_100_panoptic_separated",)
    return cfg


def retinanet_gate_cfg() -> CN:
    """``configs/quick_schedules/retinanet_R_18_synthetic_inference_acc_test.yaml``
    (the narrow R50 of ``retinanet.ckpt.gz``), set in Python."""
    cfg = _narrow_gate(retinanet_R_50_FPN_cfg(), "retinanet", [["bbox", "AP", 38.2114, 0.02]], 200, (180,))
    cfg.MODEL.RETINANET.NUM_CONVS = 1
    cfg.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 256
    cfg.DATASETS.TRAIN = ("coco_2017_val_100",)
    cfg.DATASETS.TEST = ("coco_2017_val_100",)
    return cfg


def rpn_gate_cfg() -> CN:
    """``configs/quick_schedules/rpn_R_18_synthetic_inference_acc_test.yaml``
    (the narrow R50 of ``rpn.ckpt.gz``), set in Python."""
    cfg = _narrow_gate(rpn_R_50_FPN_cfg(), "rpn", [["box_proposals", "AR@1000", 52.381, 0.02]])
    _rpn_gate_topk(cfg, (512, 256), (512, 256))
    cfg.DATASETS.TRAIN = ("coco_2017_val_100",)
    cfg.DATASETS.TEST = ("coco_2017_val_100",)
    return cfg


def keypoint_rcnn_gate_cfg() -> CN:
    """``configs/quick_schedules/keypoint_rcnn_R_18_synthetic_inference_acc_test.yaml``
    (the narrow R50 of ``keypoint_rcnn.ckpt.gz``), set in Python."""
    cfg = _narrow_gate(keypoint_rcnn_R_50_FPN_cfg(), "keypoint_rcnn",
                       [["bbox", "AP", 6.3899, 0.02], ["keypoints", "AP", 10.3519, 0.02]], 400, (380,), 0.01)
    m = cfg.MODEL
    _rpn_gate_topk(cfg)
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.FC_DIM = 64
    m.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
    m.ROI_KEYPOINT_HEAD.CONV_DIMS = (64, 64)
    cfg.DATASETS.TRAIN = ("keypoints_coco_2017_val_100",)
    cfg.DATASETS.TEST = ("keypoints_coco_2017_val_100",)
    return cfg


def _rcnn_c4_cfg() -> CN:
    """``configs/Base-RCNN-C4.yaml``: the ResNet's res4 (OUT_FEATURES's
    default) under one RPN level (6000 before NMS and 1000 after it when
    serving) and ``Res5ROIHeads``."""
    cfg = get_cfg()
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.RPN.PRE_NMS_TOPK_TEST = 6000
    m.RPN.POST_NMS_TOPK_TEST = 1000
    m.ROI_HEADS.NAME = "Res5ROIHeads"
    cfg.DATASETS.TRAIN = ("coco_2017_train",)
    cfg.DATASETS.TEST = ("coco_2017_val",)
    cfg.SOLVER.IMS_PER_BATCH = 16
    cfg.SOLVER.BASE_LR = 0.02
    cfg.SOLVER.STEPS = (60000, 80000)
    cfg.SOLVER.MAX_ITER = 90000
    cfg.INPUT.MIN_SIZE_TRAIN = (640, 672, 704, 736, 768, 800)
    cfg.VERSION = 2
    return cfg


def c4_narrow(cfg: CN) -> CN:
    """The narrow form of a C4 (or FPN) detector for tests and the card's
    checks against the CPU: the gates' narrow bottleneck ResNet (res4 128
    channels, the head's res5 256, an FPN 32), no weights and every stage
    training, scenes at short side 128 in two buckets, float32, 256 and 64
    proposals when serving (512 and 128 in training), 64 ROI slots an
    image, a 64-wide box head under the FPN, the gates' solver and no
    expected results."""
    cfg = _narrow_gate(cfg, "", [])
    cfg.MODEL.WEIGHTS = ""
    _rpn_gate_topk(cfg)
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.ROI_BOX_HEAD.NUM_FC = 1
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.TEST.AUG.ENABLED = False
    cfg.TEST.EVAL_PERIOD = 0
    return cfg


def faster_rcnn_R_50_C4_cfg(narrow: bool = False) -> CN:
    """``configs/COCO-Detection/faster_rcnn_R_50_C4_1x.yaml`` over
    ``Base-RCNN-C4.yaml``, set in Python: R-50's res4, ``Res5ROIHeads``,
    no masks. ``narrow``: its narrow form (``c4_narrow``)."""
    cfg = _rcnn_c4_cfg()
    cfg.MODEL.WEIGHTS = "detectron2://ImageNetPretrained/MSRA/R-50.pkl"
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.RESNETS.DEPTH = 50
    return c4_narrow(cfg) if narrow else cfg


def rotated_faster_rcnn_R_50_cfg(narrow: bool = False) -> CN:
    """A rotated Faster R-CNN R50: ``faster_rcnn_R_50_C4_cfg`` (over
    ``configs/COCO-Detection/faster_rcnn_R_50_C4_1x.yaml``) with the
    overrides of ``tests/modeling/test_rotated.py:41-66`` at full width:
    the ResNet's res4 into ``RRPN`` with ``RotatedAnchorGenerator`` (the
    default sizes and ratios at angles -90, 0, 90: 45 anchors a cell) and
    into ``RROIHeads`` (``FastRCNNConvFCHead``, two 1024-wide fcs, rotated
    ROIAlign at 7x7), 80 classes, box weights (1, 1, 1, 1, 1) for the RPN
    and (10, 10, 5, 5, 1) for the heads. No yaml names it. ``narrow``: the
    JAX test's own tiny model (R-18 with RES2_OUT_CHANNELS 64, every stage
    training, 32-px anchors, 32 proposals before NMS and 16 after it, 8 ROI
    slots, one 32-wide fc, 3 classes) on 64x64 images, float32."""
    cfg = faster_rcnn_R_50_C4_cfg()
    m = cfg.MODEL
    m.RESNETS.OUT_FEATURES = ["res4"]
    m.PROPOSAL_GENERATOR.NAME = "RRPN"
    m.RPN.IN_FEATURES = ["res4"]
    m.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0, 1.0)
    m.ANCHOR_GENERATOR.NAME = "RotatedAnchorGenerator"
    m.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]
    m.ROI_HEADS.NAME = "RROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["res4"]
    m.ROI_HEADS.NUM_CLASSES = 80
    bh = m.ROI_BOX_HEAD
    bh.NAME = "FastRCNNConvFCHead"
    bh.NUM_FC = 2
    bh.FC_DIM = 1024
    bh.POOLER_RESOLUTION = 7
    bh.POOLER_TYPE = "ROIAlignRotated"
    bh.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0, 1.0)
    if not narrow:
        return cfg
    m.WEIGHTS = ""
    m.BACKBONE.FREEZE_AT = 0
    m.RESNETS.DEPTH = 18
    m.RESNETS.RES2_OUT_CHANNELS = 64
    r = m.RPN
    r.PRE_NMS_TOPK_TRAIN, r.POST_NMS_TOPK_TRAIN = 32, 16
    r.PRE_NMS_TOPK_TEST, r.POST_NMS_TOPK_TEST = 32, 16
    m.ANCHOR_GENERATOR.SIZES = [[32]]
    m.ANCHOR_GENERATOR.ASPECT_RATIOS = [[1.0]]
    m.ROI_HEADS.NUM_CLASSES = 3
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 8
    bh.NUM_FC = 1
    bh.FC_DIM = 32
    cfg.INPUT.MIN_SIZE_TRAIN = (64,)
    cfg.INPUT.MAX_SIZE_TRAIN = 64
    cfg.INPUT.MIN_SIZE_TEST = 64
    cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.TPU.IMAGE_BUCKETS = [[64, 64]]
    cfg.TPU.COMPUTE_DTYPE = "float32"
    cfg.TEST.AUG.ENABLED = False
    cfg.TEST.EVAL_PERIOD = 0
    return cfg


def mask_rcnn_R_50_C4_cfg(narrow: bool = False) -> CN:
    """``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml`` over
    ``Base-RCNN-C4.yaml``, set in Python: ``faster_rcnn_R_50_C4_cfg`` with
    the C4 mask head (no convolution, the deconvolution on res5's 7x7).
    ``narrow``: its narrow form (``c4_narrow``)."""
    cfg = faster_rcnn_R_50_C4_cfg()
    cfg.MODEL.MASK_ON = True
    return c4_narrow(cfg) if narrow else cfg


def faster_rcnn_R_50_C4_voc_cfg(narrow: bool = False) -> CN:
    """``configs/PascalVOC-Detection/faster_rcnn_R_50_C4.yaml``, set in
    Python: ``faster_rcnn_R_50_C4_cfg`` on VOC 2007 and 2012 (20 classes,
    scored on ``voc_2007_test``). ``narrow``: its narrow form."""
    cfg = faster_rcnn_R_50_C4_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 20
    cfg.INPUT.MIN_SIZE_TRAIN = (480, 512, 544, 576, 608, 640, 672, 704, 736, 768, 800)
    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = "choice"
    cfg.INPUT.MIN_SIZE_TEST = 800
    cfg.DATASETS.TRAIN = ("voc_2007_trainval", "voc_2012_trainval")
    cfg.DATASETS.TEST = ("voc_2007_test",)
    cfg.SOLVER.STEPS = (12000, 16000)
    cfg.SOLVER.MAX_ITER = 18000
    cfg.SOLVER.WARMUP_ITERS = 100
    return c4_narrow(cfg) if narrow else cfg


def cascade_narrow(cfg: CN) -> CN:
    """The narrow form of an FPN detector of the cascade slice, after
    ``tests/modeling/test_cascade_dcn_tta.py::_cascade_cfg``: the gates'
    narrow bottleneck R50 (32 channels to the FPN, so that the deformable
    stages stay bottlenecks), no weights and every stage training, 32 and 16
    proposals before and after NMS in training and serving, anchors of 16 to
    256 px, 3 classes, 8 ROI slots an image, a 32-wide single-fc box head and
    a 32-wide single-conv mask head, scenes at short side 128 in two
    buckets, float32, the gates' solver and no expected results."""
    cfg = _narrow_gate(cfg, "", [])
    m = cfg.MODEL
    m.WEIGHTS = ""
    _rpn_gate_topk(cfg, (32, 16), (32, 16))
    m.ANCHOR_GENERATOR.SIZES = [[16], [32], [64], [128], [256]]
    m.ROI_HEADS.NUM_CLASSES = 3
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 8
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.FC_DIM = 32
    m.ROI_BOX_HEAD.CONV_DIM = 32
    m.ROI_MASK_HEAD.NUM_CONV = 1
    m.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 16
    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 16
    cfg.TEST.AUG.ENABLED = False
    cfg.TEST.EVAL_PERIOD = 0
    return cfg


def cascade_mask_rcnn_R_50_FPN_cfg(narrow: bool = False) -> CN:
    """``configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml`` over
    ``Base-RCNN-FPN.yaml``, set in Python: ``mask_rcnn_R_50_FPN_cfg`` with
    ``CascadeROIHeads`` (class-agnostic regression) and 2000 proposals in
    training. ``narrow``: its narrow form (``cascade_narrow``)."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.ROI_HEADS.NAME = "CascadeROIHeads"
    cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = True
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
    return cascade_narrow(cfg) if narrow else cfg


def mask_rcnn_R_50_FPN_dconv_cfg(narrow: bool = False) -> CN:
    """``configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml``, set in
    Python: ``mask_rcnn_R_50_FPN_cfg`` with deformable convolutions (DCNv1)
    in res3-res5. ``narrow``: its narrow form (``cascade_narrow``)."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, True, True, True]
    cfg.MODEL.RESNETS.DEFORM_MODULATED = False
    return cascade_narrow(cfg) if narrow else cfg


def fast_rcnn_R_50_FPN_cfg(narrow: bool = False) -> CN:
    """``configs/COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml``, set in Python:
    the R-50 FPN box detector on precomputed proposals (no RPN: the
    DATASETS.PROPOSAL_FILES_* pickles, PRECOMPUTED_PROPOSAL_TOPK_* of them
    an image). ``narrow``: its narrow form (``cascade_narrow``)."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    m = cfg.MODEL
    m.MASK_ON = False
    m.LOAD_PROPOSALS = True
    m.PROPOSAL_GENERATOR.NAME = "PrecomputedProposals"
    cfg.DATASETS.PROPOSAL_FILES_TRAIN = (
        "detectron2://COCO-Detection/rpn_R_50_FPN_1x/137258492/coco_2017_train_box_proposals_21bc3a.pkl",)
    cfg.DATASETS.PROPOSAL_FILES_TEST = (
        "detectron2://COCO-Detection/rpn_R_50_FPN_1x/137258492/coco_2017_val_box_proposals_ee0dad.pkl",)
    cfg.DATALOADER.NUM_WORKERS = 2
    return cascade_narrow(cfg) if narrow else cfg


def cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv_cfg() -> CN:
    """``configs/Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml``,
    set in Python: the cascade on ResNeXt-152 32x8d (the stride on the 3x3,
    GN) with deformable convolutions in res3-res5 (dense, as the JAX
    package builds them, ``DeformBottleneckBlock``), a GN FPN, a 4-conv GN
    box head and an 8-conv GN mask head."""
    cfg = cascade_mask_rcnn_R_50_FPN_cfg()
    m = cfg.MODEL
    m.WEIGHTS = "detectron2://ImageNetPretrained/FAIR/X-152-32x8d-IN5k.pkl"
    r = m.RESNETS
    r.STRIDE_IN_1X1 = False
    r.NUM_GROUPS = 32
    r.WIDTH_PER_GROUP = 8
    r.DEPTH = 152
    r.DEFORM_ON_PER_STAGE = [False, True, True, True]
    r.NORM = "GN"
    m.FPN.NORM = "GN"
    m.ROI_BOX_HEAD.NUM_CONV = 4
    m.ROI_BOX_HEAD.NUM_FC = 1
    m.ROI_BOX_HEAD.NORM = "GN"
    m.ROI_MASK_HEAD.NUM_CONV = 8
    m.ROI_MASK_HEAD.NORM = "GN"
    s = cfg.SOLVER
    s.IMS_PER_BATCH = 128
    s.STEPS = (35000, 45000)
    s.MAX_ITER = 50000
    s.BASE_LR = 0.16
    cfg.INPUT.MIN_SIZE_TRAIN = (640, 864)
    cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING = "range"
    cfg.INPUT.MAX_SIZE_TRAIN = 1440
    cfg.TEST.EVAL_PERIOD = 2500
    return cfg


def panoptic_fpn_R_101_dconv_cascade_gn_cfg() -> CN:
    """``configs/Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml``, set in
    Python: ``panoptic_fpn_R_50_cfg`` on R-101 with deformable convolutions
    in res3-res5, the cascade (class-agnostic regression, 2000 proposals in
    training) and a GN mask head."""
    cfg = panoptic_fpn_R_50_cfg()
    m = cfg.MODEL
    m.WEIGHTS = "detectron2://ImageNetPretrained/MSRA/R-101.pkl"
    m.RESNETS.DEPTH = 101
    m.RESNETS.DEFORM_ON_PER_STAGE = [False, True, True, True]
    m.ROI_HEADS.NAME = "CascadeROIHeads"
    m.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = True
    m.ROI_MASK_HEAD.NORM = "GN"
    m.RPN.POST_NMS_TOPK_TRAIN = 2000
    s = cfg.SOLVER
    s.STEPS = (105000, 125000)
    s.MAX_ITER = 135000
    s.IMS_PER_BATCH = 32
    s.BASE_LR = 0.04
    return cfg


def mask_rcnn_R_50_FPN_lvis_cfg(version: str = "v1") -> CN:
    """``configs/LVISv1-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml``
    (``version`` "v1", 1203 classes) or its ``LVISv0.5`` sibling ("v0.5",
    1230), set in Python: ``mask_rcnn_R_50_FPN_cfg`` at SCORE_THRESH_TEST
    0.0001 and 300 detections an image, trained on the repeat-factor
    sampler at REPEAT_THRESHOLD 0.001."""
    classes = {"v1": 1203, "v0.5": 1230}[version]
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = classes
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0001
    cfg.TEST.DETECTIONS_PER_IMAGE = 300
    cfg.DATASETS.TRAIN = (f"lvis_{version}_train",)
    cfg.DATASETS.TEST = (f"lvis_{version}_val",)
    cfg.DATALOADER.SAMPLER_TRAIN = "RepeatFactorTrainingSampler"
    cfg.DATALOADER.REPEAT_THRESHOLD = 0.001
    return cfg


CITYSCAPES_BUCKET = [1024, 2048]


def mask_rcnn_R_50_FPN_cityscapes_cfg() -> CN:
    """``configs/Cityscapes/mask_rcnn_R_50_FPN.yaml``, set in Python: the
    R50-FPN Mask R-CNN with 8 classes on 1024x2048 images (short side 1024
    when serving, one of 800-1024 in steps of 32 in training, long side at
    most 2048), IMS_PER_BATCH 8 at BASE_LR 0.01. TPU.IMAGE_BUCKETS gains
    ``CITYSCAPES_BUCKET``: the default buckets (the largest 1344x1344) hold
    no 1024x2048 image, so the yaml as it is raises in the port (a
    ValueError naming the size) and cannot batch in the JAX package."""
    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 8
    cfg.DATASETS.TRAIN = ("cityscapes_fine_instance_seg_train",)
    cfg.DATASETS.TEST = ("cityscapes_fine_instance_seg_val",)
    i = cfg.INPUT
    i.MIN_SIZE_TRAIN = (800, 832, 864, 896, 928, 960, 992, 1024)
    i.MIN_SIZE_TRAIN_SAMPLING = "choice"
    i.MIN_SIZE_TEST = 1024
    i.MAX_SIZE_TRAIN = 2048
    i.MAX_SIZE_TEST = 2048
    s = cfg.SOLVER
    s.BASE_LR = 0.01
    s.STEPS = (18000,)
    s.MAX_ITER = 24000
    s.IMS_PER_BATCH = 8
    cfg.TEST.EVAL_PERIOD = 8000
    cfg.TPU.IMAGE_BUCKETS = cfg.TPU.IMAGE_BUCKETS + [CITYSCAPES_BUCKET]
    return cfg
