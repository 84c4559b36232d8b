"""WSL config namespace (reference: projects/WSL/wsl/config/defaults.py:20
``add_wsl_config``): a copy of the JAX package's ``wsl/config.py``, the same
keys and values, so the WSL yamls merge as they do there."""

from __future__ import annotations

from ..config import CfgNode as CN


def add_wsl_config(cfg: CN) -> None:
    _C = cfg

    # NOTE: add_wsl_config does NOT touch PROPOSAL_GENERATOR.NAME (upstream
    # wsl/config/defaults.py leaves the d2 default "RPN"); the WSOD yamls set
    # "PrecomputedProposals" themselves via their Base-* files, so the fully
    # supervised faster_rcnn_WSR_* yamls keep a learned RPN like upstream.

    _C.WSL = CN()
    _C.WSL.ITER_SIZE = 1
    # mean-vs-sum reduction of the MIL image BCE (reference defaults.py:22;
    # the wsddn/csc WSR yamls set False, oicr/pcl/cmil/uwsod set True)
    _C.WSL.MEAN_LOSS = True
    _C.WSL.USE_OBN = True
    _C.WSL.REFINE_NUM = 3
    _C.WSL.REFINE_REG = [False, False, False, False]
    _C.WSL.REFINE_MIST = False
    _C.WSL.HAS_GAM = False
    _C.WSL.CSC_MAX_ITER = 35000
    # WSJDS (reference wsjds_heads.py): CSC proposal-mass threshold and the
    # CPG fg/bg thresholds for mined sem-seg targets
    _C.WSL.CSC_FG_THRESHOLD = 0.1
    _C.WSL.SEM_FG_THRESHOLD = 0.7
    _C.WSL.SEM_BG_THRESHOLD = 0.1
    _C.WSL.SIZE_EPOCH = 5000
    _C.WSL.CMIL = False
    # JTSM panoptic switches
    _C.WSL.PS_ON = False
    _C.WSL.SP_ON = False
    # IoU-nearest-neighbor targets mined per class for the mask branch
    # (reference defaults.py:66 WSL.MASK_MINED_TOP_K = 10)
    _C.WSL.MASK_MINED_TOP_K = 10
    # self-training mask refinery heads (reference roi_heads_jtsm.py:449
    # builds range(1) refinery heads)
    _C.WSL.MASK_REFINE_NUM = 1
    # object evidence source for mask PGT: "superpixel" (union of member
    # superpixels, reference object_evidence :1924 sp branch) or "grabcut"
    # (host-side cv2.grabCut via pure_callback, reference :1820)
    _C.WSL.OBJECT_EVIDENCE = "superpixel"
    # training mask-roi capacity per image (static shape)
    _C.WSL.MASK_CAPACITY = 64
    # at test time, emit full-image superpixel-union instance masks with
    # no_paste flags instead of box-pasted crop masks (reference
    # roi_heads_jtsm.py:969-997 + postprocessing.py:63-70)
    _C.WSL.TEST_NO_PASTE = False
    # per-refinement-branch proposal sampling (reference defaults.py:53-58):
    # branch k labels proposals against its mined PGT with
    # Matcher(IOU_THRESHOLDS[k], IOU_LABELS[k]) and subsamples
    # BATCH_SIZE_PER_IMAGE[k] of them at POSITIVE_FRACTION[k]
    _C.WSL.SAMPLING = CN()
    _C.WSL.SAMPLING.SAMPLING_ON = False
    _C.WSL.SAMPLING.IOU_THRESHOLDS = [[0.5], [0.5], [0.5], [0.5]]
    _C.WSL.SAMPLING.IOU_LABELS = [[0, 1], [0, 1], [0, 1], [0, 1]]
    _C.WSL.SAMPLING.BATCH_SIZE_PER_IMAGE = [4096, 4096, 4096, 4096]
    _C.WSL.SAMPLING.POSITIVE_FRACTION = [1.0, 1.0, 1.0, 1.0]
    # cascade refinement: branch k>0 augments its proposal set with boxes
    # mined from branch k-1 (reference roi_heads_all.py:2888,3081-3099)
    _C.WSL.CASCADE_ON = False

    # route MOIPool through the reference-exact rank-compacted formulation
    # (wsl/ops.moi_pool_exact, pinned against the CUDA kernel) instead of the
    # TPU-fast fixed-grid kernel. Exact is gather-heavy — for fidelity
    # studies, not production throughput.
    _C.WSL.MOI_POOL_EXACT = False

    # static capacities for the WSL plane (TPU)
    # MOIPool superpixel-membership sampling grid (pixels): samples read the
    # superpixel id of the stride-g cell containing them. 1 = exact per-pixel
    # (slow scalar gathers on TPU); 4 keeps the whole membership path on the
    # MXU with <= g/2 px quantization (MCG superpixels are tens of px across)
    _C.WSL.SP_GRID_STRIDE = 4
    # MOIPool masked max as a 0/1 multiply (exact when the pooled features
    # are nonnegative — true for every WSL backbone, which all end in ReLU;
    # set False for a backbone with signed outputs to use the -1e30 form)
    _C.WSL.MOI_NONNEG_FEATURES = True
    # padded proposal capacity R is DATASETS.PRECOMPUTED_PROPOSAL_TOPK_*
    _C.WSL.MAX_SUPERPIXELS = 1024  # padded superpixel capacity S
    # test-time detection visualization dumps (reference roi_heads_*.py
    # vis_test; wired via Trainer.on_test_outputs -> OUTPUT_DIR/vis_test)
    _C.WSL.VIS_TEST = False
    # UWSOD: when True the mined PGT boxes are NOT used as regression
    # targets — deltas regress to identity (reference roi_heads_uwsod.py
    # :1292: gt_boxes are left unset so box_reg falls back to the proposal)
    _C.WSL.CLS_AGNOSTIC_BBOX_KNOWN = False

    _C.MODEL.MRRP = CN()
    _C.MODEL.MRRP.MRRP_ON = False
    _C.MODEL.MRRP.NUM_BRANCH = 3
    _C.MODEL.MRRP.BRANCH_DILATIONS = [1, 2, 3]
    _C.MODEL.MRRP.TEST_BRANCH_IDX = 1
    _C.MODEL.MRRP.MRRP_STAGE = "res4"

    # DAN box head
    _C.MODEL.ROI_BOX_HEAD.DAN_DIM = [4096, 4096]

    # two-class (FG/BG) seg head used by JTSM VOC configs
    _C.MODEL.SEM_SEG_HEAD.ASSP_CONVS_DIM = 256
    _C.MODEL.SEM_SEG_HEAD.MASK_SOFTMAX = False
    _C.MODEL.SEM_SEG_HEAD.CONSTRAINT = ""

    # validation split names + proposal pickles (reference defaults.py:40-43)
    _C.DATASETS.VAL = ()
    _C.DATASETS.PROPOSAL_FILES_VAL = ()
    # WSOD convention: TTA evaluation also runs on the TRAIN datasets
    # (corloc-style eval-on-train, reference train_net.py:220-253)
    _C.TEST.EVAL_TRAIN = True

    if "VGG" not in _C.MODEL:
        _C.MODEL.VGG = CN()
        _C.MODEL.VGG.DEPTH = 16
        _C.MODEL.VGG.OUT_FEATURES = ["plain5"]
        _C.MODEL.VGG.CONV5_DILATION = 1
