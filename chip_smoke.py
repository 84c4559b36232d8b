#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``jtsm_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py [--baseline DIR]

Phases, in order; any failure ends the run with a non-zero exit:

1. device: the card's name and power limit;
2. build: every CUDA kernel of the served and trained paths, compiled with
   nvcc from the sources in this checkout (and, with ``--baseline DIR``, the
   same C interfaces from the sources in DIR, an earlier version of
   ``jtsm_tpu_torch/ops/csrc``, into a temporary directory, to time beside
   them);
3. kernels: K1 against its plain PyTorch version at the shapes the served
   path gives it, in float32 and bfloat16, with the stated tolerance, timed
   with CUDA events beside its bound (and beside the baseline, in turns),
   both as calls issued back to back (host cost per call included) and as
   the device's time alone;
4. serve: Mask R-CNN R50-FPN at full width (random weights from a seed)
   answers 8 requests of one 800x1344 image in each of its configured
   TPU.COMPUTE_DTYPE (bfloat16) and float32, the two in turns; every
   kernel's launch count is set to 0 before and read after, and K1 must run
   twice a request in each; then each stage's time and host syncs;
5. trained weights: the committed gate checkpoint (a narrow R50, float32) on
   one seeded image, through the kernel and through the plain version on
   the card, must give the same detections;
6. training kernels: K1 and K2 (the ROIAlign backward) against their plain
   versions at the flagship's training shapes (B=2 at 800x1344, 1024 box
   ROIs at P=7 and 256 mask ROIs at P=14) in float32 and bfloat16, timed
   beside their bounds (and the baseline); then both kernels against their
   plain versions on the edge cases of ``tests/test_torch_kernels.py``;
7. train: the flagship at full width (random weights from a seed) takes 5
   SGD steps on a seeded synthetic batch of 2 images at 800x1344, in
   bfloat16 and in float32; every loss must be finite, and K1 and K2 must
   each launch 2 times a step in each;
8. train, kernel against plain: one float32 step from the gate checkpoint
   through K1/K2 and through the plain forward and backward on the card must
   give the same losses and gradients;
9. score: (a) the committed gate checkpoint (float32) scores the 8 synthetic
   COCO scenes of its gate (``data.datasets.synthetic``, the seed and count
   of ``tests/test_inference_gates.py``, before JPEG encoding) through
   ``engine.defaults.test`` on the card (K1, paste on the card) and on this
   machine's CPU (plain pooler, paste on the CPU): the COCO result lists must
   hold the same detections (boxes within 1e-3 px, scores within 1e-4,
   each mask's IoU at least 0.999), the CPU run's outputs pasted on the
   card must give the CPU's masks pixel for pixel, and bbox and segm AP
   must agree within 0.02; then the same on
   the card in bfloat16, reported beside float32; K1 must launch twice an
   image in each run on the card; (b) the flagship at full width (random
   weights from phase 4's seed) scores 16 synthetic scenes of 480x640,
   resized to 800 (max 1333), in bfloat16 and float32 in turns, with the
   seconds per image of each stage (data, model, paste, RLE encode,
   COCOEval), K1's launches and the peak memory, and the model's time alone
   on the same batches collated beforehand; its AP is printed, not checked
   (random weights);
10. jtsm: (a) K1 against its plain version at the JTSM mask pooler's shape
   (one level, a (1, 64, 64, 512) res5 map, R=100, P=14) in float32 and
   bfloat16, timed beside its bound; (b) the JTSM flagship
   (``jtsm_WSR_18_DC5_1x.yaml``, test-time augmentation off) at full width
   with random weights from a seed serves 8 requests in each of bfloat16
   and float32, in turns: one VOC-size 375x500 image resized to 688x917 in
   the 1024x1024 bucket, 4000 seeded proposals (the last 150 padding),
   1000 Voronoi superpixels and their membership; K1 must launch once a
   request and the plain ROIAlign never; then the stage split with its
   host syncs and the peak memory; (c) the committed JTSM gate checkpoint
   on two seeded 128x176 requests on the card against the CPU: detections
   matched by (source proposal, class), boxes within 1e-3 px, scores and
   mask probabilities within 1e-4, so that a mask pixel lands on the other
   side of 0.5 only within 1e-4 of it (each mask's IoU is reported);
   detections may trade slots only with a score within 1e-4
   (``match_detections``);
11. jtsm train: (a) K1 and K2 against their plain versions at the JTSM
   mask pooler's train shape (a (4, 64, 64, 512) res5 map, R=256 mined
   boxes, P=14) in float32 and bfloat16, timed beside their bounds; (b) the
   JTSM flagship at full width and depth (random weights from phase 10's
   seed) takes 5 SGD steps in each of bfloat16 and float32, in turns, on
   IMS_PER_BATCH 4 seeded requests of phase 10's kind with seeded image
   labels; every loss must be finite, K1 must launch once a step and K2
   never (FREEZE_AT 5: no gradient reaches the maps), and the plain
   ROIAlign never runs; then the stage split with its host syncs, peak
   memory, and one step at the largest train scale (short side 1200);
   (c) the JTSM gate config (FREEZE_AT 0, the full-model clip, seeded
   weights, dropout 0) takes 3 steps on the card and on the CPU from the
   same weights and batch: the mined mask ROIs and the painted pseudo
   sem-seg map equal, losses within 1e-4 relative, every parameter within
   1e-5 of its scale after the steps, K1 and K2 once a step on the card;
12. jtsm score: (a) the committed JTSM gate checkpoint scores the 12 scenes
   of the dev script's cocovar tree, made in memory before JPEG
   (``data.datasets.synthetic``), through the WSL test loader, panoptic
   fusion and the COCO, SemSeg and panoptic evaluators
   (``engine.defaults.test``), on the card (K1 once an image, the plain
   ROIAlign stubbed to raise on the card) and on this machine's CPU:
   detections matched by (source proposal, class) as in phase 10(c), the
   fused sem-seg maps equal but where the two largest upsampled logits lie
   within 1e-4, and bbox AP, segm AP, mIoU and PQ within 0.02; (b) the JTSM
   flagship at full width (phase 10's random weights, test-time
   augmentation off) scores 8 seeded VOC-shaped 375x500 scenes at 688x917
   (4000 proposals, 1000 superpixels, 1-3 VOC things over the background
   stuff, registered with the VOC panoptic-separated metadata) in
   bfloat16 and float32, 2 runs each in turns: K1 once an image, the four
   tasks' numbers present (printed, not checked: random weights), the
   seconds per image of each stage (data, model, fusion, paste, encode,
   each evaluator, total) and the peak memory;
13. jtsm tta: (a) the committed JTSM gate checkpoint scores 6 of the 12
   in-memory cocovar scenes with test-time augmentation (short sides 112
   and 128, long side at most 176, and the flips: 4 views) through the WSL
   command's ``test_with_TTA`` (TTA-AVG: mean class scores and sem-seg
   logits over the views, the mask re-run on the merged boxes, fusion, the
   three evaluators), on the card (the plain ROIAlign stubbed to raise
   there) and on this machine's CPU: merged detections matched by class
   and box, boxes within 1e-3 px, scores, re-run mask probabilities and
   merged logits within 1e-4, the four numbers within 0.02, K1 twice a
   view; (b) K1 against its plain version at the mask pooler's shape in
   the largest view of a VOC image (one level, (1, 75, 100, 512), R=100,
   P=14) in float32 and bfloat16, timed beside its bound; then the JTSM
   flagship (phase 10's random weights, TEST.AUG as configured: 5 short
   sides and their flips, 10 views, 20 passes an image) scores 4 seeded
   VOC scenes in bfloat16 and float32, 2 runs each in turns, with
   TPU.IMAGE_BUCKETS that hold every view (a cut: no default bucket holds
   the 1200 view): K1 20 times an image, the seconds per image of each
   stage (the views' resize, their passes, the logits' copy and resize,
   the merge, the mask re-run, fusion, paste, encode, each evaluator,
   total), the same scenes without TTA for the ratio, and the peak memory;
   (c) the Mask R-CNN gate checkpoint with TTA (TTA-UNION, the masks
   re-run) on 2 in-memory scenes on the card against the CPU: merged
   detections matched, boxes within 1e-3 px, scores and re-run mask
   probabilities within 1e-4, bbox AP within 0.02;
14. train_cli: the port trains as its command line does. (a) Mask R-CNN
   R50-FPN at full width in bfloat16 (phase 4's seed, the FrozenBN
   statistics calibrated by ``family_train_state``: from the raw seeded
   backbone the bf16 losses can reach NaN within 20 iterations) through
   ``engine.DefaultTrainer`` built from the config object, on 16
   in-memory synthetic COCO scenes of 480x640 with polygon masks, the
   yaml's augmentation (short side chosen from 640-800, max 1333, the
   flip), IMS_PER_BATCH 2 (the reference's 16 is 8 cards x 2), 20
   iterations with checkpoints every 10, at DATALOADER.NUM_WORKERS 0 and
   4: every loss finite, K1 and K2 twice an iteration, the plain ROIAlign
   stubbed to raise on the card, ``metrics.json`` with iterations 0-19,
   ``model_0000009.pth``, ``model_final.pth`` and ``last_checkpoint``
   written; printed: the median s/iter and ``data_time`` over iterations
   5-19, the loader's own s/batch, the bare train step on batches collated
   beforehand (phase 7's measure) and the peak memory; (b) a fresh
   trainer resumed from ``model_0000009.pth``: its parameters, momentum
   buffers, generator state and update count equal the checkpoint's, its
   first learning rate the uninterrupted run's at iteration 10, and it
   runs to 20; (c) the JTSM flagship at full width (random weights from
   phase 10's seed) through the WSL trainer, ITER_SIZE 4, IMS_PER_BATCH 4,
   the five train scales and the flip, on 8 seeded VOC-size scenes with
   4000 proposals and 1000 superpixels each, 8 mini-batches, with
   TPU.IMAGE_BUCKETS that hold the 1200 scale (a cut: no default bucket
   does) and TEST.EVAL_PERIOD 0: the parameters unchanged after
   mini-batches 1-3 and 5-7 and moved at 4 and 8, K1 once a mini-batch, K2
   never; s/iter, ``data_time`` and peak memory printed; (d) the Mask
   R-CNN gate (float32) for 3 iterations through the trainer on the card,
   once with K1/K2 and once with the plain ROIAlign, from the same weights
   and data: the losses within 1e-4 relative;
15. families: the other core meta-architectures, served and scored. (a)
   each committed gate checkpoint (Panoptic FPN, RetinaNet, the RPN alone,
   Keypoint R-CNN; float32) scores the 8 in-memory synthetic scenes of its
   gate (the separated panoptic set, the instance set, the person keypoint
   set) through ``engine.defaults.test`` with the evaluators that
   ``build_evaluator`` picks, on the card and on this machine's CPU (the
   plain ROIAlign stubbed to raise on the card): detections (or proposals)
   matched by image, class and box, boxes and keypoint x, y within 1e-3 px
   of the network's input, scores, mask probabilities and sem-seg logits
   within 1e-4 of their scale, a keypoint on another bin only where its two
   maxima lie within 1e-4 of the logits' scale, a detection on one side
   only at the cut or where the other side holds a higher-scored one of
   its class overlapping it at the NMS threshold (less 1e-3) that
   suppressed it there; bbox and segm AP, mIoU, PQ, AR@100 and
   AR@1000, keypoints AP equal to the CPU's to four decimals; K1 twice an
   image for Panoptic FPN (box and mask poolers) and Keypoint R-CNN (box and
   keypoint poolers), never for RetinaNet and the RPN; (b) each family at
   full width and depth (``panoptic_fpn_R_50_cfg()``,
   ``retinanet_R_50_FPN_cfg()``, ``rpn_R_50_FPN_cfg()``,
   ``keypoint_rcnn_R_50_FPN_cfg()``; random weights from a seed) serves 8
   requests of one 800x1344 image in each of bf16 (as configured) and f32,
   in turns: outputs of the expected shapes and finite, K1 launched 2, 0,
   0 and 2 times a request; then the stage split (backbone, RPN or
   RetinaNet head, decode with top-k and NMS, the box branch, the mask or
   keypoint branch, the sem-seg head, the panoptic fusion) with its host
   syncs, the weights' and the request's peak memory; (c) K1 against its
   plain version at the keypoint pooler's shape (the 100 detections of a
   Keypoint R-CNN request over an 800x1344 pyramid, C=256, P=14) in float32
   and bfloat16, timed beside its bound;
16. wsod: the WSOD baselines (``GeneralizedRCNNWSL`` with WSDDN, OICR and PCL
   on WSR-18 DC5, OICR on VGG16 DC5). (d) K1 at their box pooler's shapes,
   one level of the 1024x1024 bucket of a 688x917 request at P=7 with
   2000 proposals a request (serve: (1, 64, 64, 512) res5 and (1, 128,
   128, 512) plain5; train: 4 images, R=8000), and K2 at VGG16's train
   shape, in float32 and bfloat16 against the plain versions, timed beside
   their bounds; (a) the narrow configurations (``wsod_*_narrow_cfg``,
   seeded weights) on the card against this machine's CPU: a two-request
   batch's detections matched by (source proposal, class), 8 in-memory VOC
   scenes (``data.datasets.synthetic_voc``) scored through the WSL test
   loader and the VOC evaluator, AP and CorLoc within 1e-4, three train
   steps (dropout 0, no clip, at rates under which each update moves the
   next losses) with the losses within 1e-4 relative and each update
   within 2e-3 of its norm, and OICR scored with TEST.AUG (TTA-AVG) within
   1e-4; these launches count in no total; (b) each of the
   four full-width configurations (random weights from a seed) serves 4
   requests of one 375x500 image at 688x917 with 2000 seeded proposals in
   each of bf16 (as configured) and f32, in turns: K1 once a request, the
   detections finite, PCL without per-proposal class scores; then the
   stage split (backbone, pool, dan, heads, nms) with its host syncs, the
   weights' and the request's peak memory; (c) each full-width config's
   train step at IMS_PER_BATCH 4 in bf16 and f32, in turns (median of steps
   2-3, the stage split, the step's peak memory; K1 once a step, K2 once
   under VGG16's FREEZE_AT 2 and never under WSR-18's FREEZE_AT 5), and
   OICR on each backbone through the WSL trainer on 8 in-memory VOC scenes
   with 2000 proposals (4 mini-batches at ITER_SIZE 4 for WSR-18, 4 at 1
   for VGG16; s/iter, ``data_time``, the parameters moving at each
   ITER_SIZE-th mini-batch only); this depth is cut from the earlier
   8 requests, 5 steps and 8 mini-batches on WSR-18 to make room for phase
   20;
17. dense_train: RetinaNet and the RPN alone train. (a) each narrow gate
   config (the committed gate weights, float32) takes 3 steps on the card
   and on this machine's CPU from the same weights on one seeded batch of
   2 images of 128x176, in the sampling regime in which both sample the
   same slots (an RPN slot for every anchor and an ROI slot for every
   proposal and ground-truth row, at positive fraction 1.0), without a
   clip, at rates under which the total loss falls at each step: each
   step's losses within 1e-4 relative and each update within 3e-3 of its
   norm (``FAM_LOSS_TOL``, ``FAM_UPDATE_TOL``); (b) each at full width and
   depth (``retinanet_R_50_FPN_cfg()``, ``rpn_R_50_FPN_cfg()``; seeded
   weights, ``family_train_state``) takes 6 steps of 2 seeded images at
   800x1344 in each of bf16 (as configured) and f32, in turns: every loss
   finite, no kernel launched; the median of steps 2-6, the stage split
   (backbone, head or RPN, losses, backward, SGD) with its host syncs, the
   step's peak memory;
18. families_train: Keypoint R-CNN, Panoptic FPN and SemanticSegmentor
   train. (c) K1 and K2 against their plain versions at the keypoint
   pooler's train shape (B=2, 128 foreground ROIs an image, P=14, C=256
   over an 800x1344 pyramid) in float32 and bfloat16, timed beside their
   bounds; (a) as 17(a) for their narrow configs (SemanticSegmentor:
   Panoptic FPN's gate without its instance branches); (b) as 17(b) for
   ``keypoint_rcnn_R_50_FPN_cfg()``, ``panoptic_fpn_R_50_cfg()`` and
   ``semantic_R_50_FPN_cfg()``: K1 and K2 2 and 2 times a step (box and
   keypoint, box and mask poolers), 0 for SemanticSegmentor, the plain
   ROIAlign stubbed to raise on the card; (d) Keypoint R-CNN at full
   width in bf16 through ``engine.DefaultTrainer`` on 8 in-memory person
   keypoint scenes of 480x640 (the yaml's short sides and the flip,
   IMS_PER_BATCH 2, 6 iterations): K1 and K2 twice an iteration, s/iter,
   ``data_time`` and peak memory;
19. train_surface: (a) the narrow giou, pred-boxes and SyncBN Mask R-CNNs
   (the gate config with each variant's losses, TRAIN_ON_PRED_BOXES or
   norms) take 3 steps (SyncBN 1) on the card, on this machine's CPU in
   float32 and in float64: the card's losses, updates and SyncBN's running
   statistics within 3 times the CPU's float32-to-float64 gap (at least
   18(a)'s tolerances), and WSDDN R-18 DC5 narrowed takes 3 steps on a
   batch of its cropped train loader (INPUT.CROP), as 16(a) checks; the
   CPU runs with PyTorch's own convolutions; (b) ``mask_rcnn_R_50_FPN_{giou,pred_boxes,syncbn}_cfg()``
   at full width as 18(b): K1 and K2 twice a step, the median of steps
   2-6, the stage split with its host syncs, the peak memory; then K1 and
   K2 against their plain versions at the pred-boxes mask pooler's own
   inputs (the predicted boxes, some past the image); (c) WSDDN R-18 DC5
   at full width through the WSL trainer on 8 in-memory VOC scenes with
   2000 proposals, the yaml's 24 scales with the crop first (buckets up to
   1216x1824 added), 4 iterations of 4 images: K1 and K2 once an
   iteration; then both against their plain versions at its res5 train
   shape (the batch's 4000 proposal slots an image, the padded ones with a
   zero cotangent); (d) the SyncBN model at full width through ``DefaultTrainer`` on
   8 in-memory COCO scenes, 6 iterations, with TEST.PRECISE_BN (every 3
   iterations over 2 batches), then with ADAM and WarmupPolyLR: K1 and K2
   twice an iteration (K1 twice more a PreciseBN batch), every running
   statistic moved, s/iter, ``data_time`` and PreciseBN's time;
20. wsod_zoo: Cascade OICR, OICR with per-branch sampling, PCL with GAM,
   ContextLocNet and CMIL (``config.WSOD_ZOO``, seven yamls). (d) K1 and K2
   against their plain versions at the new launch sites, in float32 and
   bfloat16, timed beside their bounds: the GAM-attended WSR-18 res5 map
   (serve B=1 R=2000, train B=4 R=8000; then ``conv6``'s gradient through
   K1 and K2 against the plain forward and backward, within 1e-4), the
   cascade's mined rows (B=4, 640 an image) and CMIL's VGG16 plain5 (B=4,
   R=8000); (a) the five heads' narrow configurations on the card against
   this machine's CPU (detections matched by (source proposal, class); one
   step's losses and update within max(1e-4 and 2e-3, 3 x the CPU's
   float32-to-float64 gap)), and ``roi_loop_pool``, ``roi_label`` and
   ``roi_merge`` on the card against the CPU; these launches count in no
   total; (b) each full-width configuration (seeded weights) serves 4
   requests of 16(b) in each of bf16 and f32 (8 before PR 19), in turns: K1 once a request
   (never for ContextLocNet), then the stage split (backbone, attend,
   pool or loop_pool, dan, heads, nms) with its host syncs and each
   stage's peak memory; (c) its train step at IMS_PER_BATCH 4 in both, in
   turns (median of steps 2-6; K1 once a step, 4 times for Cascade OICR,
   never for ContextLocNet; K2 under each K1 launch where the map trains:
   VGG16's, GAM's), the stage split (..., merge and label for CMIL, losses,
   backward, sgd) with each stage's peak memory (``loop_pool``'s is
   ``roi_loop_pool``'s); (e) CMIL on WSR-18 through the WSL trainer on 8
   in-memory VOC scenes with 2000 proposals (ITER_SIZE 4, 8 mini-batches:
   K1 once a mini-batch, K2 never);
21. csc_uwsod: CSC on WSR-18 and VGG16, CSC-OICR on VGG16 (and its
   reg_last form), WSJDS on VGG16 with its ASPP head (the builder
   ``wsjds_V_16_DC5_cfg``), UWSOD on the multi-rate VGG16 with ``RPNWSL``.
   (d) K1 and K2 against their plain versions at the new launch sites, in
   float32 and bfloat16, timed beside their bounds: the CPG pass's VGG16
   box pooler (B=4, R=8000) and UWSOD's branch-averaged plain5 (serve B=1
   R=2048, train B=4 R=8192); (a) the narrow CSC WSR-18 (every stage
   training), CSC-OICR, WSJDS with the CRF and UWSOD on the card against
   this machine's CPU (detections and WSJDS's masks matched by (source
   proposal, class), the CPG maps within max(2e-2, 3 x the CPU's
   float32-to-float64 gap), one step's losses and update as 20(a)), then
   ``csc_full`` and ``crf_mean_field`` at a train batch's shapes; these
   launches count in no total; (b) each full-width configuration serves 4
   requests of 16(b) in each of bf16 and f32 (UWSOD on its RPN's 2048
   proposals), in turns, K1 once a request, then the stage split
   (backbone, rpn, pool, dan, heads, nms, seg) with its host syncs and
   peak memory; (c) its train step at IMS_PER_BATCH 4 in both (median of
   steps 2-6), the CSC heads' CPG pass before each step (K1 once and K2
   once a backward where the map trains), its own ``cpg`` stage beside
   the step's; (e) csc_V_16 through the WSL trainer with WSL.CSC_MAX_ITER
   crossed (the maps, then the plain MIL loss) and uwsod_V_16 (no proposal
   files, MODEL.LOAD_PROPOSALS False), 8 in-memory VOC scenes;
22. c4_trident_fpn: the C4 family (Mask R-CNN R50-C4 and Faster R-CNN on
   the WS-ResNet-50's res4, ``Res5ROIHeads`` and ``WSRes5ROIHeads``),
   Trident OICR on the multi-rate WSR-18 and Faster R-CNN on the WSR-50 FPN
   (``config.C4_TRIDENT_FPN_ZOO``). (d) K1 and K2 against their plain
   versions at the new launch sites, in float32 and bfloat16, timed beside
   their bounds: the C4 res4 pooler of an 800x1344 pair, (2, 50, 84, 1024)
   at P=14 (serve 2 x 1000, the mask branch's 2 x 100, train 2 x 512 with
   K2) and Trident's branch-averaged res5 (serve B=1 R=2000, train B=4
   R=8000; K1 only, FREEZE_AT 5); (a) the four narrow models on the card
   against this machine's CPU (the supervised ones on the CPU's proposals
   and with every anchor and proposal a slot; detections, and one step's
   losses and update as 20(a)); these launches count in no total; (b) C4
   Mask R-CNN and the WSR-50 FPN at 800x1344 and Trident OICR at 688x917
   serve 4 requests in each of bf16 and f32, in turns (K1 twice a C4 Mask
   R-CNN request, once else), then the stage split (the C4 heads' pool,
   res5, box and mask) with its host syncs and peak memory; (c) their
   train steps in both (median of steps 2-6; K1 and K2 once a step, K2
   never under Trident's FREEZE_AT 5); (e) C4 Mask R-CNN through
   ``DefaultTrainer`` on 8 in-memory COCO scenes (K1 and K2 once an
   iteration);
23. cascade_dconv: Cascade Mask R-CNN R50-FPN, Mask R-CNN R50-FPN with
   deformable convolutions in res3-res5 and Fast R-CNN R50-FPN on
   precomputed proposals. (a) their narrow forms on the card against this
   machine's CPU (phase 22(a)'s rule): detections, the dconv backbone's FPN
   maps, one step's per-stage losses and update; (b) each at 800x1344 with
   seeded weights serves 4 requests in each of bf16 and f32, in turns (Fast
   R-CNN with 1000 seeded proposals), K1 4, 2 and 1 times a request, the
   stage split (the cascade's ``stage0``-``stage2``, ``nms`` and ``mask``)
   with host syncs and peak memory, and the deformable convolutions' time
   inside the dconv requests; (d) K1 against its plain version at the
   cascade's stage-1 and stage-2 pools (its decoded boxes) and on Fast
   R-CNN's proposals, K1 and K2 at the cascade's train pool (2x512 rows);
   (c) train steps of the three (median of steps 2-6; K1 and K2 4, 2 and 1
   times a step), the dconv step's deformable share; (e) the cascade
   through ``DefaultTrainer`` (K1 and K2 4 times an iteration); (f) the
   X-152 32x8d GN dconv cascade and the Panoptic FPN R-101 dconv cascade
   GN, one bf16 request each;
24. lvis_city: Mask R-CNN R50-FPN on LVIS v1 (1203 classes,
   SCORE_THRESH_TEST 0.0001, 300 detections) and on Cityscapes (8 classes,
   1024x2048 images, the added 1024x2048 bucket), seeded weights. (a) LVIS
   serves 4 800x1344 requests in each of bf16 and f32, in turns, K1 twice a
   request, the stage split (``box``, the ``sort`` of the R*K candidates to
   1024, ``nms``, ``mask``) with host syncs and peak memory, and one f32
   request on the card against this machine's CPU, detections matched by
   (proposal, class); (b) LVIS train steps (2 images at 800x1344, median of
   steps 2-6); (c) LVIS through ``DefaultTrainer`` (in-memory LVIS-form
   scenes, the repeat-factor sampler), then the Mask R-CNN gate carried
   onto LVIS's classes scored by ``LVISEvaluator`` on the card against the
   CPU (every number within 0.02); (d) the same for Cityscapes at 1024x2048
   (requests, one against the CPU, steps, the trainer,
   ``CityscapesInstanceEvaluator``); (e) K1 against its plain version at
   the LVIS mask pooler (R=300), K1 and K2 over the 1024x2048 pyramid at
   the serving and train poolers. Any phase that fails logs ``[<phase>]
   FAILED: <type>: <message>`` and its traceback, and the run ends there
   with a non-zero exit.

The last three lines are {"kernels": [...]} (``kernel_line`` says which
times; ``l1_*`` are K1's single-level rows of phase 10, ``jt_*`` K1's and
K2's rows at phase 11's train shape, ``js_launches`` its launches in phase
12, ``tta_*`` K1's row at phase 13's largest view and its launches there,
``tc_launches`` each kernel's launches under the trainers of phase 14,
``kp_*`` K1's row at phase 15's keypoint pooler shape and that pooler's
launches, ``fam_launches`` K1's launches in phase 15, ``wsod_*`` K1's and
K2's rows at phase 16's shapes and ``wsod_launches`` their launches on its
main paths, (b) and (c), each counted from 0 just before it and read just
after; ``kp_train_*`` K1's and K2's rows at phase 18's keypoint train
shape and their launches under the keypoint train steps of 18(b) and the
trainer of 18(d), ``pan_train_*`` Panoptic FPN's poolers, whose train
shapes are phase 6's box and mask rows, and their launches under its
steps in 18(b), ``fam_train_launches`` all of phase 18's main paths;
phase 17's launch none; ``pred_mask_*`` K1's and K2's rows at the
pred-boxes mask pooler of 19(b) and their launches under its steps,
``wsddn_train_*`` their rows at WSDDN R-18's cropped res5 train shape and
their launches under the trainer of 19(c), ``ts_launches`` all of phase
19's main paths; ``zoo_gam_*``, ``zoo_cascade_*`` and ``zoo_cmil_vgg_*``
their rows at phase 20(d)'s sites and each site's launches on phase 20's
main paths, ``zoo_launches`` all of them; ``csc_cpg_*`` and ``uwsod_*``
their rows at phase 21(d)'s sites, ``csc_launches`` their launches on
phase 21's main paths, ``cpg_launches`` those in its CPG passes,
``uwsod_launches`` K1's under UWSOD; ``c4_*`` and ``trd_*`` their rows
at phase 22(d)'s C4 res4 and Trident sites, ``wsr_fpn_*`` the WSR-50 FPN's
pooler rows (phase 3's and 6's box rows: the same pyramid),
``c4_launches``, ``trd_launches`` and ``wsr_fpn_launches`` each model's
launches on phase 22's main paths, ``c4_trident_fpn_launches`` all of
them; ``cascade_stage{1,2}_*``, ``cascade_step_*`` and ``fast_rcnn_*``
their rows at phase 23(d)'s sites, ``cascade_launches``,
``dconv_launches``, ``fast_rcnn_launches`` and ``combined_launches`` each
model's launches on phase 23's main paths, ``cascade_dconv_launches`` all
of them; ``lvis_mask_*`` K1's rows at phase 24(e)'s LVIS mask pooler,
``city_serve_box_*``, ``city_serve_mask_*``, ``city_train_box_*`` and
``city_train_mask_*`` K1's and K2's rows over the 1024x2048 pyramid,
``lvis_launches`` and ``city_launches`` each model's launches on phase 24's
main paths, ``lvis_city_launches`` all of them),
the card's name and power limit as
nvidia-smi gives them, and {"ok": true, "device": {...}}. Needs one card, torch, numpy and pytest;
imports nothing of JAX. Without a card, or outside a checkout of the
repository, it exits with 2 and prints no result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
FLOPS_PER_TAP_SAMPLE = 12  # 4 taps x (2 mul) + 3 adds + 1 accumulate, per channel
BWD_FLOPS_PER_SAMPLE = 8  # 4 taps x (1 mul + 1 accumulate), per channel
TOL_F32 = 1e-5  # same float ops in the same order; only the sum order differs
# both sides sum in f32 and round once to bf16; another summation order can
# move that rounding by one bf16 step, 2^-7 of the value's binade
TOL_BF16 = 2.0**-7

DEVICE = "cuda"
FLAGSHIP_HW = (800, 1344)
LEVEL_STRIDES = (4, 8, 16, 32)
TRAIN_BATCH = 2  # the per-card batch of the reference's 8-card IMS_PER_BATCH 16
TRAIN_STEPS = 5
SERVE_ROUNDS = 8  # requests in each dtype
STAGE_ROUNDS = 5
GATE_SCENES = 8  # tests/test_inference_gates.py: make_synthetic_coco.py --num 8
SCORE_SCENES = 16
SCORE_HW = (480, 640)  # COCO's usual image size
SCORE_ROUNDS = 2  # flagship scoring runs in each dtype, in turns
JTSM_IMAGE_HW = (375, 500)  # a VOC-size image
JTSM_ROUNDS = 8  # JTSM requests in each dtype
JTSM_PADDING = 150  # padded proposal slots of the 4000
JTSM_SUPERPIXELS = 1000  # Voronoi cells (WSL.MAX_SUPERPIXELS is 1024)
JTSM_TRAIN_STEPS = 5  # train steps in each dtype
JTSM_TRAIN_SHORT = 688  # an INPUT.MIN_SIZE_TRAIN scale, the one phase 10 serves
JTSM_TRAIN_LARGEST = (1200, (1216, 1600))  # the largest train scale and a canvas that holds it
JTSM_GATE_STEPS = 3
JTSM_FLAGSHIP_LOSSES = sorted(["loss_mil", "loss_mask", "loss_mask_r0", "total_loss"]
                              + [f"loss_refine_{k}{i}" for k in ("cls", "reg") for i in range(4)])
GATE_VAR_SCENES = 12  # the dev script's cocovar tree (--num-varied 12)
JTSM_SCORE_SCENES = 8
JTSM_SCORE_ROUNDS = 2  # flagship scoring runs in each dtype, in turns
DTYPE_NAMES = {"bfloat16": "bf16", "float32": "f32"}


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls, from CUDA events
    recorded around them as the host issues them: a call whose host cost
    (the wrapper's Python, ctypes and allocations) exceeds its device time
    is timed at its host cost. With ``queued`` the stream first
    sleeps a few milliseconds, so the host has queued every call before the
    first starts and the time is the device's alone."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(5_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def time_in_turns(fns: dict, reps: int = 20) -> dict:
    """``cuda_time_ms`` of each callable under both timers, twice each, in
    turns (a, b, b, a), and the mean of its two: versions compared on one
    card in one run. Returns {name: {"ms": t, "device_ms": t}}."""
    times = {k: {"ms": [], "device_ms": []} for k in fns}
    for queued, key in ((False, "ms"), (True, "device_ms")):
        for k in list(fns) + list(reversed(fns)):
            times[k][key].append(cuda_time_ms(fns[k], reps, queued))
    return {k: {key: sum(v) / len(v) for key, v in t.items()} for k, t in times.items()}


def roi_align_counts(features, scales, boxes, batch_indices, levels, p, sampling_ratio):
    """For these inputs: the feature cells the live samples tap (each
    counted once) and the number of live samples."""
    import torch

    from jtsm_tpu_torch.ops.roi_align import ADAPTIVE_MAX_RATIO, _axis_samples

    s = ADAPTIVE_MAX_RATIO if sampling_ratio == 0 else sampling_ratio
    touched, live_samples = 0, 0
    for lvl, (f, sc) in enumerate(zip(features, scales)):
        sel = levels.long() == lvl
        if not sel.any():
            continue
        h, w = f.shape[1], f.shape[2]
        bx = boxes[sel].float() * sc - 0.5
        bin_w, bin_h = (bx[:, 2] - bx[:, 0]) / p, (bx[:, 3] - bx[:, 1]) / p
        ry = torch.ceil(bin_h).clamp(1, s).long() if sampling_ratio == 0 else torch.full_like(bx[:, 0], s).long()
        rx = torch.ceil(bin_w).clamp(1, s).long() if sampling_ratio == 0 else ry
        n = bx.shape[0]

        def taps(origin, bin_size, ratio, size):
            sz = torch.full((n,), size, dtype=torch.long, device=boxes.device)
            lo, _, dead = _axis_samples(p, s, bin_size, origin, ratio, sz)
            hi = torch.minimum(lo + 1, sz[:, None, None] - 1)
            mask = torch.zeros((n, size + 1), dtype=torch.bool, device=boxes.device)
            for t in (lo, hi):
                mask.scatter_(1, torch.where(dead, size, t).reshape(n, -1), True)
            return mask[:, :size], (~dead).sum(dim=(1, 2))

        rows, ly = taps(bx[:, 1], bin_h, ry, h)
        cols, lx = taps(bx[:, 0], bin_w, rx, w)
        live_samples += int((ly * lx).sum())
        bidx = batch_indices[sel].long()
        for b in bidx.unique():
            m = bidx == b
            touched += int(((rows[m].float().T @ cols[m].float()) > 0).sum())
    return touched, live_samples


def roi_align_work(features, scales, boxes, batch_indices, levels, p, sampling_ratio):
    """Bytes the ROIAlign forward must move and float operations it must do
    for these inputs: the feature cells its live samples tap (each read
    once), the output written once, the per-ROI inputs; 12 operations per
    live sample and channel and one division per output."""
    esize = features[0].element_size()
    c = features[0].shape[-1]
    r = boxes.shape[0]
    touched, live_samples = roi_align_counts(features, scales, boxes, batch_indices, levels, p, sampling_ratio)
    nbytes = touched * c * esize + r * p * p * c * esize + r * (16 + 4 + 4)
    flops = live_samples * c * FLOPS_PER_TAP_SAMPLE + r * p * p * c
    return nbytes, flops


def roi_align_bwd_work(features, scales, boxes, batch_indices, levels, p, sampling_ratio):
    """Bytes the ROIAlign backward must move and float operations it must
    do: the cotangent and the per-ROI inputs read once and the gradient
    pyramid written once (every cell: those no sample taps are zeros); one
    division per cotangent element and 8 operations per live sample and
    channel. Also the bytes when only the touched cells are read and
    written, the accumulation's own traffic, for comparison."""
    esize = features[0].element_size()
    c = features[0].shape[-1]
    r = boxes.shape[0]
    touched, live_samples = roi_align_counts(features, scales, boxes, batch_indices, levels, p, sampling_ratio)
    cotangent = r * p * p * c * esize + r * (16 + 4 + 4)
    pyramid = sum(f.numel() for f in features) * esize
    flops = live_samples * c * BWD_FLOPS_PER_SAMPLE + r * p * p * c
    return cotangent + pyramid, flops, cotangent + 2 * touched * c * esize


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def flagship_pyramid(gen, c=256, dtype=None, batch=1, hw=FLAGSHIP_HW):
    import torch

    h, w = hw
    return [
        torch.randn((batch, h // s, w // s, c), generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)
        for s in LEVEL_STRIDES
    ]


def spread_boxes(gen, r, hw=FLAGSHIP_HW):
    """Boxes of log-uniform size from 8 to 800 px over an image of ``hw``:
    the FPN rule assigns them to all four levels."""
    import torch

    h, w = hw
    size = torch.exp(torch.empty(r, 2, device=DEVICE).uniform_(math.log(8), math.log(800), generator=gen))
    xy = torch.rand(r, 2, generator=gen, device=DEVICE) * torch.tensor([w, h], device=DEVICE) - size / 4
    return torch.cat([xy, xy + size], dim=1).contiguous()


def dtype_tag(t) -> str:
    import torch

    return "bf16" if t.dtype == torch.bfloat16 else "f32"


def format_times(times) -> str:
    """The kernel's times under both timers, and the baseline's when it ran."""
    text = f"kernel_ms={times['new']['ms']:.4f} kernel_device_ms={times['new']['device_ms']:.4f}"
    old = times.get("baseline")
    if old is None:
        return text + " baseline_ms=not measured"
    return text + f" baseline_ms={old['ms']:.4f} baseline_device_ms={old['device_ms']:.4f}"


def check_and_time_fwd(tag, feats, scales, boxes, bidx, levels, p, baseline, phase="kernels"):
    """K1 against its plain version at these inputs, then its time (in turns
    with the baseline's K1 when there is one), the plain version's, and the
    bound. Returns the row's numbers."""
    import torch

    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain
    from jtsm_tpu_torch.ops.roi_align_cuda import roi_align_multilevel_cuda

    args = (feats, scales, boxes, bidx, levels, p, 0, True)
    got = roi_align_multilevel_cuda(*args)
    want = roi_align_multilevel_plain(*args)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    scale = max(1.0, want.float().abs().max().item())
    tol = (TOL_BF16 if feats[0].dtype == torch.bfloat16 else TOL_F32) * scale
    fns = {"new": lambda: roi_align_multilevel_cuda(*args)}
    if baseline:
        old = baseline[0]
        fns["baseline"] = lambda: old.launch(feats, scales, boxes, bidx, levels, p, p, 0, True)
        if not (old.launch(feats, scales, boxes, bidx, levels, p, p, 0, True).float() - want.float()).abs().max().item() <= tol:
            raise AssertionError(f"roi_align_fwd {tag}: the baseline kernel disagrees with the plain version")
    times = time_in_turns(fns)
    p_ms = cuda_time_ms(lambda: roi_align_multilevel_plain(*args), 3)
    nbytes, flops = roi_align_work(feats, scales, boxes, bidx, levels, p, 0)
    b_ms, b_by = bound(nbytes, flops)
    per_level = [int((levels == i).sum()) for i in range(len(feats))]
    log(f"[{phase}] roi_align_fwd {tag}: R={boxes.shape[0]} P={p} C={feats[0].shape[-1]} rois/level={per_level} "
        f"max_abs_err={err:.3e} max_rel_err={err / scale:.3e} (tol {tol:.3e} abs, {tol / scale:.3e} of the "
        f"output's scale {scale:.3f}) {format_times(times)} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP) kernel/bound={times['new']['ms'] / b_ms:.2f}")
    if not err <= tol:
        raise AssertionError(f"roi_align_fwd {tag}: max_abs_err {err} > {tol}")
    return dict(err=err, times=times, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops)


def check_and_time_bwd(tag, feats, scales, boxes, bidx, levels, p, gen, baseline, phase="train_kernels", live=None):
    """K2 against its plain version, as ``check_and_time_fwd``; the
    cotangent is random, and zero on the ROIs that ``live`` (R,) excludes,
    as the loss leaves padded proposal slots."""
    import torch

    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_backward_plain
    from jtsm_tpu_torch.ops.roi_align_cuda import roi_align_multilevel_backward_cuda

    dtype = feats[0].dtype
    shapes = [tuple(f.shape) for f in feats]
    grad = torch.randn((boxes.shape[0], p, p, shapes[0][3]), generator=gen, device=DEVICE)
    if live is not None:
        grad = grad * live[:, None, None, None]
    grad = grad.to(dtype)
    args = (grad, shapes, scales, boxes, bidx, levels, p, 0, True)
    got = roi_align_multilevel_backward_cuda(*args)
    want = roi_align_multilevel_backward_plain(*args)
    torch.cuda.synchronize()
    contiguous = all(g.is_contiguous() and tuple(g.shape) == s for g, s in zip(got, shapes))
    err = max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))
    scale = max(1.0, max(w.float().abs().max().item() for w in want))
    tol = (TOL_BF16 if dtype == torch.bfloat16 else TOL_F32) * scale
    fns = {"new": lambda: roi_align_multilevel_backward_cuda(*args)}
    if baseline:
        old = baseline[1]
        fns["baseline"] = lambda: old.launch(grad, shapes, scales, boxes, bidx, levels, 0, True)
        old_err = max((g.float() - w.float()).abs().max().item() for g, w in zip(fns["baseline"](), want))
        if not old_err <= tol:
            raise AssertionError(f"roi_align_bwd {tag}: the baseline kernel disagrees with the plain version")
    times = time_in_turns(fns)
    p_ms = cuda_time_ms(lambda: roi_align_multilevel_backward_plain(*args), 3)
    nbytes, flops, touched_bytes = roi_align_bwd_work(feats, scales, boxes, bidx, levels, p, 0)
    b_ms, b_by = bound(nbytes, flops)
    log(f"[{phase}] roi_align_bwd {tag}: R={boxes.shape[0]} P={p} max_abs_err={err:.3e} "
        f"max_rel_err={err / scale:.3e} (tol {tol:.3e} abs, {tol / scale:.3e} of the gradient's scale "
        f"{scale:.3f}) {format_times(times)} plain_ms={p_ms:.4f} bound_ms={b_ms:.4f} "
        f"({b_by}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; touched cells read and written once: "
        f"{touched_bytes / 1e6:.1f} MB, {touched_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms) "
        f"kernel/bound={times['new']['ms'] / b_ms:.2f} contiguous (B, H, W, C) gradients: {contiguous}")
    if not err <= tol:
        raise AssertionError(f"roi_align_bwd {tag}: max_abs_err {err} > {tol}")
    if not contiguous:
        raise AssertionError(f"roi_align_bwd {tag}: gradients not contiguous (B, H, W, C)")
    return dict(err=err, times=times, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, nbytes=nbytes, flops=flops)


def phase_kernels(gen, baseline):
    """K1 at the served path's shapes, in float32 and bfloat16, and the
    single-level case (K1b's shape)."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32)
    pyr16 = [f.to(torch.bfloat16) for f in pyr32]
    single = [torch.randn((2, 50, 84, 256), generator=gen, device=DEVICE)]
    cases = [
        # name, features, scales, R, P, batch
        ("box pooler f32", pyr32, scales, 1000, 7, 1),
        ("mask pooler f32", pyr32, scales, 100, 14, 1),
        ("box pooler bf16", pyr16, scales, 1000, 7, 1),
        ("mask pooler bf16", pyr16, scales, 100, 14, 1),
        ("single level f32 (L=1, B=2)", single, [1.0 / 16], 512, 14, 2),
    ]
    results = {}
    for name, feats, scs, r, p, batch in cases:
        boxes = spread_boxes(gen, r)
        if len(feats) > 1:
            levels = assign_boxes_to_levels(boxes, 2, 5)
        else:
            levels = torch.zeros(r, dtype=torch.int32, device=DEVICE)
        bidx = torch.randint(0, batch, (r,), generator=gen, device=DEVICE, dtype=torch.int32)
        results[name] = check_and_time_fwd(name, feats, scs, boxes, bidx, levels, p, baseline)
    return results


def request(rng, image_hw, true_hw, orig_hw):
    import numpy as np

    h, w = image_hw
    img = np.zeros((1, h, w, 3), np.float32)
    th, tw = true_hw
    img[0, :th, :tw] = rng.uniform(0, 255, (th, tw, 3)).astype(np.float32)
    return {
        "image": img,
        "image_sizes": np.array([true_hw], np.int32),
        "orig_sizes": np.array([orig_hw], np.int32),
    }


def check_detections(out, d, s):
    import torch

    shapes = {"boxes": (1, d, 4), "scores": (1, d), "classes": (1, d), "valid": (1, d), "masks": (1, d, s, s)}
    for k, shape in shapes.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{k} has shape {tuple(out[k].shape)}, expected {shape}")
        if not torch.isfinite(out[k].float()).all():
            raise AssertionError(f"{k} holds non-finite values")


def tf32_flags():
    import torch

    return torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32


def count_host_syncs(fn):
    """Runs ``fn`` and counts the operations in it that made the host wait
    for the card (PyTorch's sync debug mode warns once for each)."""
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_serve(kernel, dtypes, state):
    """The flagship answers SERVE_ROUNDS requests in each dtype after a
    warm-up in each, the dtypes in turns (a b, b a, ...) so that both meet
    the same host; then the first request split by stage, in turns too, and
    the host syncs of each stage. Returns K1's launches per dtype."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.layers import exact_float32

    rng = np.random.default_rng(0)
    h, w = FLAGSHIP_HW
    warm = request(rng, (h, w), (h, w), (h, w))
    reqs = [
        request(rng, (h, w), (h, w), (h, w)),
        request(rng, (h, w), (h, w), (480, 640)),
        request(rng, (h, w), (h - 50, w - 11), (h - 50, w - 11)),  # content smaller than the canvas
        request(rng, (h, w), (h, w), (h, w)),
    ]
    flags = tf32_flags()
    predictors, mem = {}, {}
    for d in dtypes:
        cfg = mask_rcnn_R_50_FPN_cfg()
        cfg.TPU.COMPUTE_DTYPE = d
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        predictors[d] = Predictor(cfg, state)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        predictors[d](warm)
        torch.cuda.synchronize()
        mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
    detections = cfg.TEST.DETECTIONS_PER_IMAGE, 2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION

    kernel.launches = 0
    lat = {d: [] for d in dtypes}
    valid = {d: [] for d in dtypes}
    launches = dict.fromkeys(dtypes, 0)
    for i in range(SERVE_ROUNDS):
        req = reqs[i % len(reqs)]
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            before = kernel.launches
            t0 = time.perf_counter()
            out = predictors[d](req)
            torch.cuda.synchronize()
            lat[d].append((time.perf_counter() - t0) * 1e3)
            check_detections(out, *detections)
            launches[d] += kernel.launches - before
            if kernel.launches - before != 2:
                raise AssertionError(f"{d} request {i}: roi_align_fwd launched {kernel.launches - before} times, not 2")
            bh, bw = req["orig_sizes"][0]
            boxes = out["boxes"][0]
            if (boxes[:, 2] > bw).any() or (boxes[:, 3] > bh).any() or (boxes < 0).any():
                raise AssertionError(f"{d} request {i}: boxes leave the original image")
            valid[d].append(int(out["valid"].sum()))
    if kernel.launches == 0:
        raise AssertionError("roi_align_fwd was not launched on the served path")
    if tf32_flags() != flags:
        raise AssertionError(f"serving changed the caller's TF32 flags {flags} to {tf32_flags()}")
    for d in dtypes:
        tag = DTYPE_NAMES[d]
        log(f"[serve] R50-FPN Mask R-CNN 800x1344 {tag}, {SERVE_ROUNDS} requests in turns with "
            f"{'/'.join(DTYPE_NAMES[o] for o in dtypes if o != d)}: latency_ms={[round(x, 3) for x in lat[d]]} "
            f"mean_ms={sum(lat[d]) / len(lat[d]):.3f} median_ms={sorted(lat[d])[len(lat[d]) // 2]:.3f} "
            f"valid_detections={valid[d]} roi_align_fwd_launches={launches[d]} "
            f"weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")

    # where a request's time goes: the model's stages one by one on the
    # first request, each ended by a synchronize (host clock, median of
    # STAGE_ROUNDS runs, the dtypes in turns); then one more run of each
    # stage counting its host syncs
    def run_stages(model, measure):
        """The three stages of ``req`` through ``model``; ``measure`` makes
        each call and returns its reading."""
        r = {}
        with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
            readings = {
                "backbone": measure(lambda: r.update(zip(("feats", "sizes"), model._features(req)))),
                "rpn": measure(lambda: r.update(zip(("proposals", "scores", "_"), model.proposal_generator(
                    r["sizes"], r["feats"])))),
                "roi_heads": measure(lambda: model.roi_heads(r["feats"], r["proposals"], r["scores"], r["sizes"])),
            }
        return readings, r["feats"].values()

    def timed(call):
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    req = reqs[0]
    stage_ms = {d: {} for d in dtypes}
    for i in range(STAGE_ROUNDS):
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            for k, ms in run_stages(predictors[d].model, timed)[0].items():
                stage_ms[d].setdefault(k, []).append(ms)
    for d in dtypes:
        syncs, feats = run_stages(predictors[d].model, count_host_syncs)
        if not all(f.is_contiguous(memory_format=torch.channels_last) for f in feats):
            raise AssertionError(f"{d}: the FPN maps are not channels-last")
        log(f"[serve] {DTYPE_NAMES[d]} stages_ms (median of {STAGE_ROUNDS}) "
            + " ".join(f"{k}={sorted(v)[len(v) // 2]:.3f}" for k, v in stage_ms[d].items())
            + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
            + f" | FPN maps {sorted({str(f.dtype) for f in feats})}, channels-last (free NHWC views for the poolers)")
    return launches


def phase_trained():
    import numpy as np
    import torch

    import jtsm_tpu_torch.modeling.poolers as poolers
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain

    cfg = mask_rcnn_gate_cfg()
    model = build_model(cfg)
    model.load_state_dict(variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS))))
    rng = np.random.RandomState(1)
    h, w = 128, 176
    img = np.full((h, w, 3), 128.0, np.float32)
    img[: h // 2] = [205, 115, 95]
    img[h // 2:] = [95, 175, 95]
    for _ in range(4):
        y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
        img[y0: y0 + rng.randint(20, 60), x0: x0 + rng.randint(20, 60)] = rng.randint(55, 255, 3)
    img += rng.randn(h, w, 3).astype(np.float32) * 3
    batch = {"image": img[None], "image_sizes": np.array([[h, w]], np.int32),
             "orig_sizes": np.array([[2 * h, 2 * w]], np.int32)}
    torch.backends.cudnn.deterministic = True
    kernel_out = model.inference(batch)
    # the same model with its poolers calling the plain version on the card
    routed = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = roi_align_multilevel_plain
    try:
        plain_out = model.inference(batch)
    finally:
        poolers.roi_align_multilevel = routed
    torch.cuda.synchronize()
    k = {n: v.float().cpu() for n, v in kernel_out.items()}
    p = {n: v.float().cpu() for n, v in plain_out.items()}
    n_valid = int(k["valid"].sum())
    if n_valid == 0:
        raise AssertionError("the trained gate model found nothing on its synthetic scene")
    if not (torch.equal(k["valid"], p["valid"]) and torch.equal(k["classes"], p["classes"])):
        raise AssertionError("kernel and plain paths disagree on valid detections or classes")
    errs = {n: (k[n] - p[n]).abs().max().item() for n in ("boxes", "scores", "masks")}
    tols = {"boxes": 1e-3 * max(h, w), "scores": 1e-4, "masks": 1e-4}
    log(f"[trained] gate checkpoint ({cfg.TPU.COMPUTE_DTYPE}), 1 image {h}x{w}: valid_detections={n_valid} "
        f"classes={kernel_out['classes'][0][kernel_out['valid'][0]].tolist()[:10]} "
        f"max_abs_err={errs} tol={tols}")
    for n in errs:
        if not errs[n] <= tols[n]:
            raise AssertionError(f"kernel vs plain {n}: {errs[n]} > {tols[n]}")


def phase_train_kernels(gen, baseline):
    """K1 and K2 against their plain versions at the training shapes: B=2,
    the flagship pyramid, 1024 box ROIs (P=7) and 256 mask ROIs (P=14), in
    float32 and bfloat16; then the edge cases of the card-only tests."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32, batch=TRAIN_BATCH)
    results = {}
    for pooler, r, p in (("box", 1024, 7), ("mask", 256, 14)):
        boxes = spread_boxes(gen, r)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        # image-major, as the train step pools them
        bidx = torch.arange(TRAIN_BATCH, dtype=torch.int32, device=DEVICE).repeat_interleave(r // TRAIN_BATCH)
        for dtype in (torch.float32, torch.bfloat16):
            feats = [f.to(dtype) for f in pyr32]
            name = f"{pooler} pooler {dtype_tag(feats[0])}"
            results[f"fwd {name}"] = check_and_time_fwd(
                f"{name} B={TRAIN_BATCH}", feats, scales, boxes, bidx, levels, p, baseline, "train_kernels"
            )
            results[f"bwd {name}"] = check_and_time_bwd(
                f"{name} B={TRAIN_BATCH}", feats, scales, boxes, bidx, levels, p, gen, baseline
            )
    del pyr32

    # both kernels on the edge cases their vector and table paths could get
    # wrong, with the card-only tests' own inputs and tolerances (the file is
    # loaded by its path: another package named "tests" may be installed)
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "card_tests", os.path.join(REPO, "tests", "test_torch_kernels.py")
    )
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)
    for name in card_tests.EDGE_CASES:
        for dtype in (torch.float32, torch.bfloat16):
            card_tests.test_roi_align_kernels_edge_cases_match_plain(name, dtype)
    log(f"[train_kernels] K1 and K2 match their plain versions on the edge cases {card_tests.EDGE_CASES} "
        "in float32 and bfloat16")
    return results


def synthetic_train_batch(seed, b, hw, g=100, valid=8, crop=56):
    """A batch in the JAX package's schema: seeded images, ``valid`` ground
    truth boxes per image in a capacity of ``g`` (TPU.MAX_GT_INSTANCES),
    their classes, and ``crop`` x ``crop`` ellipse masks inside each box."""
    import numpy as np

    rng = np.random.default_rng(seed)
    h, w = hw
    size = rng.uniform(0.04, 0.5, (b, g, 2)) * min(h, w)
    xy = rng.uniform(0, 1, (b, g, 2)) * (np.array([w, h]) - size)
    boxes = np.concatenate([xy, xy + size], -1).astype(np.float32)
    yy, xx = np.mgrid[0:crop, 0:crop] + 0.5
    ry, rx = rng.uniform(0.5, 1.0, (2, b, g, 1, 1)) * crop / 2
    crops = ((yy - crop / 2) / ry) ** 2 + ((xx - crop / 2) / rx) ** 2 <= 1.0
    return {
        "image": rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32),
        "image_sizes": np.array([[h, w]] * b, np.int32),
        "gt_boxes": boxes,
        "gt_classes": rng.integers(0, 80, (b, g)).astype(np.int32),
        "gt_valid": np.arange(g)[None].repeat(b, 0) < valid,
        "gt_mask_crops": crops,
    }


def phase_train(kernels, dtype, state_dict):
    """The flagship at ``dtype`` takes TRAIN_STEPS steps at full width; then
    one more step split by stage."""
    import torch

    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    cfg = mask_rcnn_R_50_FPN_cfg()
    cfg.TPU.COMPUTE_DTYPE = dtype
    tag = DTYPE_NAMES[dtype]
    model = build_model(cfg)
    model.load_state_dict(state_dict)
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))
    batch = synthetic_train_batch(0, TRAIN_BATCH, FLAGSHIP_HW, g=cfg.TPU.MAX_GT_INSTANCES)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    keys = ["loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask"]
    for k in kernels:
        k.launches = 0
    times = []
    for i in range(TRAIN_STEPS):
        before = [k.launches for k in kernels]
        t0 = time.perf_counter()
        metrics = train_step(state, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        values = {k: v.item() for k, v in metrics.items()}
        if sorted(values) != sorted(keys + ["total_loss"]):
            raise AssertionError(f"{tag} step {i}: loss keys {sorted(values)}")
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"{tag} step {i}: non-finite losses {values}")
        per_step = [k.launches - b for k, b in zip(kernels, before)]
        if per_step != [2] * len(kernels):
            raise AssertionError(f"{tag} step {i}: launches {dict(zip([k.name for k in kernels], per_step))}, not 2 each")
        log(f"[train] {tag} step {i}: ms={times[-1]:.3f} " + " ".join(f"{k}={values[k]:.6g}" for k in keys + ["total_loss"]))
    launches = {k.name: k.launches for k in kernels}
    if any(n == 0 for n in launches.values()):
        raise AssertionError(f"a kernel was not launched on the train path: {launches}")
    if {p.dtype for p in model.parameters()} != {torch.float32}:
        raise AssertionError("training moved parameters off float32")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = sorted(times[1:])[len(times[1:]) // 2]
    log(f"[train] R50-FPN Mask R-CNN, {TRAIN_BATCH} images 800x1344 per step, {tag}"
        f"{' (TF32 off)' if dtype == 'float32' else ''}: {TRAIN_STEPS} steps "
        f"step_ms={[round(t, 3) for t in times]} median_after_first_ms={med:.3f} launches={launches} "
        f"peak_mem_gib={peak:.3f}")

    # one more step, split by stage (host clock, a synchronize after each);
    # hooks on the FPN maps read the layout of the gradients the poolers
    # and the RPN hand back to the backbone
    stage = {}
    grad_layout = {}
    dev = model.device
    with exact_float32(model.compute_dtype == torch.float32):
        t0 = time.perf_counter()
        features, sizes = model._features(batch)
        for name in ("p2", "p3", "p4", "p5"):
            features[name].register_hook(
                lambda g, name=name: grad_layout.__setitem__(name, g.is_contiguous(memory_format=torch.channels_last))
            )
        targets = {k: torch.as_tensor(v, device=dev) for k, v in batch.items() if k.startswith("gt_")}
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        proposals, scores, losses = model.proposal_generator(
            sizes, features, targets["gt_boxes"], targets["gt_valid"], state.generator
        )
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        losses.update(model.roi_heads(features, proposals, scores, sizes, targets, state.generator))
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        optimizer.zero_grad(set_to_none=True)
        sum(losses.values()).backward()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        for group in optimizer.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
        optimizer.step()
        torch.cuda.synchronize()
        t5 = time.perf_counter()
    for k, (a, b) in {"backbone": (t0, t1), "rpn": (t1, t2), "roi_heads": (t2, t3), "backward": (t3, t4),
                      "optimizer": (t4, t5)}.items():
        stage[k] = (b - a) * 1e3
    log(f"[train] {tag} stages_ms " + " ".join(f"{k}={v:.3f}" for k, v in stage.items())
        + f" | FPN map gradients channels-last (no copy to another format): {grad_layout}")
    if len(grad_layout) != 4 or not all(grad_layout.values()):
        raise AssertionError(f"{tag}: FPN map gradients {grad_layout}, not channels-last on all four")
    return launches, med


def phase_train_trained():
    """One train step from the gate checkpoint through K1/K2 and through
    the plain forward and backward on the card: losses and the gradient of
    every parameter must agree."""
    import torch

    import jtsm_tpu_torch.modeling.poolers as poolers
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.ops.roi_align import roi_align_multilevel_plain_autograd
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    cfg = mask_rcnn_gate_cfg()
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False  # the gradients are compared as the backward pass leaves them
    state_dict = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    batch = synthetic_train_batch(1, 2, (128, 176), g=cfg.TPU.MAX_GT_INSTANCES, valid=4)

    def step():
        model = build_model(cfg)
        model.load_state_dict(state_dict)
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, seed=0)
        metrics = make_train_step(model, optimizer, build_lr_schedule(cfg))(state, batch)
        return ({k: v.item() for k, v in metrics.items()},
                {n: p.grad.detach().clone() for n, p in model.named_parameters()})

    torch.backends.cudnn.deterministic = True
    kernel_losses, kernel_grads = step()
    routed = poolers.roi_align_multilevel
    poolers.roi_align_multilevel = roi_align_multilevel_plain_autograd
    try:
        plain_losses, plain_grads = step()
    finally:
        poolers.roi_align_multilevel = routed
    loss_err = max(abs(kernel_losses[k] - plain_losses[k]) / max(1.0, abs(plain_losses[k])) for k in plain_losses)
    grad_err = max(
        ((kernel_grads[n] - plain_grads[n]).abs().max() / plain_grads[n].abs().max().clamp(min=1e-12)).item()
        for n in plain_grads
    )
    log(f"[train_trained] gate checkpoint ({cfg.TPU.COMPUTE_DTYPE}), 2 images 128x176, one step: "
        f"losses={kernel_losses} max_rel_loss_err={loss_err:.3e} (tol 1e-5) max_rel_grad_err={grad_err:.3e} over "
        f"{len(plain_grads)} parameters (tol 1e-4 of each parameter's gradient scale)")
    if not all(math.isfinite(v) for v in kernel_losses.values()):
        raise AssertionError(f"non-finite losses {kernel_losses}")
    if not loss_err <= 1e-5:
        raise AssertionError(f"kernel vs plain losses differ by {loss_err}")
    if not grad_err <= 1e-4:
        raise AssertionError(f"kernel vs plain gradients differ by {grad_err}")


def score_once(cfg, state_dict, device, evaluator_name, kernel, captured=None):
    """``engine.defaults.test`` of ``cfg`` on ``device``, K1's count set to
    0 just before and read just after: returns the results, the COCO result
    list, K1's launches, the seconds of each stage (``timings``) and the
    peak device memory of the run (GiB above what was allocated before).
    With ``captured`` (a list), the model's raw outputs and the batch's
    original sizes are appended to it, batch by batch."""
    import torch

    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import COCOEvaluator
    from jtsm_tpu_torch.modeling import build_model

    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    if captured is not None:
        inference = model.inference

        def capture(batch):
            out = inference(batch)
            captured.append((out, batch["orig_sizes"]))
            return out

        model.inference = capture
    timings = {}
    evaluator = COCOEvaluator(evaluator_name, timings=timings)  # no output_dir: writes nothing
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    kernel.launches = 0
    t0 = time.perf_counter()
    results = test(cfg, model, evaluators=[evaluator], timings=timings)
    timings["total"] = time.perf_counter() - t0
    launches = kernel.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
    return results, evaluator.predictions, launches, timings, peak


def compare_results(want, got):
    """The largest box and score differences between two COCO result lists
    of the same detections in the same order, and for their masks the
    smallest IoU, the masks that differ and their differing pixels; raises
    where the lists do not hold the same detections."""
    from jtsm_tpu_torch.data.rle import decode_segmentation

    if len(got) != len(want):
        raise AssertionError(f"{len(got)} detections against {len(want)}")
    box_err = score_err = 0.0
    min_iou, masks_differ, pixels_differ = 1.0, 0, 0
    for g, w in zip(got, want):
        if (g["image_id"], g["category_id"]) != (w["image_id"], w["category_id"]):
            raise AssertionError(f"detection {g['image_id'], g['category_id']} against {w['image_id'], w['category_id']}")
        box_err = max(box_err, max(abs(a - b) for a, b in zip(g["bbox"], w["bbox"])))
        score_err = max(score_err, abs(g["score"] - w["score"]))
        if g["segmentation"] != w["segmentation"]:
            gm, wm = (decode_segmentation(r["segmentation"], 0, 0) for r in (g, w))
            union = int((gm | wm).sum())
            min_iou = min(min_iou, int((gm & wm).sum()) / union if union else 1.0)
            masks_differ += 1
            pixels_differ += int((gm != wm).sum())
    return box_err, score_err, min_iou, masks_differ, pixels_differ


def check_paste_on_card(captured):
    """The CPU run's raw outputs pasted on the card and on the CPU: the
    same masks, pixel for pixel. Returns the number of masks compared."""
    import torch

    from jtsm_tpu_torch.ops.paste_masks import paste_masks

    n = 0
    for out, orig_sizes in captured:
        for i, (h, w) in enumerate(orig_sizes.tolist()):
            sel = out["valid"][i]
            masks, boxes = out["masks"][i][sel], out["boxes"][i][sel]
            on_cpu = paste_masks(masks, boxes, h, w)
            on_card = paste_masks(masks.to(DEVICE), boxes.to(DEVICE), h, w).cpu()
            if not torch.equal(on_card, on_cpu):
                raise AssertionError(f"the paste on the card differs from the CPU's on {int((on_card != on_cpu).sum())} pixels")
            n += int(sel.sum())
    return n


def format_ap(results):
    return " ".join(f"{task}_AP={results[task]['AP']:.4f}" for task in ("bbox", "segm"))


def phase_score(kernel, state):
    """(a) the gate on the card against the port on the CPU, and in bf16;
    (b) the flagship's scoring at full width, stage by stage. Returns K1's
    launches."""
    import torch

    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco
    from jtsm_tpu_torch.engine.defaults import build_test_loader
    from jtsm_tpu_torch.modeling import build_model

    launches = 0
    # (a) the gate: the card against the CPU in float32, then bf16 on the card
    gate = "chip_smoke_gate"
    register_synthetic_coco(gate, num=GATE_SCENES, seed=0)
    cfg = mask_rcnn_gate_cfg()
    cfg.DATASETS.TEST = (gate,)
    weights = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    runs, cpu_outputs = {}, []
    for name, device, dtype in (("card f32", DEVICE, "float32"), ("cpu f32", "cpu", "float32"),
                                ("card bf16", DEVICE, "bfloat16")):
        c = cfg.clone()
        c.TPU.COMPUTE_DTYPE = dtype
        runs[name] = score_once(c, weights, device, gate, kernel, cpu_outputs if device == "cpu" else None)
        n = runs[name][2]
        if device != "cpu":
            launches += n
            if n != 2 * GATE_SCENES:
                raise AssertionError(f"gate {name}: roi_align_fwd launched {n} times for {GATE_SCENES} images, not 2 each")
        log(f"[score] gate checkpoint on {GATE_SCENES} synthetic scenes (before JPEG), {name}: "
            f"{format_ap(runs[name][0])} detections={len(runs[name][1])} roi_align_fwd_launches={n} "
            f"seconds={runs[name][3]['total']:.2f}")
    pasted = check_paste_on_card(cpu_outputs)
    box_err, score_err, min_iou, masks_differ, pixels_differ = compare_results(runs["cpu f32"][1], runs["card f32"][1])
    ap_diff = {t: abs(runs["card f32"][0][t]["AP"] - runs["cpu f32"][0][t]["AP"]) for t in ("bbox", "segm")}
    bf16_diff = {t: runs["card bf16"][0][t]["AP"] - runs["card f32"][0][t]["AP"] for t in ("bbox", "segm")}
    # the paste is exact: on the same inputs the card's masks are the CPU's
    # (checked above); across the two runs its inputs differ by the boxes'
    # and mask probabilities' float32 rounding, which moves the odd pixel
    # whose value lies next to the threshold
    log(f"[score] gate card f32 against cpu f32: {len(runs['card f32'][1])} detections, max box diff "
        f"{box_err:.3e} px (tol 1e-3), max score diff {score_err:.3e} (tol 1e-4), masks differing "
        f"{masks_differ} by {pixels_differ} pixels, min mask IoU {min_iou:.6f} (tol 0.999); the CPU run's outputs "
        f"pasted on the card and on the CPU: {pasted} masks, equal pixel for pixel | AP diff bbox "
        f"{ap_diff['bbox']:.4f} segm {ap_diff['segm']:.4f} (tol 0.02) | "
        f"bf16 minus f32 on the card: bbox {bf16_diff['bbox']:+.4f} segm {bf16_diff['segm']:+.4f} AP")
    if not box_err <= 1e-3 or not score_err <= 1e-4 or not min_iou >= 0.999:
        raise AssertionError("the card's gate detections differ from the CPU's")
    if not max(ap_diff.values()) <= 0.02:
        raise AssertionError(f"the card's gate AP differs from the CPU's by {ap_diff}")

    # (b) the flagship at full width: 16 scenes at 480x640, bf16 and f32 in turns
    name = "chip_smoke_flagship"
    register_synthetic_coco(name, num=SCORE_SCENES, seed=0, image_hw=SCORE_HW)
    dtypes = (mask_rcnn_R_50_FPN_cfg().TPU.COMPUTE_DTYPE, "float32")
    stats = {d: [] for d in dtypes}
    for i in range(SCORE_ROUNDS):
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            c = mask_rcnn_R_50_FPN_cfg()
            c.TPU.COMPUTE_DTYPE = d
            c.DATASETS.TEST = (name,)
            results, preds, n, timings, peak = score_once(c, state, DEVICE, name, kernel)
            launches += n
            if n != 2 * SCORE_SCENES:
                raise AssertionError(f"flagship {d}: roi_align_fwd launched {n} times for {SCORE_SCENES} images")
            stats[d].append((results, len(preds), timings, peak, n))
    # the model alone on the same batches, collated beforehand: no loader
    # thread runs beside it
    alone = {}
    for d in dtypes:
        c = mask_rcnn_R_50_FPN_cfg()
        c.TPU.COMPUTE_DTYPE = d
        c.DATASETS.TEST = (name,)
        batches = list(build_test_loader(c, name))
        model = build_model(c, device=DEVICE)
        model.load_state_dict(state)
        model.inference(batches[0])
        seconds = []
        for b in batches:
            t0 = time.perf_counter()
            model.inference(b)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
        alone[d] = sum(seconds) / len(seconds)
        del model
    stages = ("data", "model", "paste", "encode", "eval", "total")
    for d in dtypes:
        per_image = {k: sum(r[2][k] for r in stats[d]) / sum(r[2]["images"] for r in stats[d]) for k in stages}
        later = sum(r[2]["model"] - r[2]["model_first"] for r in stats[d]) / sum(r[2]["images"] - 1 for r in stats[d])
        log(f"[score] R50-FPN Mask R-CNN {DTYPE_NAMES[d]}, {SCORE_SCENES} synthetic scenes {SCORE_HW[0]}x{SCORE_HW[1]} "
            f"resized to {c.INPUT.MIN_SIZE_TEST} (max {c.INPUT.MAX_SIZE_TEST}), {SCORE_ROUNDS} runs in turns: "
            "seconds per image " + " ".join(f"{k}={v:.5f}" for k, v in per_image.items())
            + f" | detections={[r[1] for r in stats[d]]} roi_align_fwd_launches={sum(r[4] for r in stats[d])} "
            f"peak_mem_gib={max(r[3] for r in stats[d]):.3f} | model after each run's first image {later:.5f} s/img, "
            f"alone on the collated batches {alone[d]:.5f} s/img | random weights: {format_ap(stats[d][0][0])} "
            "(not checked)")
    return launches


def jtsm_mask_boxes(gen, r, hw):
    """R boxes of log-uniform size from 16 to 600 px inside an image of
    ``hw``, as the JTSM detections are."""
    import torch

    h, w = hw
    size = torch.exp(torch.empty(r, 2, device=DEVICE).uniform_(math.log(16), math.log(600), generator=gen))
    size = torch.minimum(size, torch.tensor([w, h], device=DEVICE, dtype=torch.float32))
    xy = torch.rand(r, 2, generator=gen, device=DEVICE) * (torch.tensor([w, h], device=DEVICE) - size)
    return torch.cat([xy, xy + size], dim=1).contiguous()


def voronoi_superpixels(seed, h, w, n):
    """(h, w) int32 ids of the nearest of ``n`` seeded centres, computed on
    the card in chunks of rows."""
    import numpy as np
    import torch

    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    centres = torch.rand(n, 2, generator=gen, device=DEVICE) * torch.tensor([h, w], device=DEVICE)
    xs = torch.arange(w, device=DEVICE, dtype=torch.float32)
    out = np.empty((h, w), np.int32)
    for y0 in range(0, h, 64):
        ys = torch.arange(y0, min(y0 + 64, h), device=DEVICE, dtype=torch.float32)
        pix = torch.stack(torch.meshgrid(ys, xs, indexing="ij"), -1).reshape(-1, 2)
        out[y0: y0 + len(ys)] = torch.cdist(pix, centres).argmin(1).reshape(len(ys), w).cpu().numpy()
    return out


def jtsm_request(cfg, seed, short=None, max_size=None, canvas=None):
    """One JTSM request at the config's test size (or the short edge
    ``short``, at most ``max_size``): a seeded 375x500 image resized to
    it, padded into its bucket (or ``canvas``); the top
    PRECOMPUTED_PROPOSAL_TOPK_TEST seeded proposals (log-uniform sizes,
    descending objectness, the last JTSM_PADDING slots padding with -inf
    scores); Voronoi superpixels; their membership by centroid
    (``wsl.data.add_wsl_batch_fields``)."""
    import numpy as np

    from jtsm_tpu_torch.data.detection_utils import pick_bucket
    from jtsm_tpu_torch.data.transforms.augmentation import ResizeShortestEdge
    from jtsm_tpu_torch.wsl.data import add_wsl_batch_fields

    rng = np.random.default_rng(seed)
    oh, ow = JTSM_IMAGE_HW
    h, w = ResizeShortestEdge.get_output_shape(
        oh, ow, short or cfg.INPUT.MIN_SIZE_TEST, max_size or cfg.INPUT.MAX_SIZE_TEST
    )
    bh, bw = canvas or pick_bucket(h, w, cfg.TPU.IMAGE_BUCKETS)
    img = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
    canvas = np.zeros((1, bh, bw, 3), np.float32)
    canvas[0, :h, :w] = img
    r = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    live = r - JTSM_PADDING
    size = np.minimum(np.exp(rng.uniform(np.log(16), np.log(600), (live, 2))), [w, h])
    xy = rng.uniform(0, 1, (live, 2)) * ([w, h] - size)
    boxes = np.zeros((r, 4), np.float32)
    boxes[:live] = np.concatenate([xy, xy + size], 1)
    scores = np.full(r, -np.inf, np.float32)
    scores[:live] = np.sort(rng.uniform(0, 1, live))[::-1]
    sp = voronoi_superpixels(seed, h, w, JTSM_SUPERPIXELS)
    batch = {
        "image": canvas,
        "image_sizes": np.array([[h, w]], np.int32),
        "orig_sizes": np.array([[oh, ow]], np.int32),
        "proposals": boxes[None],
        "proposal_scores": scores[None],
    }
    add_wsl_batch_fields(batch, [{"image": img, "proposals": {"boxes": boxes, "superpixels": sp}}],
                         cfg.WSL.MAX_SUPERPIXELS)
    return batch


def jtsm_gate_request():
    """Two seeded 128x176 scenes of the gate's size, 64 proposals each (the
    last five of the second padding), the grid superpixels and their
    membership."""
    import numpy as np

    from jtsm_tpu_torch.wsl.data import compute_superpixels_grid, oh_labels_from_boxes

    h, w, r = 128, 176, 64
    rng = np.random.RandomState(0)
    imgs = []
    for _ in range(2):
        img = np.full((h, w, 3), 128.0, np.float32)
        img[: h // 2] = [205, 115, 95]
        img[h // 2:] = [95, 175, 95]
        for _ in range(4):
            y0, x0 = rng.randint(0, h - 40), rng.randint(0, w - 40)
            img[y0: y0 + rng.randint(20, 60), x0: x0 + rng.randint(20, 60)] = rng.randint(55, 255, 3)
        imgs.append(img + rng.randn(h, w, 3).astype(np.float32) * 3)
    xy = rng.rand(2, r, 2) * [w - 30, h - 30]
    boxes = np.concatenate([xy, xy + rng.rand(2, r, 2) * 60 + 10], -1).astype(np.float32)
    scores = rng.rand(2, r).astype(np.float32)
    scores[1, -5:] = -np.inf
    sp = compute_superpixels_grid(h, w)
    return {
        "image": np.stack(imgs),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "proposals": boxes,
        "proposal_scores": scores,
        "superpixels": np.stack([sp, sp]).astype(np.int32),
        "oh_labels": np.stack([oh_labels_from_boxes(boxes[i], sp, 512) for i in range(2)]),
    }


def jtsm_stages(model, batch, measure):
    """The JTSM request ``batch`` through ``model`` stage by stage;
    ``measure`` makes each call and returns its reading."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32, interpolate_bilinear

    heads = model.roi_heads
    dev = model.device
    r = {}

    def backbone():
        r["feats"], r["sizes"] = model._features(batch)
        r["props"] = torch.as_tensor(batch["proposals"], dtype=torch.float32, device=dev)
        r["scores"] = torch.as_tensor(batch["proposal_scores"], dtype=torch.float32, device=dev)
        r["sp"] = torch.as_tensor(batch["superpixels"], device=dev)
        r["oh"] = torch.as_tensor(batch["oh_labels"], device=dev)

    def moipool():
        feat = r["feats"][heads.in_features[0]].permute(0, 2, 3, 1)
        r["pooled"], r["nonempty"] = heads.pool(feat, r["props"], r["sp"], r["oh"])

    def stuff():
        logits = interpolate_bilinear(model.sem_seg_head(r["feats"]), tuple(batch["image"].shape[1:3]))
        return logits.argmax(dim=1)

    with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
        return {
            "backbone": measure(backbone),
            "moipool": measure(moipool),
            "dan_refine": measure(lambda: r.update(branches=heads.refine_branches(
                r["pooled"], r["nonempty"], r["scores"]))),
            "detect_nms": measure(lambda: r.update(det=heads.detect(r["props"], r["scores"], r["branches"], r["sizes"]))),
            "mask": measure(lambda: heads.add_masks(r["det"], r["feats"])),
            "stuff": measure(stuff),
        }


def match_detections(card, host, score_tol):
    """The detections of two runs on the same request matched by their
    (source proposal, class), which names a detection uniquely: scores,
    boxes and (where the model has masks) mask probabilities are compared
    pair by pair, and the masks' IoU at 0.5 is reported with the largest distance from 0.5 of a pixel
    that lands on the other side of it. Two
    detections whose scores lie within ``score_tol`` may take each other's
    slots, and one within ``score_tol`` of the last kept score may fall on
    either side of the cut; anything else that is on one side only fails."""
    import torch

    out = dict(matched=0, reordered=0, at_cut=0, reorder_gap=0.0, boxes=0.0, scores=0.0, masks=0.0, iou=1.0,
               flip_margin=0.0, class_scores=0.0)
    if "proposal_class_scores" in host:  # PCL returns none
        out["class_scores"] = (card["proposal_class_scores"] - host["proposal_class_scores"]).abs().max().item()
    for i in range(host["valid"].shape[0]):
        sides = []
        for run in (card, host):
            keys = zip(run["prop_idx"][i].tolist(), run["classes"][i].tolist(), run["valid"][i].tolist())
            sides.append({(p, c): j for j, (p, c, v) in enumerate(keys) if v})
        (kc, kh), scores = sides, (card["scores"][i], host["scores"][i])
        cut = min(float(scores[1][list(kh.values())].min()), float(scores[0][list(kc.values())].min()))
        for key in set(kc) ^ set(kh):
            run, j = (0, kc[key]) if key in kc else (1, kh[key])
            if float(scores[run][j]) > cut + score_tol:
                raise AssertionError(f"image {i}: detection {key} (score {float(scores[run][j])}) "
                                     f"only on the {'card' if run == 0 else 'CPU'}")
            out["at_cut"] += 1
        for key in set(kc) & set(kh):
            jc, jh = kc[key], kh[key]
            out["matched"] += 1
            if jc != jh:
                out["reordered"] += 1
                out["reorder_gap"] = max(out["reorder_gap"], abs(float(scores[1][jh] - scores[1][jc])))
            out["boxes"] = max(out["boxes"], (card["boxes"][i, jc] - host["boxes"][i, jh]).abs().max().item())
            out["scores"] = max(out["scores"], abs(float(scores[0][jc] - scores[1][jh])))
            if "masks" not in host:  # the WSOD baselines have no mask branch
                continue
            pc, ph = card["masks"][i, jc], host["masks"][i, jh]
            out["masks"] = max(out["masks"], (pc - ph).abs().max().item())
            a, b = pc >= 0.5, ph >= 0.5
            union = int((a | b).sum())
            out["iou"] = min(out["iou"], int((a & b).sum()) / union if union else 1.0)
            out["flip_margin"] = max(out["flip_margin"], (ph[a != b] - 0.5).abs().max().item() if (a != b).any() else 0.0)
    if out["reorder_gap"] > score_tol:
        raise AssertionError(f"detections swapped slots across a score gap of {out['reorder_gap']}")
    return out


def phase_jtsm(kernel, gen, baseline):
    """Phase 10: (a) K1 at the JTSM mask pooler's shape, (b) the JTSM
    flagship served at full width in both dtypes, (c) the gate checkpoint on
    the card against the CPU. Returns K1's rows, its launches on the served
    path and the gate run, the per-dtype latencies and the flagship's
    random weights."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, random_state_dict, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model

    # (a) K1 at the mask pooler's shape: one level, res5 at stride 16 of
    # the 1024x1024 bucket, 100 detections of the 688x917 image
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn((1, 64, 64, 512), generator=gen, device=DEVICE).to(dtype)
        boxes = jtsm_mask_boxes(gen, 100, (688, 917))
        zeros = torch.zeros(100, dtype=torch.int32, device=DEVICE)
        tag = f"jtsm mask pooler {'bf16' if dtype == torch.bfloat16 else 'f32'} (L=1)"
        rows[tag] = check_and_time_fwd(tag, [feat], [1.0 / 16], boxes, zeros, zeros, 14, baseline, phase="jtsm")

    # (b) the flagship at full width
    t0 = time.perf_counter()
    flagship = jtsm_WSR_18_DC5_cfg()
    flagship.TEST.AUG.ENABLED = False  # serving one view; TTA is phase 13's
    main_dtype = flagship.TPU.COMPUTE_DTYPE
    dtypes = (main_dtype, "float32")
    flagship_state = random_state_dict(build_model(flagship, device="cpu"), seed=0)
    reqs = [jtsm_request(flagship, seed) for seed in (1, 2)]
    req = reqs[0]
    log(f"[jtsm] flagship {flagship.MODEL.BACKBONE.NAME} R{flagship.MODEL.RESNETS.DEPTH} "
        f"RES5_DILATION={flagship.MODEL.RESNETS.RES5_DILATION}, image {JTSM_IMAGE_HW} -> "
        f"{tuple(req['image_sizes'][0].tolist())} in {req['image'].shape[1:3]}, R={req['proposals'].shape[1]} "
        f"({JTSM_PADDING} padding), superpixels {int(req['superpixels'].max()) + 1} of "
        f"{flagship.WSL.MAX_SUPERPIXELS}, oh_labels {req['oh_labels'].shape} "
        f"({req['oh_labels'].sum(-1).mean():.1f} members a proposal), DAN {list(flagship.MODEL.ROI_BOX_HEAD.DAN_DIM)}, "
        f"{flagship.WSL.REFINE_NUM} refinement branches, mask refinery {flagship.WSL.MASK_REFINE_NUM}; "
        f"weights and requests made in {time.perf_counter() - t0:.1f}s")

    def plain(*a, **k):
        raise AssertionError("the plain ROIAlign ran on the card in the JTSM flagship")

    routed = roi_align.roi_align_multilevel_plain_autograd
    roi_align.roi_align_multilevel_plain_autograd = plain
    try:
        predictors, mem = {}, {}
        for d in dtypes:
            cfg = flagship.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            predictors[d] = Predictor(cfg, flagship_state)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            predictors[d](req)  # warm-up
            torch.cuda.synchronize()
            mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)

        kernel.launches = 0
        lat = {d: [] for d in dtypes}
        valid = {d: [] for d in dtypes}
        launches = dict.fromkeys(dtypes, 0)
        for i in range(JTSM_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                before = kernel.launches
                t0 = time.perf_counter()
                out = predictors[d](reqs[i % len(reqs)])
                torch.cuda.synchronize()
                lat[d].append((time.perf_counter() - t0) * 1e3)
                n = kernel.launches - before
                launches[d] += n
                if n != 1:
                    raise AssertionError(f"jtsm {d} request {i}: roi_align_fwd launched {n} times, not 1")
                canvas = (1,) + reqs[i % len(reqs)]["image"].shape[1:3]
                for k, shape in (("boxes", (1, 100, 4)), ("masks", (1, 100, 28, 28)), ("sem_seg", canvas)):
                    if tuple(out[k].shape) != shape or not torch.isfinite(out[k].float()).all():
                        raise AssertionError(f"jtsm {d} request {i}: {k} {tuple(out[k].shape)} not finite {shape}")
                boxes = out["boxes"][0][out["valid"][0]]
                if (boxes[:, 2] > JTSM_IMAGE_HW[1]).any() or (boxes[:, 3] > JTSM_IMAGE_HW[0]).any() or (boxes < 0).any():
                    raise AssertionError(f"jtsm {d} request {i}: boxes leave the original image")
                if not bool(out["valid"].any()):
                    raise AssertionError(f"jtsm {d} request {i}: no detection")
                valid[d].append(int(out["valid"].sum()))
        serve_launches = kernel.launches
        for d in dtypes:
            tag = DTYPE_NAMES[d]
            log(f"[jtsm] JTSM WSR-18 DC5 {'x'.join(map(str, req['image_sizes'][0]))} {tag}, {JTSM_ROUNDS} requests in turns: "
                f"latency_ms={[round(x, 3) for x in lat[d]]} mean_ms={sum(lat[d]) / len(lat[d]):.3f} "
                f"median_ms={sorted(lat[d])[len(lat[d]) // 2]:.3f} valid_detections={valid[d]} "
                f"roi_align_fwd_launches={launches[d]} weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")

        def timed(call):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        stage_ms = {d: {} for d in dtypes}
        for i in range(STAGE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                for k, ms in jtsm_stages(predictors[d].model, req, timed).items():
                    stage_ms[d].setdefault(k, []).append(ms)
        for d in dtypes:
            syncs = jtsm_stages(predictors[d].model, req, count_host_syncs)
            log(f"[jtsm] {DTYPE_NAMES[d]} stages_ms (median of {STAGE_ROUNDS}) "
                + " ".join(f"{k}={sorted(v)[len(v) // 2]:.3f}" for k, v in stage_ms[d].items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items()))
        del predictors
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed

    # (c) the gate checkpoint on the card against the CPU
    cfg = jtsm_gate_cfg()
    state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    batch = jtsm_gate_request()
    before = kernel.launches
    card = {k: v.cpu() for k, v in Predictor(cfg, state)(batch).items()}
    gate_launches = kernel.launches - before
    if gate_launches != 1:
        raise AssertionError(f"jtsm gate on the card: roi_align_fwd launched {gate_launches} times, not 1")
    host = Predictor(cfg, state, device="cpu")(batch)
    if not bool(host["valid"].any()):
        raise AssertionError("jtsm gate: no detection")
    m = match_detections(card, host, score_tol=1e-4)
    sem_agree = (card["sem_seg"] == host["sem_seg"]).float().mean().item()
    log(f"[jtsm] gate checkpoint (float32), 2 images 128x176, 64 proposals: valid_detections="
        f"{host['valid'].sum(1).tolist()}, card vs CPU: proposal class scores max_abs_err={m['class_scores']:.3e}; "
        f"detections matched by (source proposal, class): {m['matched']} matched, {m['reordered']} in another "
        f"slot (scores within {m['reorder_gap']:.3e} of a neighbour), {m['at_cut']} only on one side at the "
        f"100-detection cut; boxes max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} "
        f"(tol 1e-4), classes and prop_idx equal by construction, mask probabilities {m['masks']:.3e} (tol 1e-4), "
        f"min mask IoU at 0.5 {m['iou']:.6f} (pixels across 0.5 lie within {m['flip_margin']:.3e} of it, tol 1e-4), "
        f"sem_seg pixels equal {sem_agree:.6f}, roi_align_fwd_launches={gate_launches}")
    if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["flip_margin"] <= 1e-4):
        raise AssertionError(f"jtsm gate: the card disagrees with the CPU: {m}")
    return rows, serve_launches + gate_launches, {d: sum(x) / len(x) for d, x in lat.items()}, flagship_state


def jtsm_train_batch(cfg, seeds, short, max_size, canvas=None):
    """``jtsm_request`` for each seed at the short edge ``short``, stacked,
    with seeded image labels collated by ``wsl.data.add_wsl_train_fields``:
    1 to 3 of the thing classes, and the stuff map of VOC's panoptic
    labels, class 1 (background) over each image."""
    import numpy as np

    from jtsm_tpu_torch.wsl.data import add_wsl_train_fields

    reqs = [jtsm_request(cfg, seed, short, max_size, canvas) for seed in seeds]
    batch = {k: np.concatenate([r[k] for r in reqs]) for k in reqs[0]}
    rng = np.random.default_rng(seeds[0])
    per_image = [{"gt_classes": rng.choice(cfg.MODEL.ROI_HEADS.NUM_CLASSES, rng.integers(1, 4), replace=False),
                  "sem_seg": np.ones(tuple(r["image_sizes"][0]), np.int32)} for r in reqs]
    add_wsl_train_fields(batch, per_image, cfg.TPU.MAX_GT_INSTANCES)
    return batch


def jtsm_train_stages(model, optimizer, schedule, state, batch, measure, upto="sgd"):
    """One train step of ``batch`` through ``model`` stage by stage, as
    ``GeneralizedMCNNWSL.forward`` and ``engine.make_train_step`` run it,
    up to the stage ``upto``; ``measure`` makes each call and returns its
    reading. Returns the readings and the stages' outputs."""
    import torch

    from jtsm_tpu_torch.engine.train_loop import sgd_update
    from jtsm_tpu_torch.layers import exact_float32

    heads = model.roi_heads
    r = {}

    def backbone():
        r["feats"], _ = model._features(batch)
        r["props"], r["scores"], r["sp"], r["oh"] = model.request_fields(batch)
        r["targets"] = {k: torch.as_tensor(batch[k], device=model.device)
                        for k in ("gt_classes", "gt_valid", "gt_sem_seg") if k in batch}

    def moipool():
        feat = r["feats"][heads.in_features[0]].permute(0, 2, 3, 1)
        r["pooled"], r["nonempty"] = heads.pool(feat, r["props"], r["sp"], r["oh"])

    def dan_branches():
        r["mil"], r["branches"] = heads.train_outputs(r["pooled"], r["nonempty"], r["scores"], state.generator)

    def mining():
        r["losses"], r["aux"], r["mined"] = heads.mine(
            r["props"], r["scores"], r["mil"], r["branches"], r["targets"], r["sp"], r["oh"])

    def mask():
        r["losses"].update(heads.mask_losses(r["feats"], r["mined"]))
        if "pgt_sem_seg" in r["aux"]:
            r["losses"].update(model.sem_seg_head.losses(
                model.sem_seg_head(r["feats"]), r["aux"]["pgt_sem_seg"], r["aux"]["pgt_sem_seg_stride"]))

    def backward():
        optimizer.zero_grad(set_to_none=True)
        sum(r["losses"].values()).backward()

    def sgd():
        sgd_update(optimizer, schedule(state.step))
        state.step += 1

    stages = {"backbone": backbone, "moipool": moipool, "dan_branches": dan_branches, "mining": mining,
              "mask": mask, "backward": backward, "sgd": sgd}
    readings = {}
    with exact_float32(model.compute_dtype == torch.float32):
        for k, fn in stages.items():
            readings[k] = measure(fn)
            if k == upto:
                break
    return readings, r


def gate_train_state(model, seed):
    """Seeded weights for the gate (``random_state_dict``) with the heads'
    spread of ``tests/test_torch_jtsm.py``: the DAN's first layer and the
    box deltas at 0.05 of the usual scale and the predictors at 0.1, so
    that the WSDDN scores do not tie."""
    from jtsm_tpu_torch.checkpoint import random_state_dict

    state = random_state_dict(model, seed)
    gains = {"dan1.weight": 0.05, "refine_reg.weight": 0.05, "predictor.weight": 0.1}
    for key in state:
        for name, gain in gains.items():
            if key.endswith(name):
                state[key] = state[key] * gain
    return state


def phase_jtsm_train(kernels, gen, baseline, flagship_state):
    """Phase 11: (a) K1 and K2 at the JTSM train step's mask pooler shape,
    (b) the flagship's train step at full width in both dtypes, (c) the
    gate config's steps on the card against the CPU. Returns the kernel
    rows, each kernel's launches in (b) and (c), and the median step
    times."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg
    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    k1, k2 = kernels
    # (a) the mask pooler of a flagship step: res5 of four images in the
    # 1024x1024 bucket, 64 mined ROIs an image
    rows = {}
    b, r = 4, 256
    boxes = jtsm_mask_boxes(gen, r, (688, 917))
    bidx = torch.arange(b, dtype=torch.int32, device=DEVICE).repeat_interleave(r // b)
    zeros = torch.zeros(r, dtype=torch.int32, device=DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn((b, 64, 64, 512), generator=gen, device=DEVICE).to(dtype)
        tag = f"jtsm train mask pooler {dtype_tag(feat)} B={b} (L=1)"
        rows[f"fwd {dtype_tag(feat)}"] = check_and_time_fwd(
            tag, [feat], [1.0 / 16], boxes, bidx, zeros, 14, baseline, phase="jtsm_train")
        rows[f"bwd {dtype_tag(feat)}"] = check_and_time_bwd(
            tag, [feat], [1.0 / 16], boxes, bidx, zeros, 14, gen, baseline, phase="jtsm_train")
    del feat

    # (b) the flagship's train step at full width, both dtypes in turns
    t0 = time.perf_counter()
    flagship = jtsm_WSR_18_DC5_cfg()
    dtypes = (flagship.TPU.COMPUTE_DTYPE, "float32")
    seeds = tuple(range(21, 21 + flagship.SOLVER.IMS_PER_BATCH))
    batch = jtsm_train_batch(flagship, seeds, JTSM_TRAIN_SHORT, flagship.INPUT.MAX_SIZE_TRAIN)
    log(f"[jtsm_train] flagship FREEZE_AT={flagship.MODEL.BACKBONE.FREEZE_AT}, IMS_PER_BATCH="
        f"{flagship.SOLVER.IMS_PER_BATCH}: images {batch['image_sizes'].tolist()} in {batch['image'].shape[1:3]}, "
        f"R={batch['proposals'].shape[1]} ({JTSM_PADDING} padding), superpixels {JTSM_SUPERPIXELS}, image labels "
        f"{[np.flatnonzero(v).size for v in batch['gt_valid']]} classes, DAN {list(flagship.MODEL.ROI_BOX_HEAD.DAN_DIM)}, "
        f"clip {flagship.SOLVER.CLIP_GRADIENTS.ENABLED}; batch made in {time.perf_counter() - t0:.1f}s")

    def plain(*a, **k):
        raise AssertionError("the plain ROIAlign ran on the card in the JTSM train step")

    routed = roi_align.roi_align_multilevel_plain_autograd
    roi_align.roi_align_multilevel_plain_autograd = plain
    torch.backends.cudnn.deterministic = False  # cuDNN's own algorithm choice, as a user trains
    try:
        runs = {}
        for d in dtypes:
            cfg = flagship.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            model = build_model(cfg)
            model.load_state_dict(flagship_state)
            optimizer = build_optimizer(cfg, model)
            schedule = build_lr_schedule(cfg)
            runs[d] = (model, optimizer, schedule, create_train_state(model, optimizer, seed=0),
                       make_train_step(model, optimizer, schedule))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        times = {d: [] for d in dtypes}
        for k in kernels:
            k.launches = 0
        for i in range(JTSM_TRAIN_STEPS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                model, _, _, state, train_step = runs[d]
                before = [k.launches for k in kernels]
                t0 = time.perf_counter()
                metrics = train_step(state, batch)
                torch.cuda.synchronize()
                times[d].append((time.perf_counter() - t0) * 1e3)
                values = {k: v.item() for k, v in metrics.items()}
                if sorted(values) != JTSM_FLAGSHIP_LOSSES or not all(math.isfinite(v) for v in values.values()):
                    raise AssertionError(f"jtsm train {d} step {i}: losses {values}")
                per_step = [k.launches - n for k, n in zip(kernels, before)]
                if per_step != [1, 0]:
                    raise AssertionError(f"jtsm train {d} step {i}: launches {per_step}, not K1 once and K2 never")
                log(f"[jtsm_train] {DTYPE_NAMES[d]} step {i}: ms={times[d][-1]:.3f} "
                    + " ".join(f"{k}={v:.6g}" for k, v in values.items()))
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_launches = {k.name: k.launches for k in kernels}
        med = {d: sorted(t[1:])[len(t[1:]) // 2] for d, t in times.items()}
        for d in dtypes:
            log(f"[jtsm_train] JTSM WSR-18 DC5, {len(seeds)} images {JTSM_TRAIN_SHORT} short side per step, "
                f"{DTYPE_NAMES[d]}{' (TF32 off)' if d == 'float32' else ''}: step_ms={[round(t, 3) for t in times[d]]} "
                f"median_of_steps_2_to_{JTSM_TRAIN_STEPS}_ms={med[d]:.3f}")
        log(f"[jtsm_train] launches over {2 * JTSM_TRAIN_STEPS} steps {train_launches}; peak_mem_gib={peak:.3f} "
            "(both dtypes' models, gradients and momentum resident)")

        def timed(call):
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        for d in dtypes:
            model, optimizer, schedule, state, _ = runs[d]
            stage_ms = jtsm_train_stages(model, optimizer, schedule, state, batch, timed)[0]
            syncs = jtsm_train_stages(model, optimizer, schedule, state, batch, count_host_syncs)[0]
            log(f"[jtsm_train] {DTYPE_NAMES[d]} stages_ms " + " ".join(f"{k}={v:.3f}" for k, v in stage_ms.items())
                + f" sum={sum(stage_ms.values()):.3f} | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items()))
        del runs, model, optimizer, state

        # one step at the largest train scale, for its peak memory
        short, canvas = JTSM_TRAIN_LARGEST
        big = jtsm_train_batch(flagship, seeds, short, flagship.INPUT.MAX_SIZE_TRAIN, canvas)
        model = build_model(flagship)
        model.load_state_dict(flagship_state)
        optimizer = build_optimizer(flagship, model)
        state = create_train_state(model, optimizer, seed=0)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        values = {k: v.item() for k, v in make_train_step(model, optimizer, build_lr_schedule(flagship))(state, big).items()}
        torch.cuda.synchronize()
        big_ms = (time.perf_counter() - t0) * 1e3
        big_peak = torch.cuda.max_memory_allocated() / 2**30
        if not all(math.isfinite(v) for v in values.values()):
            raise AssertionError(f"jtsm train at short side {short}: losses {values}")
        log(f"[jtsm_train] {DTYPE_NAMES[dtypes[0]]} one step at short side {short}: images "
            f"{big['image_sizes'].tolist()} in {canvas}, ms={big_ms:.3f} (first step of a new model) "
            f"peak_mem_gib={big_peak:.3f} (of which {base / 2**30:.3f} before the step: weights)")
        train_launches = {k.name: k.launches for k in kernels}
        del model, optimizer, state
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed

    # (c) the gate config on the card against the CPU
    cfg = jtsm_gate_cfg()
    if cfg.SOLVER.CLIP_GRADIENTS.CLIP_TYPE != "full_model" or cfg.MODEL.BACKBONE.FREEZE_AT != 0:
        raise AssertionError("the JTSM gate config is not the full-model clip over a trained backbone")
    weights = gate_train_state(build_model(cfg, device="cpu"), seed=1)
    batch = jtsm_gate_request()
    rng = np.random.RandomState(19)
    batch["gt_classes"] = rng.randint(0, 80, (2, 4)).astype(np.int32)
    batch["gt_valid"] = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    batch["gt_boxes"] = np.zeros((2, 4, 4), np.float32)
    batch["gt_sem_seg"] = rng.randint(0, 54, (2, 128, 176)).astype(np.int32)
    torch.backends.cudnn.deterministic = True
    gate = {}
    for name, device in (("card", DEVICE), ("cpu", "cpu")):
        model = build_model(cfg, device=device)
        model.load_state_dict(weights)
        model.roi_heads.dan.dropout = 0.0  # the two devices' generators draw other bits
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, seed=0)
        with torch.no_grad():
            _, r = jtsm_train_stages(model, optimizer, None, state, batch, lambda fn: fn(), upto="mining")
        mined = {k: v.cpu() for k, v in r["mined"].items()}
        mined["pgt_sem_seg"] = r["aux"]["pgt_sem_seg"].cpu()
        before = [k.launches for k in kernels]
        train_step = make_train_step(model, optimizer, build_lr_schedule(cfg))
        losses = []
        for i in range(JTSM_GATE_STEPS):
            losses.append({k: v.item() for k, v in train_step(state, batch).items()})
            if device != "cpu" and [k.launches - n for k, n in zip(kernels, before)] != [i + 1, i + 1]:
                raise AssertionError(f"jtsm gate step {i} on the card: K1 and K2 did not launch once a step")
        launches = [k.launches - n for k, n in zip(kernels, before)]
        gate[name] = (mined, losses, {n: p.detach().cpu() for n, p in model.named_parameters()}, launches)
        del model, optimizer, state, r
    (m_card, l_card, p_card, gate_launches), (m_cpu, l_cpu, p_cpu, _) = gate["card"], gate["cpu"]
    unequal = [k for k in m_cpu if not torch.equal(m_card[k], m_cpu[k])]
    loss_err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for a, b in zip(l_card, l_cpu) for k in b)
    param_err = max(((p_card[n] - p_cpu[n]).abs().max() / p_cpu[n].abs().max().clamp(min=1e-12)).item() for n in p_cpu)
    finite = all(math.isfinite(v) for step in l_card for v in step.values())
    log(f"[jtsm_train] gate config (float32, FREEZE_AT 0, full-model clip {cfg.SOLVER.CLIP_GRADIENTS.CLIP_VALUE}), "
        f"2 images 128x176, {JTSM_GATE_STEPS} steps on the card and on the CPU: mined mask ROIs "
        f"{int(m_cpu['ok'].sum())} of {m_cpu['ok'].numel()}, mined fields equal: {not unequal} {unequal or ''}; "
        f"losses {len(l_cpu[0])} keys, max_rel_err={loss_err:.3e} (tol 1e-4), loss_mil by step card "
        f"{[round(x['loss_mil'], 6) for x in l_card]} cpu {[round(x['loss_mil'], 6) for x in l_cpu]}; parameters "
        f"after {JTSM_GATE_STEPS} steps max_err={param_err:.3e} of each one's scale (tol 1e-5) over {len(p_cpu)}; "
        f"launches on the card K1/K2 {gate_launches}")
    if unequal or not finite or not loss_err <= 1e-4 or not param_err <= 1e-5:
        raise AssertionError("jtsm gate: the card's train steps disagree with the CPU's")
    launches = {k.name: train_launches[k.name] + n for k, n in zip(kernels, gate_launches)}
    return rows, launches, med


def jtsm_score_once(cfg, state_dict, device, kernel):
    """``engine.defaults.test`` of the WSL config ``cfg`` on ``device``
    through the WSL test loader, with the COCO, SemSeg and panoptic
    evaluators (writing nothing) and panoptic fusion, K1's count set to 0
    just before and read just after: returns the results, each batch's
    fused outputs on the host, K1's launches, the seconds of each stage and
    the peak device memory of the run (GiB above what was allocated
    before)."""
    import torch

    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import (COCOEvaluator, COCOPanopticEvaluator, DatasetEvaluator,
                                           DatasetEvaluators, SemSegEvaluator)
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.train_net import build_test_loader

    class Captured(DatasetEvaluator):
        def __init__(self):
            self.batches = []

        def process(self, inputs, outputs):
            out = {k: v.cpu() if torch.is_tensor(v) else v for k, v in outputs.items()}
            self.batches.append(dict(out, image_sizes=inputs["image_sizes"]))

    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    name = cfg.DATASETS.TEST[0]
    timings, captured = {}, Captured()
    evaluator = DatasetEvaluators([COCOEvaluator(name, timings=timings), SemSegEvaluator(name, timings=timings),
                                   COCOPanopticEvaluator(name, timings=timings), captured])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    kernel.launches = 0
    t0 = time.perf_counter()
    results = test(cfg, model, evaluators=[evaluator], timings=timings, build_test_loader=build_test_loader)
    timings["total"] = time.perf_counter() - t0
    launches = kernel.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
    return results, captured.batches, launches, timings, peak


JTSM_TASK_METRICS = (("bbox", "AP"), ("segm", "AP"), ("sem_seg", "mIoU"), ("panoptic_seg", "PQ"))


def format_jtsm(results):
    return " ".join(f"{t}_{m}={results[t][m]:.4f}" for t, m in JTSM_TASK_METRICS)


def sem_seg_near_ties(logits, image_size, orig_size, pixels):
    """The gap between the two largest of the upsampled stuff logits (the
    fusion's float64 resize) at each of ``pixels`` (an (N, 2) index)."""
    import torch

    from jtsm_tpu_torch.modeling.meta_arch.panoptic_fpn import bilinear_resize

    (h, w), (h0, w0) = image_size, orig_size
    up = bilinear_resize(logits[:h, :w].float(), h0, w0)[pixels[:, 0], pixels[:, 1]]
    top2 = torch.topk(up, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).abs()


def voc_scenes(num, seed, r):
    """``num`` seeded VOC-shaped scenes of JTSM_IMAGE_HW: a noisy background
    (the stuff class "background") with 1-3 rectangles of VOC things in
    their palette colours; the instance json, the pixels, the stuff and
    panoptic maps and the panoptic json in the separated format, and the
    MCG-style proposal dict (``r`` log-uniform boxes with descending
    objectness, JTSM_SUPERPIXELS Voronoi superpixels, membership by
    centroid)."""
    import numpy as np

    from jtsm_tpu_torch.wsl.builtin import VOC_CATEGORIES
    from jtsm_tpu_torch.wsl.data import oh_labels_from_boxes

    rng = np.random.default_rng(seed)
    h, w = JTSM_IMAGE_HW
    things = [c for c in VOC_CATEGORIES if c["isthing"]]
    infos, anns, pan_anns = [], [], []
    images, sem_maps, pan_maps = {}, {}, {}
    props = {"ids": [], "boxes": [], "objectness_logits": [], "superpixels": [], "oh_labels": [], "bbox_mode": 0}
    for i in range(num):
        infos.append({"id": i, "file_name": f"{i:06d}.jpg", "height": h, "width": w})
        img = np.empty((h, w, 3), np.uint8)
        img[:] = rng.integers(60, 200, 3)
        ids = np.ones((h, w), np.uint32)
        segments = [{"id": 1, "category_id": 21, "iscrowd": 0}]
        for k in range(int(rng.integers(1, 4))):
            bw, bh = rng.uniform(40, w / 2), rng.uniform(40, h / 2)
            x, y = rng.uniform(0, w - bw - 1), rng.uniform(0, h - bh - 1)
            cat = int(rng.integers(1, 21))
            anns.append({"id": len(anns) + 1, "image_id": i, "category_id": cat, "bbox": [x, y, bw, bh],
                         "area": bw * bh, "iscrowd": 0,
                         "segmentation": [[x, y, x + bw, y, x + bw, y + bh, x, y + bh]]})
            xi, yi, bwi, bhi = (int(round(v)) for v in (x, y, bw, bh))
            img[yi: yi + bhi, xi: xi + bwi] = things[cat - 1]["color"]
            ids[yi: yi + bhi, xi: xi + bwi] = k + 2
            segments.append({"id": k + 2, "category_id": cat, "iscrowd": 0})
        images[i] = np.clip(img.astype(np.int16) + rng.integers(-12, 13, (h, w, 3)), 0, 255).astype(np.uint8)
        areas = np.bincount(ids.reshape(-1), minlength=len(segments) + 1)
        pan_anns.append({"image_id": i, "file_name": f"{i:06d}.png", "segments_info": [
            dict(s, area=int(areas[s["id"]])) for s in segments if areas[s["id"]] > 0]})
        pan_maps[i], sem_maps[i] = ids, (ids == 1).astype(np.uint8)
        size = np.minimum(np.exp(rng.uniform(np.log(16), np.log(400), (r, 2))), [w - 1, h - 1])
        xy = rng.uniform(0, 1, (r, 2)) * ([w - 1, h - 1] - size)
        boxes = np.concatenate([xy, xy + size], 1).astype(np.float32)
        sp = voronoi_superpixels(seed + i, h, w, JTSM_SUPERPIXELS)
        props["ids"].append(i)
        props["boxes"].append(boxes)
        props["objectness_logits"].append(np.sort(rng.uniform(0, 1, r))[::-1].astype(np.float32))
        props["superpixels"].append(sp)
        props["oh_labels"].append(oh_labels_from_boxes(boxes, sp, JTSM_SUPERPIXELS))
    coco = {"images": infos, "annotations": anns,
            "categories": [{"id": c["id"], "name": c["name"]} for c in things]}
    pan_json = {"images": infos, "annotations": pan_anns,
                "categories": [{"id": c["id"], "name": c["name"], "isthing": c["isthing"]} for c in VOC_CATEGORIES]}
    return coco, images, sem_maps, pan_maps, pan_json, props


def phase_jtsm_score(kernel, flagship_state):
    """Phase 12: (a) the JTSM gate checkpoint scores the 12 in-memory
    cocovar scenes on the card and on the CPU; (b) the JTSM flagship scores
    seeded VOC scenes at full width by stage. Returns K1's launches."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_cocovar, register_synthetic_panoptic
    from jtsm_tpu_torch.wsl.builtin import _voc_sbd_panoptic_separated_meta

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in JTSM scoring")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        # (a) the gate: the card against the CPU, float32
        name = "chip_smoke_jtsm_gate"
        cfg = jtsm_gate_cfg()
        cfg.DATASETS.TEST = (name,)
        cfg.DATASETS.PROPOSAL_FILES_TEST = (register_synthetic_cocovar(name, num=GATE_VAR_SCENES),)
        state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
        runs = {k: jtsm_score_once(cfg, state, dev, kernel) for k, dev in (("card", DEVICE), ("cpu", "cpu"))}
        (res_card, out_card, launches, _, _), (res_cpu, out_cpu, _, t_cpu, _) = runs["card"], runs["cpu"]
        if launches != GATE_VAR_SCENES:
            raise AssertionError(f"jtsm gate scoring on the card: roi_align_fwd launched {launches} times for "
                                 f"{GATE_VAR_SCENES} images, not once each")
        m = {"matched": 0, "reordered": 0, "at_cut": 0, "boxes": 0.0, "scores": 0.0, "masks": 0.0, "flip": 0.0}
        sem_pixels, sem_differ, sem_gap = 0, 0, 0.0
        for bc, bh in zip(out_card, out_cpu):
            one = match_detections(bc, bh, score_tol=1e-4)
            for k in ("matched", "reordered", "at_cut"):
                m[k] += one[k]
            for k, src in (("boxes", "boxes"), ("scores", "scores"), ("masks", "masks"), ("flip", "flip_margin")):
                m[k] = max(m[k], one[src])
            for i, (sc, sh) in enumerate(zip(bc["sem_seg"], bh["sem_seg"])):
                sem_pixels += sh.size
                diff = np.argwhere(sc != sh)
                if len(diff):
                    sem_differ += len(diff)
                    gaps = sem_seg_near_ties(bh["sem_seg_logits"][i], bh["image_sizes"][i], sh.shape,
                                             torch.as_tensor(diff))
                    sem_gap = max(sem_gap, gaps.max().item())
        task_diff = {t: abs(res_card[t][k] - res_cpu[t][k]) for t, k in JTSM_TASK_METRICS}
        log(f"[jtsm_score] gate checkpoint (float32) on the {GATE_VAR_SCENES} in-memory cocovar scenes: card "
            f"{format_jtsm(res_card)} | cpu {format_jtsm(res_cpu)} (cpu {t_cpu['total']:.1f}s) | detections matched "
            f"by (source proposal, class): {m['matched']}, {m['reordered']} in another slot, {m['at_cut']} at the "
            f"cut; boxes max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4), mask "
            f"probabilities {m['masks']:.3e} (tol 1e-4, pixels across 0.5 within {m['flip']:.3e} of it) | sem_seg "
            f"maps: {sem_differ} of {sem_pixels} pixels differ, their two largest logits within {sem_gap:.3e} "
            f"(tol 1e-4) | task diffs " + " ".join(f"{t}={d:.4f}" for t, d in task_diff.items())
            + f" (tol 0.02) | roi_align_fwd_launches={launches}")
        if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["flip"] <= 1e-4):
            raise AssertionError(f"jtsm gate scoring: the card's detections disagree with the CPU's: {m}")
        if sem_differ and not sem_gap <= 1e-4:
            raise AssertionError(f"jtsm gate scoring: sem_seg maps differ where the logits are {sem_gap} apart")
        if not max(task_diff.values()) <= 0.02:
            raise AssertionError(f"jtsm gate scoring: the card's numbers differ from the CPU's by {task_diff}")
        total = launches

        # (b) the flagship at full width: VOC scenes, bf16 and f32 in turns
        name = "chip_smoke_jtsm_voc"
        t0 = time.perf_counter()
        base = jtsm_WSR_18_DC5_cfg()
        coco, images, sem_maps, pan_maps, pan_json, props = voc_scenes(
            JTSM_SCORE_SCENES, 3, base.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
        register_synthetic_panoptic(name, coco, images, sem_maps, pan_maps, pan_json,
                                    _voc_sbd_panoptic_separated_meta())
        log(f"[jtsm_score] {JTSM_SCORE_SCENES} seeded VOC scenes {JTSM_IMAGE_HW}, {len(coco['annotations'])} things, "
            f"{props['boxes'][0].shape[0]} proposals and {JTSM_SUPERPIXELS} superpixels each, made in "
            f"{time.perf_counter() - t0:.1f}s")
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        stats = {d: [] for d in dtypes}
        for i in range(JTSM_SCORE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                c = base.clone()
                c.TEST.AUG.ENABLED = False  # one view; TTA is phase 13's
                c.TPU.COMPUTE_DTYPE = d
                c.DATASETS.TEST = (name,)
                c.DATASETS.PROPOSAL_FILES_TEST = (props,)
                results, outs, n, timings, peak = jtsm_score_once(c, flagship_state, DEVICE, kernel)
                total += n
                if n != JTSM_SCORE_SCENES:
                    raise AssertionError(f"jtsm flagship scoring {d}: roi_align_fwd launched {n} times for "
                                         f"{JTSM_SCORE_SCENES} images, not once each")
                missing = [(t, k) for t, k in JTSM_TASK_METRICS if t not in results or k not in results[t]]
                shapes = {out["panoptic_seg"][j][0].shape for out in outs for j in range(len(out["panoptic_seg"]))}
                if missing or shapes != {JTSM_IMAGE_HW}:
                    raise AssertionError(f"jtsm flagship scoring {d}: missing {missing}, panoptic maps {shapes}")
                stats[d].append((results, timings, peak, n))
        stages = ("data", "model", "fusion", "paste", "encode", "eval", "eval_sem_seg", "eval_panoptic_seg", "total")
        for d in dtypes:
            per_image = {k: sum(r[1].get(k, 0.0) for r in stats[d]) / sum(r[1]["images"] for r in stats[d])
                         for k in stages}
            log(f"[jtsm_score] JTSM WSR-18 DC5 {DTYPE_NAMES[d]}, {JTSM_SCORE_SCENES} VOC scenes "
                f"{JTSM_IMAGE_HW[0]}x{JTSM_IMAGE_HW[1]} at {base.INPUT.MIN_SIZE_TEST}, {JTSM_SCORE_ROUNDS} runs in "
                "turns: seconds per image " + " ".join(f"{k}={v:.5f}" for k, v in per_image.items())
                + f" (eval = COCOEval) | roi_align_fwd_launches={sum(r[3] for r in stats[d])} "
                f"peak_mem_gib={max(r[2] for r in stats[d]):.3f} | random weights: {format_jtsm(stats[d][0][0])} "
                "(not checked)")
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    return total


# phase 13: test-time augmentation
TTA_GATE_SCENES = 6  # of the 12 cocovar scenes: the CPU's half of 13(a) stays near 20 s
TTA_GATE_AUG = ((112, 128), 176)  # short sides and long-side cap: every gate view fits [[128, 176], [176, 176]]
TTA_SCORE_SCENES = 4
TTA_SCORE_ROUNDS = 2  # flagship TTA runs in each dtype, in turns
# the flagship's default buckets, then (1344, 1344), where the 864 view of a
# VOC image lands by the default fallback, and (1200, 1600), which holds the
# 1200 view that no default bucket holds
TTA_BUCKETS = [[800, 1344], [1344, 800], [1024, 1024], [1344, 1344], [1200, 1600]]
TTA_STAGES = ("tta_resize", "tta_views", "tta_logits", "tta_merge", "tta_rerun", "fusion", "paste", "encode", "eval",
              "eval_sem_seg", "eval_panoptic_seg", "total")


class recording:
    """Within the block, every call of ``cls`` (a TTA wrapper) appends its
    merged result to ``self.merged``."""

    def __init__(self, cls):
        self.cls, self.merged = cls, []

    def __enter__(self):
        call, merged = self.cls.__call__, self.merged

        def record(wrapper, *args, **kwargs):
            merged.append(call(wrapper, *args, **kwargs))
            return merged[-1]

        self.call, self.cls.__call__ = call, record
        return self

    def __exit__(self, *exc):
        self.cls.__call__ = self.call


def tta_score_once(cfg, state_dict, device, kernel, wrapper):
    """The WSL command's ``test_with_TTA`` (a WSL ``cfg``) or
    ``engine.defaults.test`` with TEST.AUG on (Mask R-CNN) of ``cfg`` on
    ``device``, K1's count set to 0 just before and read just after, the
    evaluators writing nothing: returns the results, each image's merged
    result of ``wrapper``, K1's launches, the seconds of each stage and
    the peak device memory of the run (GiB above what was allocated
    before)."""
    import torch

    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import COCOEvaluator, COCOPanopticEvaluator, DatasetEvaluators, SemSegEvaluator
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl import train_net

    model = build_model(cfg, device=device)
    model.load_state_dict(state_dict)
    wsl = cfg.MODEL.META_ARCHITECTURE == "GeneralizedMCNNWSL"

    def build_evaluator(cfg_, name, timings=None):
        if not wsl:
            return COCOEvaluator(name, timings=timings)
        return DatasetEvaluators([COCOEvaluator(name, timings=timings), SemSegEvaluator(name, timings=timings),
                                  COCOPanopticEvaluator(name, timings=timings)])

    timings = {}
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    with recording(wrapper) as rec:
        kernel.launches = 0
        t0 = time.perf_counter()
        if wsl:
            results = train_net.test_with_TTA(cfg, model, timings, build_evaluator)
        else:
            results = test(cfg, model, timings=timings, build_evaluator=build_evaluator)
        timings["total"] = time.perf_counter() - t0
        launches = kernel.launches
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30 if on_card else float("nan")
    return results, rec.merged, launches, timings, peak


def match_merged(card, host, score_tol):
    """The merged detections of two runs on one image matched by class and
    box (within 1e-3 px): the largest box, score and mask-probability
    differences. A detection on one side only must score within
    ``score_tol`` of the lower of the two runs' last scores (the cut at the
    detection count)."""
    import numpy as np

    out = dict(matched=0, at_cut=0, boxes=0.0, scores=0.0, masks=0.0)
    free = list(range(len(host["boxes"])))
    cut = min([float(host["scores"].min(initial=np.inf)), float(card["scores"].min(initial=np.inf))])
    for i in range(len(card["boxes"])):
        for n, j in enumerate(free):
            if (card["classes"][i] == host["classes"][j] and np.abs(card["boxes"][i] - host["boxes"][j]).max() <= 1e-3
                    and abs(float(card["scores"][i] - host["scores"][j])) <= score_tol):
                out["matched"] += 1
                out["boxes"] = max(out["boxes"], float(np.abs(card["boxes"][i] - host["boxes"][j]).max()))
                out["scores"] = max(out["scores"], abs(float(card["scores"][i] - host["scores"][j])))
                if "masks" in card:
                    out["masks"] = max(out["masks"], float(np.abs(card["masks"][i] - host["masks"][j]).max()))
                free.pop(n)
                break
        else:
            if float(card["scores"][i]) > cut + score_tol:
                raise AssertionError(f"TTA detection {i} (score {float(card['scores'][i])}) only on the card")
            out["at_cut"] += 1
    for j in free:
        if float(host["scores"][j]) > cut + score_tol:
            raise AssertionError(f"TTA detection {j} (score {float(host['scores'][j])}) only on the CPU")
        out["at_cut"] += 1
    return out


def register_first_scenes(name, coco, images, n, metadata, panoptic=False):
    """The first ``n`` of a synthetic set's scenes, registered in memory as
    ``name``: the COCO set with ``metadata``, or the separated panoptic set
    with its stuff and panoptic maps. Returns the proposal dict of a
    panoptic set."""
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.coco import load_coco_json
    from jtsm_tpu_torch.data.datasets.synthetic import (IMAGE_DIR, make_panoptic_and_proposals,
                                                        register_synthetic_panoptic)

    ids = {im["id"] for im in coco["images"][:n]}
    coco = dict(coco, images=coco["images"][:n], annotations=[a for a in coco["annotations"] if a["image_id"] in ids])
    if panoptic:
        pan_maps, sem_maps, pan_json, proposals = make_panoptic_and_proposals(coco)
        register_synthetic_panoptic(name, coco, images, sem_maps, pan_maps, pan_json, metadata)
        return proposals

    def load():
        records = load_coco_json(coco, IMAGE_DIR, name)
        for r in records:
            r["image"] = images[r["image_id"]]
        return records

    DatasetCatalog.register(name, load)
    MetadataCatalog.get(name).set(json_file=coco, image_root=IMAGE_DIR, evaluator_type="coco", **metadata)
    return None


def phase_jtsm_tta(kernel, gen, baseline, flagship_state, card):
    """Phase 13: (a) the JTSM gate with TTA on the card against the CPU;
    (b) K1 at the largest view's mask pooler shape, then the JTSM flagship
    scored with its TEST.AUG by stage (``card``, nvidia-smi's name and
    power limit, printed beside the times); (c) the Mask R-CNN gate with
    TTA on the card against the CPU. Returns K1's rows and its launches."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.modeling.test_time_augmentation as tta
    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_gate_cfg, jtsm_WSR_18_DC5_cfg, mask_rcnn_gate_cfg
    from jtsm_tpu_torch.data.datasets.builtin_meta import _get_builtin_metadata
    from jtsm_tpu_torch.data.datasets.synthetic import VARIED_SEED, make_synthetic_coco, register_synthetic_panoptic
    from jtsm_tpu_torch.wsl.builtin import _voc_sbd_panoptic_separated_meta

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in TTA scoring")
        return routed(features, scales, boxes, *a, **k)

    sizes, max_size = TTA_GATE_AUG
    views = len(sizes) * 2
    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        # (a) the JTSM gate: the card against the CPU, float32
        name = "chip_smoke_tta_gate"
        cfg = jtsm_gate_cfg()
        coco, images = make_synthetic_coco(GATE_VAR_SCENES, VARIED_SEED, varied=True)
        proposals = register_first_scenes(name, coco, images, TTA_GATE_SCENES,
                                          _get_builtin_metadata("coco_panoptic_separated"), panoptic=True)
        cfg.DATASETS.TEST = cfg.DATASETS.TRAIN = (name,)
        cfg.DATASETS.PROPOSAL_FILES_TEST = (proposals,)
        cfg.TEST.AUG.ENABLED, cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.MAX_SIZE = True, sizes, max_size
        state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
        runs = {k: tta_score_once(cfg, state, dev, kernel, tta.GeneralizedRCNNWithTTAAVG)
                for k, dev in (("card", DEVICE), ("cpu", "cpu"))}
        (res_card, m_card, launches, _, _), (res_cpu, m_cpu, _, t_cpu, _) = runs["card"], runs["cpu"]
        if launches != TTA_GATE_SCENES * views * 2:
            raise AssertionError(f"jtsm gate TTA on the card: roi_align_fwd launched {launches} times for "
                                 f"{TTA_GATE_SCENES} images of {views} views, not twice a view")
        m = {"matched": 0, "at_cut": 0, "boxes": 0.0, "scores": 0.0, "masks": 0.0, "class_scores": 0.0, "logits": 0.0}
        sem_differ = sem_pixels = 0
        sem_gap = 0.0
        for mc, mh in zip(m_card, m_cpu):
            one = match_merged(mc["detections"], mh["detections"], score_tol=1e-4)
            for k in one:
                m[k] = m[k] + one[k] if k in ("matched", "at_cut") else max(m[k], one[k])
            m["class_scores"] = max(m["class_scores"], float(np.abs(mc["proposal_class_scores"]
                                                                    - mh["proposal_class_scores"]).max()))
            m["logits"] = max(m["logits"], float(np.abs(mc["sem_seg_logits"] - mh["sem_seg_logits"]).max()))
            sc, sh = mc["sem_seg_logits"].argmax(-1), mh["sem_seg_logits"].argmax(-1)
            sem_pixels += sh.size
            diff = sc != sh
            if diff.any():
                sem_differ += int(diff.sum())
                top2 = np.sort(mh["sem_seg_logits"][diff], -1)[:, -2:]
                sem_gap = max(sem_gap, float((top2[:, 1] - top2[:, 0]).max()))
        task_diff = {t: abs(res_card[t][k] - res_cpu[t][k]) for t, k in JTSM_TASK_METRICS}
        log(f"[jtsm_tta] gate checkpoint (float32) with TTA ({views} views: short sides {list(sizes)}, long side "
            f"<= {max_size}, and their flips) on {TTA_GATE_SCENES} in-memory cocovar scenes: card "
            f"{format_jtsm(res_card)} | cpu {format_jtsm(res_cpu)} (cpu {t_cpu['total']:.1f}s) | merged detections "
            f"matched by class and box: {m['matched']}, {m['at_cut']} at the cut; boxes max_abs_err={m['boxes']:.3e} "
            f"px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4), re-run mask probabilities {m['masks']:.3e} (tol "
            f"1e-4), mean class scores {m['class_scores']:.3e}, merged sem-seg logits {m['logits']:.3e} (tol 1e-4) "
            f"| their argmax: {sem_differ} of {sem_pixels} pixels differ, the two largest logits within "
            f"{sem_gap:.3e} | task diffs " + " ".join(f"{t}={d:.4f}" for t, d in task_diff.items())
            + f" (tol 0.02) | roi_align_fwd_launches={launches} (twice a view)")
        if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["logits"] <= 1e-4):
            raise AssertionError(f"jtsm gate TTA: the card's merged outputs disagree with the CPU's: {m}")
        if sem_differ and not sem_gap <= 1e-4:
            raise AssertionError(f"jtsm gate TTA: sem-seg maps differ where the logits are {sem_gap} apart")
        if not max(task_diff.values()) <= 0.02:
            raise AssertionError(f"jtsm gate TTA: the card's numbers differ from the CPU's by {task_diff}")
        total = launches

        # (b) K1 at the largest view's mask pooler shape: res5 at stride 16
        # of the 1200x1600 view, 100 detections
        rows = {}
        for dtype in (torch.float32, torch.bfloat16):
            feat = torch.randn((1, 75, 100, 512), generator=gen, device=DEVICE).to(dtype)
            boxes = jtsm_mask_boxes(gen, 100, (1200, 1600))
            zeros = torch.zeros(100, dtype=torch.int32, device=DEVICE)
            tag = f"tta mask pooler {'bf16' if dtype == torch.bfloat16 else 'f32'} (L=1, 1200 view)"
            rows[tag] = check_and_time_fwd(tag, [feat], [1.0 / 16], boxes, zeros, zeros, 14, baseline,
                                           phase="jtsm_tta")

        # the flagship with its TEST.AUG, VOC scenes, bf16 and f32 in turns
        name = "chip_smoke_tta_voc"
        base = jtsm_WSR_18_DC5_cfg()
        if not base.TEST.AUG.ENABLED:
            raise AssertionError("the JTSM flagship's TEST.AUG.ENABLED is off")
        n_views = len(base.TEST.AUG.MIN_SIZES) * (2 if base.TEST.AUG.FLIP else 1)
        t0 = time.perf_counter()
        coco, images, sem_maps, pan_maps, pan_json, props = voc_scenes(
            TTA_SCORE_SCENES, 4, base.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
        register_synthetic_panoptic(name, coco, images, sem_maps, pan_maps, pan_json,
                                    _voc_sbd_panoptic_separated_meta())
        log(f"[jtsm_tta] flagship TEST.AUG: MIN_SIZES {list(base.TEST.AUG.MIN_SIZES)}, MAX_SIZE "
            f"{base.TEST.AUG.MAX_SIZE}, FLIP {base.TEST.AUG.FLIP}: {n_views} views and {2 * n_views} passes an image "
            f"(the mask re-run); {TTA_SCORE_SCENES} seeded VOC scenes {JTSM_IMAGE_HW} made in "
            f"{time.perf_counter() - t0:.1f}s | cut: TPU.IMAGE_BUCKETS {TTA_BUCKETS} in place of "
            f"{base.TPU.IMAGE_BUCKETS}, since no default bucket holds the 1200 view (1200x1600) of a VOC image "
            "and the JAX package raises there; (1344, 1344) keeps the 864 view where the default fallback puts it "
            "| cut: TEST.EVAL_TRAIN off (the VOC train sets are not in the repository)")
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        stats = {d: [] for d in dtypes}
        plain_runs = {d: [] for d in dtypes}
        for i in range(TTA_SCORE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                c = base.clone()
                c.TPU.COMPUTE_DTYPE = d
                c.TPU.IMAGE_BUCKETS = TTA_BUCKETS
                c.TEST.EVAL_TRAIN = False
                c.DATASETS.TEST = (name,)
                c.DATASETS.PROPOSAL_FILES_TEST = (props,)
                results, merged, n, timings, peak = tta_score_once(c, flagship_state, DEVICE, kernel,
                                                                   tta.GeneralizedRCNNWithTTAAVG)
                total += n
                if n != TTA_SCORE_SCENES * n_views * 2:
                    raise AssertionError(f"jtsm flagship TTA {d}: roi_align_fwd launched {n} times for "
                                         f"{TTA_SCORE_SCENES} images, not {2 * n_views} each")
                missing = [(t, k) for t, k in JTSM_TASK_METRICS if t not in results or k not in results[t]]
                bad = [mg["sem_seg_logits"].shape for mg in merged
                       if mg["sem_seg_logits"].shape[:2] != JTSM_IMAGE_HW or not np.isfinite(mg["sem_seg_logits"]).all()
                       or not np.isfinite(mg["detections"]["masks"]).all()]
                if missing or bad or len(merged) != TTA_SCORE_SCENES:
                    raise AssertionError(f"jtsm flagship TTA {d}: missing {missing}, merged logits {bad}")
                stats[d].append((results, timings, peak, n))
                c.TEST.AUG.ENABLED = False
                c.TPU.IMAGE_BUCKETS = base.TPU.IMAGE_BUCKETS
                _, _, n, timings, _ = jtsm_score_once(c, flagship_state, DEVICE, kernel)
                if n != TTA_SCORE_SCENES:
                    raise AssertionError(f"jtsm flagship {d} without TTA: roi_align_fwd launched {n} times")
                plain_runs[d].append(timings)
                total += n
        for d in dtypes:
            n_img = sum(r[1]["images"] for r in stats[d])
            per_image = {k: sum(r[1].get(k, 0.0) for r in stats[d]) / n_img for k in TTA_STAGES}
            off = sum(t["total"] for t in plain_runs[d]) / sum(t["images"] for t in plain_runs[d])
            log(f"[jtsm_tta] JTSM WSR-18 DC5 {DTYPE_NAMES[d]} with TTA on {card}, {TTA_SCORE_SCENES} VOC scenes "
                f"{JTSM_IMAGE_HW[0]}x{JTSM_IMAGE_HW[1]}, {TTA_SCORE_ROUNDS} runs in turns: seconds per image "
                + " ".join(f"{k}={v:.5f}" for k, v in per_image.items())
                + f" (tta_views = the {n_views} views' passes to their scores on the host, tta_logits = the logits "
                f"to the host and resized back, eval = COCOEval) | TTA off on the same scenes total={off:.5f}, "
                f"ratio {per_image['total'] / off:.2f} | roi_align_fwd_launches={sum(r[3] for r in stats[d])} "
                f"({2 * n_views} an image) peak_mem_gib={max(r[2] for r in stats[d]):.3f} | random weights: "
                f"{format_jtsm(stats[d][0][0])} (not checked)")

        # (c) the Mask R-CNN gate with TTA: the card against the CPU
        name = "chip_smoke_tta_coco"
        cfg = mask_rcnn_gate_cfg()
        coco, images = make_synthetic_coco(GATE_SCENES, 0)
        register_first_scenes(name, coco, images, 2, _get_builtin_metadata("coco"))
        cfg.DATASETS.TEST = (name,)
        cfg.TEST.AUG.ENABLED, cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.MAX_SIZE = True, sizes, max_size
        state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
        runs = {k: tta_score_once(cfg, state, dev, kernel, tta.GeneralizedRCNNWithTTA)
                for k, dev in (("card", DEVICE), ("cpu", "cpu"))}
        (res_card, m_card, n, _, _), (res_cpu, m_cpu, _, _, _) = runs["card"], runs["cpu"]
        m = {"matched": 0, "at_cut": 0, "boxes": 0.0, "scores": 0.0, "masks": 0.0}
        for mc, mh in zip(m_card, m_cpu):
            one = match_merged(mc, mh, score_tol=1e-4)
            for k in one:
                m[k] = m[k] + one[k] if k in ("matched", "at_cut") else max(m[k], one[k])
        # the box and mask poolers in each view's pass, the mask pooler in its re-run
        want_n = sum(3 if len(mh["boxes"]) else 2 for mh in m_card) * views
        log(f"[jtsm_tta] Mask R-CNN gate checkpoint (float32) with TTA ({views} views) on 2 in-memory scenes: card "
            f"bbox_AP={res_card['bbox']['AP']:.4f} | cpu bbox_AP={res_cpu['bbox']['AP']:.4f} | merged detections "
            f"matched by class and box: {m['matched']}, {m['at_cut']} at the cut; boxes max_abs_err="
            f"{m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4), re-run mask probabilities "
            f"{m['masks']:.3e} (tol 1e-4) | roi_align_fwd_launches={n}")
        if not (m["matched"] > 0 and m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4):
            raise AssertionError(f"Mask R-CNN gate TTA: the card's merged detections disagree with the CPU's: {m}")
        if n != want_n or abs(res_card["bbox"]["AP"] - res_cpu["bbox"]["AP"]) > 0.02:
            raise AssertionError(f"Mask R-CNN gate TTA: {n} launches (not {want_n}), bbox AP "
                                 f"{res_card['bbox']['AP']} against {res_cpu['bbox']['AP']}")
        total += n
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    return rows, total


TC_SCENES = 16  # synthetic COCO scenes of SCORE_HW for the Mask R-CNN trainer
TC_ITERS = 20
TC_PERIOD = 10  # SOLVER.CHECKPOINT_PERIOD: model_0000009 and model_0000019
TC_WORKERS = (0, 4)  # DATALOADER.NUM_WORKERS: the config's, then 4 mapping threads
TC_BARE_STEPS = 8  # the bare train step on batches collated beforehand
TC_TIMED_FROM = 5  # the medians skip the first iterations
TC_JTSM_SCENES = 8
TC_JTSM_ITERS = 8  # mini-batches: 2 updates of WSL.ITER_SIZE 4
TC_JTSM_BUCKETS = [[800, 1344], [1344, 800], [1024, 1024], [1216, 1600], [1600, 1216]]
TC_GATE_ITERS = 3


def train_recorder(kernels, watch=(), losses=False):
    """A trainer hook that keeps, for each iteration, the kernels' launches
    in it, the step's losses when ``losses`` (read on the host, one sync an
    iteration) and, for each watched parameter, its first elements (before
    training too)."""
    from jtsm_tpu_torch.engine.hooks import HookBase

    class Recorder(HookBase):
        def __init__(self):
            self.kernels, self.watch = kernels, list(watch)
            self.launches, self.params, self.losses = [], [], []

        def snapshot(self):
            if self.watch:
                self.params.append([p.detach().reshape(-1)[:256].clone() for p in self.watch])

        def before_train(self):
            self.snapshot()

        def before_step(self):
            self._before = [k.launches for k in self.kernels]

        def after_step(self):
            self.launches.append([k.launches - b for k, b in zip(self.kernels, self._before)])
            self.snapshot()
            if losses:
                self.losses.append({k: v.item() for k, v in self.trainer._trainer._pending_metrics.items()})

    return Recorder()


def run_trainer(trainer_class, cfg, kernels, state_dict=None, resume=False, watch=None, losses=False):
    """``default_setup(cfg)`` (OUTPUT_DIR, the seeds), then
    ``trainer_class(cfg)`` on the card (``state_dict`` loaded, or resumed
    from OUTPUT_DIR), ``metrics.json`` written every iteration, a
    ``train_recorder`` hooked in; the kernels' counts set to 0 just before
    ``train()`` and read after. Returns the trainer, the recorder, the
    launches and the peak memory in GiB."""
    import torch

    from jtsm_tpu_torch.engine import default_setup, hooks

    default_setup(cfg)
    trainer = trainer_class(cfg)
    if state_dict is not None:
        trainer.model.load_state_dict(state_dict)
    trainer.resume_or_load(resume=resume)
    for h in trainer._hooks:
        if isinstance(h, hooks.PeriodicWriter):
            h._period = 1
    rec = train_recorder(kernels, watch(trainer.model) if watch else (), losses)
    trainer.register_hooks([rec])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    trainer.train()
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    return trainer, rec, launches, torch.cuda.max_memory_allocated() / 2**30


def read_metrics(out):
    with open(os.path.join(out, "metrics.json")) as f:
        return [json.loads(line) for line in f]


def median(values):
    values = sorted(values)
    return values[len(values) // 2] if values else float("nan")


def iteration_times(trainer, name, first=TC_TIMED_FROM):
    """The raw per-iteration values of the trainer's scalar ``name`` from
    iteration ``first`` on."""
    return [v for v, it in trainer.storage.history(name).values() if it >= first]


def check_launches(tag, rec, per_iteration):
    """Every iteration launched each kernel ``per_iteration[name]`` times."""
    names = [k.name for k in rec.kernels]
    want = [per_iteration[n] for n in names]
    for i, got in enumerate(rec.launches):
        if got != want:
            raise AssertionError(f"{tag} iteration {i}: launches {dict(zip(names, got))}, not {per_iteration}")


def bare_steps(cfg, model, batches):
    """The train step alone on batches collated beforehand (phase 7's
    measure): the milliseconds of each step, synchronized."""
    import torch

    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    step = make_train_step(model, optimizer, build_lr_schedule(cfg))
    times = []
    for batch in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, {k: v for k, v in batch.items() if k != "image_ids"})
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


def phase_train_cli(kernels, jtsm_state):
    """Phase 14: the port trains through its trainers, as its command line
    does. (a) Mask R-CNN R50-FPN at full width in bf16 (``DefaultTrainer``,
    phase 4's seed through ``family_train_state``) on in-memory synthetic
    COCO scenes, at NUM_WORKERS 0 and 4; (b) resume
    from its iteration-9 checkpoint; (c) the JTSM flagship through the WSL
    trainer, ITER_SIZE 4; (d) the Mask R-CNN gate (float32) through the
    trainer with K1/K2 and with the plain ROIAlign. Returns the launches of
    each kernel on the trainers' paths."""
    import shutil
    import tempfile

    import torch

    import jtsm_tpu_torch.modeling.poolers as poolers
    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.config import jtsm_WSR_18_DC5_cfg, mask_rcnn_gate_cfg, mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.data.build import build_detection_train_loader
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco, register_synthetic_panoptic
    from jtsm_tpu_torch.engine import DefaultTrainer
    from jtsm_tpu_torch.wsl.builtin import _voc_sbd_panoptic_separated_meta
    from jtsm_tpu_torch.wsl.train_net import Trainer as WSLTrainer

    names = [k.name for k in kernels]
    total = dict.fromkeys(names, 0)
    plain = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card under the trainer")
        return plain(features, scales, boxes, *a, **k)

    def add(launches):
        for n in names:
            total[n] += launches[n]

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_cli_")
    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        # (a) Mask R-CNN through DefaultTrainer, NUM_WORKERS 0 and 4
        coco_name = "chip_smoke_train_coco"
        register_synthetic_coco(coco_name, num=TC_SCENES, seed=5, image_hw=SCORE_HW)

        def mrcnn_cfg(out, workers):
            cfg = mask_rcnn_R_50_FPN_cfg()
            cfg.DATASETS.TRAIN = (coco_name,)
            cfg.SOLVER.IMS_PER_BATCH = TRAIN_BATCH
            cfg.SOLVER.MAX_ITER = TC_ITERS
            cfg.SOLVER.CHECKPOINT_PERIOD = TC_PERIOD
            cfg.DATALOADER.NUM_WORKERS = workers
            cfg.MODEL.WEIGHTS = ""
            cfg.OUTPUT_DIR = out
            cfg.SEED = 0
            return cfg

        base = mask_rcnn_R_50_FPN_cfg()
        # phase 4's seed with the FrozenBN statistics calibrated: from the raw
        # seeded ResNet (res3-res5 maps of spread near 100) the bf16 losses of
        # the NUM_WORKERS 4 run reached NaN at iteration 18 in one run on an H100
        # and stayed finite in others (K2's atomics and cuDNN vary the path)
        start = family_train_state(base, seed=0)
        log(f"[train_cli] (a) Mask R-CNN R50-FPN {base.TPU.COMPUTE_DTYPE} through DefaultTrainer on {TC_SCENES} "
            f"synthetic scenes {SCORE_HW}, INPUT.MIN_SIZE_TRAIN {tuple(base.INPUT.MIN_SIZE_TRAIN)} "
            f"({base.INPUT.MIN_SIZE_TRAIN_SAMPLING}), MAX_SIZE_TRAIN {base.INPUT.MAX_SIZE_TRAIN}, flip "
            f"{base.INPUT.RANDOM_FLIP}, {TC_ITERS} iterations, CHECKPOINT_PERIOD {TC_PERIOD} | cut: IMS_PER_BATCH "
            f"{TRAIN_BATCH} (the reference's {base.SOLVER.IMS_PER_BATCH} is 8 cards x {TRAIN_BATCH}); MAX_ITER "
            f"{TC_ITERS}; phase 4's seed with calibrated FrozenBN statistics (family_train_state; from the raw "
            "seeded backbone the bf16 losses can reach NaN within 20 iterations)")
        runs = {}
        for workers in TC_WORKERS:
            out = os.path.join(tmp, f"mrcnn_w{workers}")
            trainer, rec, launches, peak = run_trainer(DefaultTrainer, mrcnn_cfg(out, workers), kernels, start)
            check_launches(f"mask rcnn trainer (NUM_WORKERS {workers})", rec, dict.fromkeys(names, 2))
            add(launches)
            metrics = read_metrics(out)
            if [m["iteration"] for m in metrics] != list(range(TC_ITERS)):
                raise AssertionError(f"metrics.json holds iterations {[m['iteration'] for m in metrics]}")
            losses = {k: v for m in metrics[1:] for k, v in m.items() if k.startswith("loss")}
            if len(losses) != 5 or not all(math.isfinite(m[k]) for m in metrics[1:] for k in losses):
                raise AssertionError(f"metrics.json losses: {metrics[-1]}")
            files = sorted(os.listdir(out))
            for f in ("model_0000009.pth", "model_0000019.pth", "model_final.pth", "last_checkpoint"):
                if f not in files:
                    raise AssertionError(f"{f} not written: {files}")
            loader = trainer.data_loader
            s_iter = median(iteration_times(trainer, "time"))
            data_time = median(iteration_times(trainer, "data_time"))
            runs[workers] = dict(out=out, s_iter=s_iter, data_time=data_time, peak=peak,
                                 loader=loader.busy_seconds / loader.batches, mapping=loader.map_seconds / loader.batches,
                                 metrics=metrics, trainer=trainer)
            log(f"[train_cli] (a) NUM_WORKERS {workers}: s/iter median (iterations {TC_TIMED_FROM}-{TC_ITERS - 1}) "
                f"{s_iter:.4f} data_time median {data_time:.4f} loader s/batch {runs[workers]['loader']:.4f} "
                f"mapping s/batch {runs[workers]['mapping']:.4f} "
                f"({loader.batches} batches produced) launches {launches} peak_mem_gib {peak:.3f} "
                f"final losses {metrics[-1]['total_loss']:.4f} checkpoints {[f for f in files if f.endswith('.pth')]}")
        # the bare step on the same kind of batches, collated beforehand
        first = runs[TC_WORKERS[0]]
        it = iter(build_detection_train_loader(mrcnn_cfg("", 0)))
        batches = [next(it) for _ in range(TC_BARE_STEPS)]
        it.close()
        bare = bare_steps(mrcnn_cfg("", 0), first["trainer"].model, batches)
        log(f"[train_cli] (a) bare train_step on {TC_BARE_STEPS} batches collated beforehand: ms "
            f"{[round(t, 3) for t in bare]} median_after_first {median(bare[1:]):.3f}; per iteration the trainer "
            f"takes {first['s_iter'] * 1e3:.3f} ms at NUM_WORKERS 0 and "
            f"{runs[TC_WORKERS[1]]['s_iter'] * 1e3:.3f} ms at {TC_WORKERS[1]}")
        for r in runs.values():
            r.pop("trainer")
        first.update(bare_ms=median(bare[1:]))

        # (b) resume from model_0000009.pth in a fresh trainer
        out = os.path.join(tmp, "mrcnn_resume")
        os.makedirs(out)
        shutil.copy(os.path.join(first["out"], "model_0000009.pth"), out)
        with open(os.path.join(out, "last_checkpoint"), "w") as f:
            f.write("model_0000009.pth")
        saved = torch.load(os.path.join(out, "model_0000009.pth"), map_location="cpu", weights_only=False)
        trainer = DefaultTrainer(mrcnn_cfg(out, 0))
        trainer.resume_or_load(resume=True)
        if trainer.start_iter != TC_PERIOD or trainer.state.step != TC_PERIOD:
            raise AssertionError(f"resumed at iteration {trainer.start_iter}, update {trainer.state.step}")
        for k, v in trainer.model.state_dict().items():
            if not torch.equal(v.cpu(), saved["model"][k]):
                raise AssertionError(f"resumed parameter {k} differs from the checkpoint")
        opt = trainer.optimizer.state_dict()["state"]
        if len(opt) != len(saved["optimizer"]["state"]) or not all(
                torch.equal(opt[i]["momentum_buffer"].cpu(), s["momentum_buffer"])
                for i, s in saved["optimizer"]["state"].items()):
            raise AssertionError("resumed momentum buffers differ from the checkpoint")
        if not torch.equal(trainer.state.generator.get_state(), saved["trainer"]["generator"]):
            raise AssertionError("resumed generator state differs from the checkpoint")
        trainer._trainer.close()
        del trainer
        trainer, rec, launches, _ = run_trainer(DefaultTrainer, mrcnn_cfg(out, 0), kernels, resume=True)
        check_launches("resumed trainer", rec, dict.fromkeys(names, 2))
        add(launches)
        metrics = read_metrics(out)
        if [m["iteration"] for m in metrics] != list(range(TC_PERIOD, TC_ITERS)):
            raise AssertionError(f"the resumed run wrote iterations {[m['iteration'] for m in metrics]}")
        if metrics[0]["lr"] != first["metrics"][TC_PERIOD]["lr"]:
            raise AssertionError(f"resumed lr {metrics[0]['lr']} != {first['metrics'][TC_PERIOD]['lr']}")
        log(f"[train_cli] (b) resumed from model_0000009.pth: parameters, {len(opt)} momentum buffers, the generator "
            f"state and update {TC_PERIOD} equal the checkpoint's; iterations {TC_PERIOD}-{TC_ITERS - 1} ran, lr at "
            f"{TC_PERIOD} {metrics[0]['lr']:.6g} as uninterrupted, launches {launches}")
        del trainer

        # (c) the JTSM flagship through the WSL trainer, ITER_SIZE 4
        jtsm_name = "chip_smoke_train_voc"
        jbase = jtsm_WSR_18_DC5_cfg()
        coco, images, sem_maps, pan_maps, pan_json, props = voc_scenes(
            TC_JTSM_SCENES, 6, jbase.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN)
        register_synthetic_panoptic(jtsm_name, coco, images, sem_maps, pan_maps, pan_json,
                                    _voc_sbd_panoptic_separated_meta())
        jc = jtsm_WSR_18_DC5_cfg()
        jc.DATASETS.TRAIN = (jtsm_name,)
        jc.DATASETS.PROPOSAL_FILES_TRAIN = (props,)
        jc.TPU.IMAGE_BUCKETS = TC_JTSM_BUCKETS
        jc.SOLVER.MAX_ITER = TC_JTSM_ITERS
        jc.TEST.EVAL_PERIOD = 0
        jc.MODEL.WEIGHTS = ""
        jc.OUTPUT_DIR = os.path.join(tmp, "jtsm")
        jc.SEED = 0
        k = jc.WSL.ITER_SIZE
        log(f"[train_cli] (c) JTSM flagship {jc.TPU.COMPUTE_DTYPE} through the WSL trainer: ITER_SIZE {k}, "
            f"IMS_PER_BATCH {jc.SOLVER.IMS_PER_BATCH}, short sides {tuple(jc.INPUT.MIN_SIZE_TRAIN)} and the flip, "
            f"{TC_JTSM_SCENES} seeded VOC scenes {JTSM_IMAGE_HW} with {props['boxes'][0].shape[0]} proposals and "
            f"{JTSM_SUPERPIXELS} superpixels each, {TC_JTSM_ITERS} mini-batches | cut: TPU.IMAGE_BUCKETS "
            f"{TC_JTSM_BUCKETS} (no default bucket holds the 1200 scale's 1200x1600); TEST.EVAL_PERIOD 0 (no VOC "
            "test set here); random weights from phase 10's seed; MAX_ITER 8")
        trainer, rec, launches, peak = run_trainer(
            WSLTrainer, jc, kernels, jtsm_state,
            watch=lambda m: [p for p in m.parameters() if p.requires_grad])
        check_launches("jtsm trainer", rec, {names[0]: 1, names[1]: 0})
        add(launches)
        # rec.params[0] before training, rec.params[i] after mini-batch i
        moved = [sum(not torch.equal(a, b) for a, b in zip(rec.params[i], rec.params[i - 1]))
                 for i in range(1, TC_JTSM_ITERS + 1)]
        for i, n in enumerate(moved, 1):
            if (i % k == 0) != (n > 0):
                raise AssertionError(f"jtsm: {n} watched parameters moved at mini-batch {i} (ITER_SIZE {k}): {moved}")
        updated = [n for i, n in enumerate(moved, 1) if i % k == 0]
        metrics = read_metrics(jc.OUTPUT_DIR)
        if not all(math.isfinite(v) for m in metrics[1:] for key, v in m.items() if key.startswith("loss")):
            raise AssertionError(f"jtsm metrics.json: non-finite losses {metrics[-1]}")
        if trainer.state.step != TC_JTSM_ITERS // k:
            raise AssertionError(f"jtsm: {trainer.state.step} updates in {TC_JTSM_ITERS} mini-batches")
        s_iter = median(iteration_times(trainer, "time", 3))
        data_time = median(iteration_times(trainer, "data_time", 1))
        loader = trainer.data_loader
        log(f"[train_cli] (c) parameters unchanged after mini-batches 1-{k - 1} and moved at each {k}th "
            f"({updated} of {len(rec.params[0])} watched tensors); updates {trainer.state.step}; s/iter median "
            f"(mini-batches 4-{TC_JTSM_ITERS}) {s_iter:.4f} data_time median {data_time:.4f} loader s/batch "
            f"{loader.busy_seconds / loader.batches:.4f} mapping s/batch {loader.map_seconds / loader.batches:.4f} "
            f"launches {launches} peak_mem_gib {peak:.3f}")
        jtsm_run = dict(s_iter=s_iter, data_time=data_time, peak=peak)
        del trainer

        # (d) the gate (float32) through the trainer, K1/K2 against the plain ROIAlign
        gate_name = "chip_smoke_train_gate"
        register_synthetic_coco(gate_name, num=GATE_SCENES, seed=0)
        gc = mask_rcnn_gate_cfg()
        gc.DATASETS.TRAIN = (gate_name,)
        gc.SOLVER.MAX_ITER = TC_GATE_ITERS
        gc.MODEL.WEIGHTS = ""
        gc.SEED = 0
        weights = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, mask_rcnn_gate_cfg().MODEL.WEIGHTS)))
        gate_losses = {}
        routed = poolers.roi_align_multilevel
        for route in ("kernel", "plain"):
            gc.OUTPUT_DIR = os.path.join(tmp, f"gate_{route}")
            if route == "plain":
                poolers.roi_align_multilevel = plain
            try:
                _, rec, launches, _ = run_trainer(DefaultTrainer, gc, kernels, weights, losses=True)
            finally:
                poolers.roi_align_multilevel = routed
            check_launches(f"gate trainer ({route})", rec, dict.fromkeys(names, 2 if route == "kernel" else 0))
            if route == "kernel":
                add(launches)
            gate_losses[route] = rec.losses
        err = max(abs(a[key] - b[key]) / max(abs(b[key]), 1e-12)
                  for a, b in zip(gate_losses["kernel"], gate_losses["plain"]) for key in b)
        log(f"[train_cli] (d) gate checkpoint (float32) through DefaultTrainer, {TC_GATE_ITERS} iterations: "
            f"K1/K2 against the plain ROIAlign on the card, max relative loss difference {err:.3e} (tol 1e-4); "
            f"losses {gate_losses['kernel'][-1]}")
        if not err <= 1e-4:
            raise AssertionError(f"gate trainer: kernel and plain losses differ by {err}")
    finally:
        roi_align.roi_align_multilevel_plain_autograd = plain
        shutil.rmtree(tmp, ignore_errors=True)
    return total, runs, jtsm_run


# phase 15: the other core meta-architectures, served and scored
FAMILIES = ("panoptic_fpn", "retinanet", "rpn", "keypoint_rcnn")
FAMILY_TITLES = {"panoptic_fpn": "Panoptic FPN R50", "retinanet": "RetinaNet R50-FPN", "rpn": "RPN R50-FPN",
                 "keypoint_rcnn": "Keypoint R-CNN R50-FPN"}
FAMILY_K1 = {"panoptic_fpn": 2, "retinanet": 0, "rpn": 0, "keypoint_rcnn": 2}  # box + mask, box + keypoint
FAMILY_METRICS = {"panoptic_fpn": (("bbox", "AP"), ("segm", "AP"), ("sem_seg", "mIoU"), ("panoptic_seg", "PQ")),
                  "retinanet": (("bbox", "AP"),), "rpn": (("box_proposals", "AR@100"), ("box_proposals", "AR@1000")),
                  "keypoint_rcnn": (("bbox", "AP"), ("keypoints", "AP"))}
FAMILY_TOL_METRIC = 5e-5  # the gates' numbers, to the pins' four decimals


def family_cfgs(family):
    """The full-width and the gate config of ``family`` (the Python builders)."""
    from jtsm_tpu_torch import config

    full = {"panoptic_fpn": "panoptic_fpn_R_50_cfg", "retinanet": "retinanet_R_50_FPN_cfg",
            "rpn": "rpn_R_50_FPN_cfg", "keypoint_rcnn": "keypoint_rcnn_R_50_FPN_cfg"}[family]
    return getattr(config, full)(), getattr(config, f"{family}_gate_cfg")()


def register_family_gate(family, name):
    """The gate's synthetic scenes in memory (the dev script's ``coco`` tree
    before JPEG): its separated panoptic set, its person keypoint set, or
    its instance set."""
    from jtsm_tpu_torch.data.datasets import synthetic

    register = {"panoptic_fpn": synthetic.register_synthetic_coco_panoptic,
                "keypoint_rcnn": synthetic.register_synthetic_coco_person}.get(family, synthetic.register_synthetic_coco)
    register(name, num=GATE_SCENES, seed=0)


def family_score_once(cfg, state, device, kernel):
    """``engine.defaults.test`` of ``cfg`` on ``device`` with the evaluators
    that ``build_evaluator`` picks (results written to a temporary
    directory): the results, the model's raw outputs batch by batch (on the
    host), K1's launches (count set to 0 just before) and the seconds."""
    import tempfile

    import numpy as np
    import torch

    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.modeling import build_model

    model = build_model(cfg, device=device)
    model.load_state_dict(state)
    inference, outputs = model.inference, []

    def capture(batch):
        out = inference(batch)
        outputs.append({k: v.detach().cpu() if torch.is_tensor(v) else v for k, v in out.items()})
        # the largest original-to-input size ratio of each image: the boxes'
        # rescale multiplies their differences by it
        sizes = [np.asarray(batch[k], np.float64) for k in ("orig_sizes", "image_sizes")]
        outputs[-1]["upscale"] = (sizes[0] / sizes[1]).max(axis=1)
        return out

    model.inference = capture
    with tempfile.TemporaryDirectory() as tmp:
        cfg = cfg.clone()
        cfg.OUTPUT_DIR = tmp
        kernel.launches = 0
        t0 = time.perf_counter()
        results = test(cfg, model)
        seconds = time.perf_counter() - t0
    return results, outputs, kernel.launches, seconds


def match_family_outputs(card, host, nms_thresh, score_tol=1e-4, box_tol=1e-3):
    """The detections (or proposals) of two runs on the same batch, matched
    image by image by class and box (within ``box_tol`` px of the network's
    input: times the image's ``upscale`` in its original coordinates) and
    score (within ``score_tol`` of the scores' scale): the largest box
    difference (in input pixels), score,
    mask-probability and keypoint (x, y within ``box_tol``) differences, and
    the keypoints that landed on another bin, whose two maxima must lie
    within ``score_tol`` of the heatmap logits' scale (a near-tie). A
    detection on one side only must be explained: it scores within the
    tolerance of the lower of the two runs' last kept scores (the cut), or
    the other side holds a higher-scored one of its class that overlaps it
    at IoU at least ``nms_thresh`` - 1e-3 and suppressed it there (a greedy
    NMS decision that float32 rounding flipped at the threshold, or one that
    follows from such a flip)."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.structures import pairwise_iou

    proposals = "proposals" in host
    boxes_key = "proposals" if proposals else "boxes"
    out = dict(matched=0, at_cut=0, suppressed=0, boxes=0.0, scores=0.0, masks=0.0, kp_xy=0.0, kp_moved=0,
               kp_tie=0.0)
    for i in range(host["scores"].shape[0]):
        sides = []
        for run in (card, host):
            scores = run["scores"][i].numpy().astype(np.float64)
            live = np.isfinite(scores) if proposals else run["valid"][i].numpy()
            idx = np.nonzero(live)[0]
            classes = np.zeros(len(idx), int) if proposals else run["classes"][i].numpy()[idx]
            sides.append((idx, scores[idx], classes, run[boxes_key][i].numpy()[idx].astype(np.float64)))
        (ic, sc, cc, bc), (ih, sh, ch, bh) = sides
        up = float(host["upscale"][i])
        tol = score_tol * max(1.0, float(np.abs(sh).max(initial=0.0)))
        cut = min(sc.min(initial=np.inf), sh.min(initial=np.inf))

        def explain(where, score, cls, box, other):
            _, s_o, c_o, b_o = other
            over = (c_o == cls) & (s_o >= score - tol)
            iou = float(pairwise_iou(torch.from_numpy(box[None]), torch.from_numpy(b_o[over])).max()) if over.any() else 0.0
            if score <= cut + tol:
                out["at_cut"] += 1
            elif iou >= nms_thresh - 1e-3:
                out["suppressed"] += 1
            else:
                raise AssertionError(f"image {i}: a detection only on the {where} (score {score}, class {cls}, box "
                                     f"{box.round(3).tolist()}), its largest IoU with a higher-scored one of its "
                                     f"class on the other side {iou:.4f}, the cut {cut}")

        free = np.ones(len(ih), bool)
        for n in range(len(ic)):
            cand = (free & (ch == cc[n]) & (np.abs(bh - bc[n]).max(-1, initial=0.0) <= box_tol * up)
                    & (np.abs(sh - sc[n]) <= tol))
            if not cand.any():
                explain("card", sc[n], cc[n], bc[n], sides[1])
                continue
            m = int(np.argmax(cand))
            free[m] = False
            out["matched"] += 1
            out["boxes"] = max(out["boxes"], float(np.abs(bh[m] - bc[n]).max()) / up)
            out["scores"] = max(out["scores"], float(abs(sh[m] - sc[n])) / max(1.0, float(np.abs(sh).max())))
            jc, jh = ic[n], ih[m]
            if "masks" in host:
                out["masks"] = max(out["masks"], float((card["masks"][i, jc] - host["masks"][i, jh]).abs().max()))
            if "keypoints" in host:
                kc, kh = card["keypoints"][i, jc].double().numpy(), host["keypoints"][i, jh].double().numpy()
                moved = np.abs(kc[:, :2] - kh[:, :2]).max(-1) > box_tol * up
                out["kp_moved"] += int(moved.sum())
                out["kp_xy"] = max(out["kp_xy"], float(np.abs(kc[~moved, :2] - kh[~moved, :2]).max(initial=0.0)) / up)
                scale = max(1.0, float(host["keypoints"][..., 2].abs().max()))
                out["kp_tie"] = max(out["kp_tie"], float(np.abs(kc[moved, 2] - kh[moved, 2]).max(initial=0.0)) / scale)
        for m in np.nonzero(free)[0]:
            explain("CPU", sh[m], ch[m], bh[m], sides[0])
    return out


def family_stages(family, model, req, measure):
    """The stages of one request through ``model``; ``measure`` makes each
    call and returns its reading: the backbone (with the request's copy to
    the card), the RPN head or RetinaNet head, the decode (top-k, NMS), the
    ROI heads' box branch, the mask or keypoint branch (pooler, head,
    decode), the sem-seg head with its upsample, and the panoptic fusion at
    the original size."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.modeling.meta_arch.panoptic_fpn import panoptic_fusion_postprocess
    from jtsm_tpu_torch.modeling.meta_arch.semantic_seg import upsampled_sem_seg
    from jtsm_tpu_torch.modeling.postprocessing import detector_postprocess_batched

    r = {}
    readings = {}
    with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
        readings["backbone"] = measure(lambda: r.update(zip(("feats", "sizes"), model._features(req))))
        if family == "retinanet":
            readings["head"] = measure(lambda: r.update(zip(("anchors", "logits", "deltas"),
                                                            model.head_outputs(r["feats"]))))
            readings["decode"] = measure(lambda: r.update(det=model.decode(r["anchors"], r["logits"], r["deltas"])))
            return readings
        rpn = model.proposal_generator
        readings["rpn_head"] = measure(lambda: r.update(zip(("anchors", "logits", "deltas"),
                                                            rpn.head_outputs(r["feats"]))))
        readings["rpn_decode"] = measure(lambda: r.update(zip(("proposals", "scores"), rpn.predict_proposals(
            r["anchors"], r["logits"], r["deltas"], r["sizes"]))))
        if family == "rpn":
            return readings
        readings["roi_box"] = measure(lambda: r.update(det=model.roi_heads.detect(
            r["feats"], r["proposals"], r["scores"], r["sizes"])))
        branch = "keypoint" if family == "keypoint_rcnn" else "mask"
        readings[branch] = measure(lambda: r.update(det=model.roi_heads.forward_with_given_boxes(r["feats"], r["det"])))
        if family != "panoptic_fpn":
            return readings
        readings["sem_seg"] = measure(lambda: r.update(sem=upsampled_sem_seg(
            model.sem_seg_head(r["feats"]), req["image"].shape[1:3])))
    orig = torch.as_tensor(req["orig_sizes"], device=r["sizes"].device)
    out = dict(detector_postprocess_batched(r["det"], r["sizes"], orig), **r["sem"])
    readings["fusion"] = measure(lambda: panoptic_fusion_postprocess(out, req["image_sizes"], req["orig_sizes"]))
    return readings


def check_family_output(family, cfg, out):
    """Shapes and finite values of a served request's outputs."""
    import torch

    h, w = FLAGSHIP_HW
    if family == "rpn":
        want = {"proposals": (1, cfg.MODEL.RPN.POST_NMS_TOPK_TEST, 4), "scores": (1, cfg.MODEL.RPN.POST_NMS_TOPK_TEST)}
    else:
        d = cfg.TEST.DETECTIONS_PER_IMAGE
        want = {"boxes": (1, d, 4), "scores": (1, d), "classes": (1, d), "valid": (1, d)}
        if family == "panoptic_fpn":
            s = 2 * cfg.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION
            k = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
            want.update(masks=(1, d, s, s), sem_seg=(1, h, w), sem_seg_logits=(1, h, w, k))
        if family == "keypoint_rcnn":
            want["keypoints"] = (1, d, cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS, 4)
    if sorted(out) != sorted(want):
        raise AssertionError(f"{family}: outputs {sorted(out)}, expected {sorted(want)}")
    for k, shape in want.items():
        if tuple(out[k].shape) != shape:
            raise AssertionError(f"{family} {k} has shape {tuple(out[k].shape)}, expected {shape}")
        v = out[k].float()
        if k == "scores" and family == "rpn":
            v = v[torch.isfinite(v)]
        if not torch.isfinite(v).all():
            raise AssertionError(f"{family} {k} holds non-finite values")


def phase_families(kernel, gen, baseline, card):
    """Phase 15: (a) the four gates on the card against the CPU; (b) the
    four families at full width serving in bf16 and f32 in turns, by stage;
    (c) K1 at the keypoint pooler's shape. Returns K1's launches in the
    phase, the keypoint pooler's share of them, and K1's rows."""
    import numpy as np
    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, random_state_dict, variables_to_state_dict
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 15")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    total, kp_pooled = 0, 0
    try:
        # (a) each gate on the card against the CPU, float32
        for family in FAMILIES:
            _, cfg = family_cfgs(family)
            name = f"chip_smoke_{family}_gate"
            register_family_gate(family, name)
            cfg.DATASETS.TEST = (name,)
            state = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
            res_card, out_card, launches, s_card = family_score_once(cfg, state, DEVICE, kernel)
            res_cpu, out_cpu, _, s_cpu = family_score_once(cfg, state, "cpu", kernel)
            if launches != FAMILY_K1[family] * GATE_SCENES:
                raise AssertionError(f"{family} gate on the card: roi_align_fwd launched {launches} times for "
                                     f"{GATE_SCENES} images, not {FAMILY_K1[family]} each")
            total += launches
            kp_pooled += launches // 2 if family == "keypoint_rcnn" else 0
            m = dict(matched=0, at_cut=0, suppressed=0, boxes=0.0, scores=0.0, masks=0.0, kp_xy=0.0, kp_moved=0,
                     kp_tie=0.0)
            nms = {"retinanet": cfg.MODEL.RETINANET.NMS_THRESH_TEST,
                   "rpn": cfg.MODEL.RPN.NMS_THRESH}.get(family, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
            sem = 0.0
            for bc, bh in zip(out_card, out_cpu):
                one = match_family_outputs(bc, bh, nms)
                for k in m:
                    m[k] = m[k] + one[k] if k in ("matched", "at_cut", "suppressed", "kp_moved") else max(m[k], one[k])
                if "sem_seg_logits" in bh:
                    scale = max(1.0, bh["sem_seg_logits"].abs().max().item())
                    sem = max(sem, (bc["sem_seg_logits"] - bh["sem_seg_logits"]).abs().max().item() / scale)
            nums = {f"{t}/{k}": (res_card[t][k], res_cpu[t][k]) for t, k in FAMILY_METRICS[family]}
            log(f"[families] {family} gate (float32, fixture weights) on the {GATE_SCENES} in-memory scenes | "
                + " ".join(f"{k} card={a:.4f} cpu={b:.4f}" for k, (a, b) in nums.items())
                + f" | matched {m['matched']} by image, class and box, {m['at_cut']} at the cut, {m['suppressed']} "
                f"on one side where the other's NMS suppressed them (IoU at least {nms} - 1e-3 with a higher-scored "
                f"one of their class); boxes "
                f"max_abs_err={m['boxes']:.3e} input px (tol 1e-3), scores {m['scores']:.3e} of scale (tol 1e-4), mask "
                f"probabilities {m['masks']:.3e} (tol 1e-4), keypoint x,y {m['kp_xy']:.3e} input px (tol 1e-3), "
                f"{m['kp_moved']} keypoints on another bin with their maxima {m['kp_tie']:.3e} of scale apart (tol "
                f"1e-4), sem-seg logits {sem:.3e} of scale (tol 1e-4) | roi_align_fwd_launches={launches} | "
                f"seconds card {s_card:.1f} cpu {s_cpu:.1f} | {card}")
            if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["kp_xy"] <= 1e-3
                    and m["kp_tie"] <= 1e-4 and sem <= 1e-4):
                raise AssertionError(f"{family} gate: the card's outputs disagree with the CPU's: {m}, sem {sem}")
            if not all(abs(a - b) <= FAMILY_TOL_METRIC for a, b in nums.values()):
                raise AssertionError(f"{family} gate: the card's numbers differ from the CPU's: {nums}")

        # (b) each family at full width, random weights, bf16 and f32 in turns
        rng = np.random.default_rng(15)
        h, w = FLAGSHIP_HW
        warm = request(rng, (h, w), (h, w), (h, w))
        reqs = [request(rng, (h, w), (h, w), (h, w)), request(rng, (h, w), (h, w), (480, 640)),
                request(rng, (h, w), (h - 50, w - 11), (h - 50, w - 11)), request(rng, (h, w), (h, w), (h, w))]
        latency, kp_boxes = {}, None
        for family in FAMILIES:
            base, _ = family_cfgs(family)
            dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
            state = random_state_dict(build_model(base, device="cpu"), seed=15)
            predictors, mem = {}, {}
            for d in dtypes:
                c = base.clone()
                c.TPU.COMPUTE_DTYPE = d
                torch.cuda.synchronize()
                before = torch.cuda.memory_allocated()
                predictors[d] = Predictor(c, state)
                torch.cuda.synchronize()
                resident = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                predictors[d](warm)
                torch.cuda.synchronize()
                mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
            lat = {d: [] for d in dtypes}
            launches = dict.fromkeys(dtypes, 0)
            for i in range(SERVE_ROUNDS):
                req = reqs[i % len(reqs)]
                for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                    kernel.launches = 0
                    t0 = time.perf_counter()
                    out = predictors[d](req)
                    torch.cuda.synchronize()
                    lat[d].append((time.perf_counter() - t0) * 1e3)
                    n = kernel.launches
                    if n != FAMILY_K1[family]:
                        raise AssertionError(f"{family} {d} request {i}: roi_align_fwd launched {n} times, "
                                             f"not {FAMILY_K1[family]}")
                    launches[d] += n
                    check_family_output(family, predictors[d].cfg, out)
                    if family == "keypoint_rcnn" and d == "float32" and kp_boxes is None:
                        kp_boxes = out["boxes"][0]
            total += sum(launches.values())
            kp_pooled += sum(launches.values()) // 2 if family == "keypoint_rcnn" else 0

            def timed(call):
                t0 = time.perf_counter()
                call()
                torch.cuda.synchronize()
                return (time.perf_counter() - t0) * 1e3

            stage_ms = {d: {} for d in dtypes}
            for i in range(STAGE_ROUNDS):
                for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                    for k, ms in family_stages(family, predictors[d].model, reqs[0], timed).items():
                        stage_ms[d].setdefault(k, []).append(ms)
            for d in dtypes:
                syncs = family_stages(family, predictors[d].model, reqs[0], count_host_syncs)
                latency[(family, d)] = sum(lat[d]) / len(lat[d])
                log(f"[families] {FAMILY_TITLES[family]} {h}x{w} {DTYPE_NAMES[d]}, random weights (seed 15), "
                    f"{SERVE_ROUNDS} requests in turns: latency_ms={[round(x, 3) for x in lat[d]]} "
                    f"mean_ms={latency[(family, d)]:.3f} median_ms={sorted(lat[d])[len(lat[d]) // 2]:.3f} "
                    f"roi_align_fwd_launches={launches[d]} ({FAMILY_K1[family]} a request) "
                    f"weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f} | stages_ms (median of "
                    f"{STAGE_ROUNDS}) " + " ".join(f"{k}={sorted(v)[len(v) // 2]:.3f}" for k, v in stage_ms[d].items())
                    + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items()) + f" | {card}")
            del predictors

        # (c) K1 at the keypoint pooler's shape: the keypoint request's 100
        # detection boxes over an 800x1344 pyramid, C=256, P=14
        rows = {}
        levels = assign_boxes_to_levels(kp_boxes, 2, 5)
        bidx = torch.zeros(kp_boxes.shape[0], dtype=torch.int32, device=DEVICE)
        pyr32 = flagship_pyramid(gen, dtype=torch.float32)
        for tag, feats in (("f32", pyr32), ("bf16", [f.to(torch.bfloat16) for f in pyr32])):
            rows[tag] = check_and_time_fwd(f"keypoint pooler {tag}", feats, [1.0 / s for s in LEVEL_STRIDES],
                                           kp_boxes.float().contiguous(), bidx, levels, 14, baseline,
                                           phase="families")
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    return total, kp_pooled, rows, latency


WSOD_IMAGE_HW = (375, 500)  # a VOC-size image: 688x917 at MIN_SIZE_TEST 688
# the WSOD heads whose detections carry each proposal's class scores (the
# others' cannot go through TTA-AVG)
CLASS_SCORE_HEADS = ("WSDDNROIHeads", "OICRROIHeads", "CascadeOICRROIHeads", "CSCROIHeads", "CSCOICRROIHeads",
                     "WSJDSROIHeads", "TridentOICRROIHeads", "MRRPOICRROIHeads", "MRRPWSDDNROIHeads")
WSOD_CASES = (  # name, builder, ROI heads
    ("wsddn_WSR_18", "wsod_WSR_18_DC5_cfg", "WSDDNROIHeads"),
    ("oicr_WSR_18", "wsod_WSR_18_DC5_cfg", "OICRROIHeads"),
    ("pcl_WSR_18", "wsod_WSR_18_DC5_cfg", "PCLROIHeads"),
    ("oicr_V_16", "wsod_V_16_DC5_cfg", "OICRROIHeads"),
)
# phase 16's depth, cut so that phase 20's full-width runs fit the script's
# time (it was 8 requests, 2 stage rounds, 5 steps, trainers of 8 and 4
# mini-batches)
WSOD_ROUNDS = 4  # requests in each dtype
WSOD_STAGE_ROUNDS = 1
WSOD_TRAIN_STEPS = 3
WSOD_NARROW_SCENES = 8
WSOD_NARROW_STEPS = 3
# 16(a)'s solver: no clip, a warmup over the steps, at rates under which
# each update moves the next step's losses by 0.3-30% and the losses still
# fall at each step (at 3x these rates WSDDN's and PCL's third step
# overshoots, and the card and the CPU part; PCL's gradients are an order of
# magnitude smaller than WSDDN's and OICR's, VGG16's two orders)
WSOD_NARROW_SOLVER = {
    case: ["SOLVER.CLIP_GRADIENTS.ENABLED", "False", "SOLVER.BASE_LR", lr, "SOLVER.WARMUP_FACTOR", "0.5",
           "SOLVER.WARMUP_ITERS", str(WSOD_NARROW_STEPS)]
    for case, lr in (("wsddn_WSR_18", "1e-6"), ("oicr_WSR_18", "1e-6"), ("pcl_WSR_18", "1e-5"), ("oicr_V_16", "1e-4"))
}
# an update's change in float32 parameters rounds apart wherever the two
# devices' gradients differ in their last bits (measured on the H100 at
# most 5.5e-4 of its norm, VGG16's); a skipped, doubled or mis-scheduled
# update is 0.25-1 of its norm away
WSOD_UPDATE_TOL = 2e-3
WSOD_TRAINER_SCENES = 8
# at least 4 mini-batches: the trainer's timer skips the first 3
WSOD_TRAINER_ITERS = {"oicr_WSR_18": 4, "oicr_V_16": 4}  # 1 update at ITER_SIZE 4; 4 at ITER_SIZE 1


def wsod_cfg(name, narrow=False):
    """The full-width configuration of a WSOD_CASES entry (its Python
    builder), or its narrow form."""
    import jtsm_tpu_torch.config as config

    _, builder, head = next(c for c in WSOD_CASES if c[0] == name)
    return getattr(config, builder.replace("_DC5_cfg", "_narrow_cfg") if narrow else builder)(head)


def pooler_launches(cfg):
    """K1's launches a request, and (K1, K2) a train step: the box pooler
    once (none for ContextLocNet, which pools by ``roi_loop_pool``), the
    cascade once more for each branch after the first, K2 under each K1
    launch where the pooled map trains (VGG16's, or the GAM-attended map,
    whose ``conv6`` trains under WSR-18's FREEZE_AT 5)."""
    head = cfg.MODEL.ROI_HEADS.NAME
    k1 = 0 if head == "ContextLocNetROIHeads" else 1
    steps = k1 + (cfg.WSL.REFINE_NUM - 1 if head == "CascadeOICRROIHeads" and cfg.WSL.CASCADE_ON else 0)
    trains = cfg.MODEL.BACKBONE.FREEZE_AT < 5 or (cfg.WSL.HAS_GAM and head != "CMILROIHeads")
    return k1, [steps, steps if trains else 0]


def timed_peak(call):
    """``call``'s milliseconds and the memory it held at its peak above
    what was allocated before it, in GiB."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return dict(ms=(time.perf_counter() - t0) * 1e3, peak=(torch.cuda.max_memory_allocated() - start) / 2**30)


def wsod_model(cfg, states):
    """``build_model(cfg)`` on the card with ``wsod_states``' seeded weights
    where its keys hold them (the multi-rate VGG16's shared plain5 kernels
    take VGG16's), the rest (GAM, the fourth and regressing branches, the
    RPN, the ASPP head) drawn by ``random_state_dict``."""
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.modeling import build_model

    model = build_model(cfg, device=DEVICE)
    base = states["V_16" if "vgg" in cfg.MODEL.BACKBONE.NAME else "WSR_18"]
    own = model.state_dict()
    missing = [k for k, v in own.items() if k not in base or tuple(base[k].shape) != tuple(v.shape)]
    state = {k: base[k] for k in own if k not in missing}
    state.update(random_state_dict(model, seed=0, keys=missing))
    model.load_state_dict(state, strict=True)
    return model


def wsod_states():
    """Seeded full-width weights (``random_state_dict``) of OICR on WSR-18
    (its keys hold WSDDN's and PCL's), and for VGG16 the same heads over a
    seeded VGG16 backbone (both pool 512 channels at P=7)."""
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.modeling.vgg import build_vgg_backbone

    wsr = random_state_dict(build_model(wsod_cfg("oicr_WSR_18"), device="cpu"), seed=0)
    vgg = {"backbone." + k: v for k, v in random_state_dict(build_vgg_backbone(wsod_cfg("oicr_V_16")), seed=0).items()}
    vgg.update({k: v for k, v in wsr.items() if k.startswith("roi_heads.")})
    return {"WSR_18": wsr, "V_16": vgg}


def wsod_request(cfg, seed):
    """One WSOD request: a seeded WSOD_IMAGE_HW image resized to the
    config's test size, padded into its bucket, and
    PRECOMPUTED_PROPOSAL_TOPK_TEST seeded proposals of log-uniform sizes
    with descending objectness."""
    import numpy as np

    from jtsm_tpu_torch.data.detection_utils import pick_bucket
    from jtsm_tpu_torch.data.transforms.augmentation import ResizeShortestEdge

    rng = np.random.default_rng(seed)
    oh, ow = WSOD_IMAGE_HW
    h, w = ResizeShortestEdge.get_output_shape(oh, ow, cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST)
    bh, bw = pick_bucket(h, w, cfg.TPU.IMAGE_BUCKETS)
    image = np.zeros((1, bh, bw, 3), np.float32)
    image[0, :h, :w] = rng.uniform(0, 255, (h, w, 3))
    r = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST
    size = np.minimum(np.exp(rng.uniform(np.log(16), np.log(600), (r, 2))), [w, h])
    xy = rng.uniform(0, 1, (r, 2)) * ([w, h] - size)
    return {
        "image": image,
        "image_sizes": np.array([[h, w]], np.int32),
        "orig_sizes": np.array([[oh, ow]], np.int32),
        "proposals": np.concatenate([xy, xy + size], 1).astype(np.float32)[None],
        "proposal_scores": np.sort(rng.uniform(0, 1, r))[::-1].astype(np.float32)[None],
    }


def wsod_train_batch(cfg, seeds):
    """``wsod_request`` for each seed, stacked, with 1 to 3 seeded image
    labels each (``wsl.data.add_wsl_train_fields``)."""
    import numpy as np

    from jtsm_tpu_torch.wsl.data import add_wsl_train_fields

    reqs = [wsod_request(cfg, seed) for seed in seeds]
    batch = {k: np.concatenate([r[k] for r in reqs]) for k in reqs[0]}
    rng = np.random.default_rng(seeds[0])
    add_wsl_train_fields(batch, [{"gt_classes": rng.choice(20, rng.integers(1, 4), replace=False)} for _ in reqs],
                         cfg.TPU.MAX_GT_INSTANCES)
    return batch


def wsod_stages(model, batch, measure, train=None):
    """The request ``batch`` through a WSOD model stage by stage (backbone,
    rpn under RPNWSL, attend under GAM, pool by K1 (after the multi-rate
    heads' branch mean) or ``loop_pool`` for ContextLocNet, dan, heads,
    nms, seg for WSJDS's masks), or with
    ``train`` (the optimizer, the schedule and the train state) its train
    step (..., heads, then ``merge`` and ``label`` for CMIL or ``losses``,
    UWSOD's with the RPN's, backward, sgd); ``measure`` makes each call and
    returns its reading."""
    import torch

    from jtsm_tpu_torch.engine.train_loop import sgd_update
    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.wsl.modeling.wsod_zoo import CMILROIHeads, ContextLocNetROIHeads

    heads = model.roi_heads
    gen = train[2].generator if train else None
    rpn = getattr(model, "proposal_generator", None)
    r = {}

    def backbone():
        r["feats"], r["sizes"] = model._features(batch)
        if rpn is None:
            r["props"], r["scores"] = model.request_fields(batch)
        r["targets"] = {k: torch.as_tensor(batch[k], device=model.device) for k in ("gt_classes", "gt_valid", "cpg")
                        if k in batch}

    stages = {"backbone": backbone}
    if rpn is not None:
        stages["rpn"] = lambda: r.update(zip(("props", "scores", "deferred"),
                                             model.proposals(batch, r["feats"], r["sizes"], gen)))
    def prepared():  # the multi-rate heads' branch mean (UWSOD, Trident); the maps themselves elsewhere
        return heads.prepare_features(r["feats"], r["props"].shape[0])

    if heads.gam is not None:
        stages["attend"] = lambda: r.update(zip(("feats", "gam"), heads.attend(prepared())))

    def pool():
        r["feats"] = prepared()
        r["pooled"] = heads.pool_proposals(r["feats"], r["props"], r["scores"])

    stages["loop_pool" if isinstance(heads, ContextLocNetROIHeads) else "pool"] = pool
    stages["dan"] = lambda: r.update(x=heads.dan(r["pooled"], gen))
    stages["heads"] = lambda: r.update(zip(("mil", "branches"), heads.predict(r["x"], r["scores"])))
    if train is None:
        stages["nms"] = lambda: r.update(det=heads.detect(r["props"], r["scores"], r["mil"], r["branches"],
                                                          r["sizes"]))
        if getattr(heads, "sem_seg_head", None) is not None:
            stages["seg"] = lambda: heads.segment(r["feats"], r["det"])
    else:
        optimizer, schedule, state = train

        def gam(losses):
            if heads.gam is not None:
                losses.update(heads.gam_loss(r["gam"], r["targets"]))
            return losses

        def rpn_losses():
            losses, (boxes, valid) = heads.losses_and_pgt(r["props"], r["scores"], r["mil"], r["branches"],
                                                          r["targets"])
            losses.update(rpn.get_losses(r["deferred"], boxes.detach(), valid, gen))
            r["losses"] = losses

        if isinstance(heads, CMILROIHeads):
            stages["merge"] = lambda: r.update(zip(("cluster", "prop"), heads.merge(r["props"], r["scores"], r["mil"])))
            stages["label"] = lambda: r.update(losses=heads.label_losses(
                r["props"], r["scores"], r["cluster"], r["prop"], r["branches"], r["targets"]))
        elif rpn is not None:
            stages["losses"] = rpn_losses
        else:
            stages["losses"] = lambda: r.update(losses=gam(heads.losses(
                r["props"], r["scores"], r["mil"], r["branches"], r["targets"], r["feats"], gen)))

        def backward():
            optimizer.zero_grad(set_to_none=True)
            sum(r["losses"].values()).backward()

        def sgd():
            sgd_update(optimizer, schedule(state.step))
            state.step += 1

        stages.update(backward=backward, sgd=sgd)
    with exact_float32(model.compute_dtype == torch.float32), torch.set_grad_enabled(train is not None):
        return {k: measure(fn) for k, fn in stages.items()}


def steps_and_updates(cfg, model, batch, steps):
    """``steps`` train steps of ``model`` on ``batch``: each one's losses
    and update (the parameters' change, float64 on the CPU)."""
    import torch

    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, seed=0)
    step = make_train_step(model, optimizer, build_lr_schedule(cfg))
    params = [p for p in model.parameters() if p.requires_grad]

    def flat():
        return torch.cat([p.detach().double().flatten().cpu() for p in params])

    losses, updates = [], []
    for _ in range(steps):
        start = flat()
        losses.append({k: v.item() for k, v in step(state, batch).items()})
        updates.append(flat() - start)
    return losses, updates


def timed_ms(call):
    import torch

    t0 = time.perf_counter()
    call()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def format_voc(results):
    return " ".join(f"{k}={v:.4f}" for t in ("bbox", "bbox CorLoc") for k, v in results[t].items())


def wsod_narrow_checks(kernels):
    """Phase 16(a): each narrow configuration on the card against this
    machine's CPU from the same seeded weights: a two-request batch's
    detections matched by (source proposal, class); WSOD_NARROW_SCENES
    in-memory VOC scenes scored through the WSL test loader and the VOC
    evaluator, every number within 1e-4; WSOD_NARROW_STEPS train steps
    (dropout 0) under WSOD_NARROW_SOLVER, the losses within 1e-4 relative
    and each step's update within WSOD_UPDATE_TOL of its norm; then OICR
    on WSR-18 scored with TEST.AUG (TTA-AVG) on both, every number within
    1e-4. These launches compare the card with the CPU and count in no
    main path's total."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.train_net import build_evaluator, build_test_loader, test_with_TTA

    name = "chip_smoke_voc_narrow"
    props = register_synthetic_voc(name, num=WSOD_NARROW_SCENES, seed=0, image_hw=(96, 128), num_proposals=64)
    rng = np.random.RandomState(0)
    h, w, r = 128, 176, 64
    xy = rng.rand(2, r, 2) * [w - 30, h - 30]
    batch = {
        "image": (rng.rand(2, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "proposals": np.concatenate([xy, xy + rng.rand(2, r, 2) * 60 + 10], -1).astype(np.float32),
        "proposal_scores": rng.rand(2, r).astype(np.float32),
        "gt_classes": np.array([[3, 7, 0], [12, 0, 0]], np.int32),
        "gt_valid": np.array([[1, 1, 0], [1, 0, 0]], bool),
    }
    batch["proposal_scores"][1, -5:] = -np.inf
    before = [k.launches for k in kernels]
    failed = []
    torch.backends.cudnn.deterministic = True

    def narrow(case):
        cfg = wsod_cfg(case, narrow=True)
        cfg.DATASETS.TEST = (name,)
        cfg.DATASETS.PROPOSAL_FILES_TEST = (props,)
        return cfg, random_state_dict(build_model(cfg, device="cpu"), seed=1)

    def trained(cfg, model):
        model.roi_heads.dan.dropout = 0.0  # the two devices' generators draw other bits
        return steps_and_updates(cfg, model, batch, WSOD_NARROW_STEPS)

    for case, _, _ in WSOD_CASES:
        cfg, weights = narrow(case)
        cfg.merge_from_list(WSOD_NARROW_SOLVER[case])
        runs = {}
        for device in (DEVICE, "cpu"):
            model = build_model(cfg, device=device)
            model.load_state_dict(weights)
            det = {k: v.cpu() for k, v in model.inference(batch).items()}
            scored = test(cfg, model, build_test_loader=build_test_loader, build_evaluator=build_evaluator)
            runs[device] = (det, scored, *trained(cfg, model))
            del model
        (d_card, s_card, l_card, u_card), (d_cpu, s_cpu, l_cpu, u_cpu) = runs[DEVICE], runs["cpu"]
        m = match_detections(d_card, d_cpu, score_tol=1e-4)
        num_err = max(abs(s_card[t][k] - s_cpu[t][k]) for t in s_cpu for k in s_cpu[t])
        norms = [float(u.norm()) for u in u_cpu]
        upd_errs = [float((a - b).norm()) / n for a, b, n in zip(u_card, u_cpu, norms)]
        step_errs = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b) for a, b in zip(l_card, l_cpu)]
        log(f"[wsod] (a) {case} narrow (float32, DAN {list(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM)}, {r} proposals): card "
            f"vs CPU: detections {m['matched']} matched by (source proposal, class), {m['reordered']} in another "
            f"slot, {m['at_cut']} at the cut, boxes max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores "
            f"{m['scores']:.3e} (tol 1e-4), proposal class scores {m['class_scores']:.3e}; "
            f"{WSOD_NARROW_SCENES} VOC scenes: CPU {format_voc(s_cpu)}, card numbers max_abs_err={num_err:.3e} "
            f"(tol 1e-4); {WSOD_NARROW_STEPS} train steps at BASE_LR {cfg.SOLVER.BASE_LR:g}: losses' rel_err by "
            f"step {[f'{e:.3e}' for e in step_errs]} (tol 1e-4), updates' L2 norms {[f'{n:.4g}' for n in norms]} "
            f"rel_err {[f'{e:.3e}' for e in upd_errs]} (tol {WSOD_UPDATE_TOL:g}), total_loss card "
            f"{[round(x['total_loss'], 6) for x in l_card]} CPU {[round(x['total_loss'], 6) for x in l_cpu]}")
        if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["class_scores"] <= 1e-4 and num_err <= 1e-4
                and max(step_errs) <= 1e-4 and min(norms) > 0 and max(upd_errs) <= WSOD_UPDATE_TOL
                and all(math.isfinite(v) for x in l_card for v in x.values())):
            failed.append(case)

    cfg, weights = narrow("oicr_WSR_18")
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.EVAL_TRAIN = False  # the yamls' train set is not on this machine
    scored = {}
    for device in (DEVICE, "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(weights)
        scored[device] = test_with_TTA(cfg, model)
        del model
    num_err = max(abs(scored[DEVICE][t][k] - scored["cpu"][t][k]) for t in scored["cpu"] for k in scored["cpu"][t])
    log(f"[wsod] (a) oicr_WSR_18 narrow with TEST.AUG (TTA-AVG, short sides {tuple(cfg.TEST.AUG.MIN_SIZES)}, flip "
        f"{cfg.TEST.AUG.FLIP}): {WSOD_NARROW_SCENES} VOC scenes: CPU {format_voc(scored['cpu'])}, card numbers "
        f"max_abs_err={num_err:.3e} (tol 1e-4)")
    if not num_err <= 1e-4:
        failed.append("oicr_WSR_18 with TEST.AUG")
    if failed:
        raise AssertionError(f"wsod narrow checks: the card disagrees with the CPU in {failed}")
    torch.backends.cudnn.deterministic = False
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[wsod] (a) launches on the card in these checks (no main path's): {got}")
    if not got[kernels[0].name]:
        raise AssertionError("wsod narrow checks: K1 never launched on the card")


def wsod_serve(kernel, states, names, cfg_of, phase, rounds, stage_rounds):
    """Phases 16(b) and 20(b): each full-width configuration of ``names``
    (``cfg_of(name)``) serves ``rounds`` requests (``wsod_request``) in
    each of bf16 (as configured) and f32, in turns, K1 as ``pooler_launches``
    says, then ``stage_rounds`` stage splits with the host syncs and each
    stage's peak memory, logged under ``phase``. Returns K1's launches by
    configuration and the mean latencies."""
    import torch

    launches, latency = {}, {}
    for name in names:
        base = cfg_of(name)
        base.TEST.AUG.ENABLED = False  # one view a request (these heads return no class scores to average)
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        k1, _ = pooler_launches(base)
        reqs = [wsod_request(base, seed) for seed in (1, 2)]
        models, mem = {}, {}
        for d in dtypes:
            cfg = base.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            models[d] = wsod_model(cfg, states)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            models[d].inference(reqs[0])  # warm-up
            torch.cuda.synchronize()
            mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
        lat = {d: [] for d in dtypes}
        kernel.launches = 0
        for i in range(rounds):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                before = kernel.launches
                t0 = time.perf_counter()
                out = models[d].inference(reqs[i % 2])
                torch.cuda.synchronize()
                lat[d].append((time.perf_counter() - t0) * 1e3)
                if kernel.launches - before != k1:
                    raise AssertionError(f"{phase} {name} {d} request {i}: K1 launched {kernel.launches - before} "
                                         f"times, not {k1}")
                if (tuple(out["boxes"].shape) != (1, 100, 4) or not torch.isfinite(out["scores"]).all()
                        or not bool(out["valid"].any())):
                    raise AssertionError(f"{phase} {name} {d} request {i}: boxes {tuple(out['boxes'].shape)}, "
                                         f"{int(out['valid'].sum())} valid")
                if ("proposal_class_scores" in out) != (base.MODEL.ROI_HEADS.NAME in CLASS_SCORE_HEADS):
                    raise AssertionError(f"{phase} {name}: proposal_class_scores present: "
                                         f"{'proposal_class_scores' in out}")
        launches[name] = kernel.launches
        stage = {d: {} for d in dtypes}
        for i in range(stage_rounds):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                for k, v in wsod_stages(models[d], reqs[0], timed_peak).items():
                    stage[d].setdefault(k, []).append(v)
        for d in dtypes:
            syncs = wsod_stages(models[d], reqs[0], count_host_syncs)
            latency[(name, d)] = sum(lat[d]) / len(lat[d])
            req = reqs[0]
            log(f"[{phase}] (b) {name} {DTYPE_NAMES[d]}{' (TF32 off)' if d == 'float32' else ''} "
                f"{'x'.join(map(str, req['image_sizes'][0]))} in {'x'.join(map(str, req['image'].shape[1:3]))}, "
                f"R={req['proposals'].shape[1]}: latency_ms={[round(x, 3) for x in lat[d]]} mean_ms="
                f"{latency[(name, d)]:.3f} | stages_ms (median of {stage_rounds}) "
                + " ".join(f"{k}={median([x['ms'] for x in v]):.3f}" for k, v in stage[d].items())
                + " | stage peak_gib " + " ".join(f"{k}={max(x['peak'] for x in v):.3f}" for k, v in stage[d].items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
                + f" | weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")
        del models
    return launches, latency


def wsod_train(kernels, states, names, cfg_of, phase, steps):
    """Phases 16(c), 20(c) and 21(c), the steps: each full-width
    configuration of ``names`` (``cfg_of(name)``) takes ``steps`` steps on
    IMS_PER_BATCH seeded requests (``wsod_train_batch``; without proposals
    under RPNWSL) in each of bf16 and f32, in turns, with K1 and K2 as
    ``pooler_launches`` says. For the CSC heads each step is the CPG pass
    (``class_peak_gradients``, K1 and K2 as ``cpg_launches`` says, timed as
    its own ``cpg`` stage) and then the train step on the batch with its
    maps, at CSC_LR_FACTOR of the yaml's rate. Then the stage split with
    its host syncs and each stage's peak memory (``loop_pool``'s is
    ContextLocNet's ``roi_loop_pool``), logged under ``phase``. Returns each
    kernel's launches by configuration, the median step times (the CPG pass
    included), and the CPG passes' launches and median times."""
    import torch

    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer
    from jtsm_tpu_torch.wsl.modeling.wsjds import class_peak_gradients, cpg_slots

    launches, med = {}, {}
    cpg = {"launches": {k.name: 0 for k in kernels}, "ms": {}}
    for name in names:
        base = cfg_of(name)
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        batch = wsod_train_batch(base, list(range(3, 3 + base.SOLVER.IMS_PER_BATCH)))
        if base.MODEL.PROPOSAL_GENERATOR.NAME == "RPNWSL":
            batch = {k: v for k, v in batch.items() if k not in ("proposals", "proposal_scores")}
        cpg_on = is_cpg_head(base)
        slots = int(cpg_slots(batch["gt_classes"], batch["gt_valid"])[1].any(axis=0).sum()) if cpg_on else 0
        c1, c2 = cpg_launches(base, slots) if cpg_on else (0, 0)
        passes = slots if c1 else 0  # a detached pooled map: no backward
        _, per_step = pooler_launches(base)
        per_step = [per_step[0] + c1, per_step[1] + c2]
        if cpg_on:
            base.SOLVER.BASE_LR *= CSC_LR_FACTOR
        runs, times, cpg_ms, peak = {}, {d: [] for d in dtypes}, {d: [] for d in dtypes}, {}
        for d in dtypes:
            cfg = base.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            model = wsod_model(cfg, states).train()
            optimizer = build_optimizer(cfg, model)
            schedule = build_lr_schedule(cfg)
            runs[d] = (model, optimizer, schedule, create_train_state(model, optimizer, seed=0),
                       make_train_step(model, optimizer, schedule))

        def with_maps(model, ms=None):
            """The batch with its CPG maps (for the CSC heads)."""
            if not cpg_on:
                return batch
            t0 = time.perf_counter()
            maps, n = class_peak_gradients(model, batch, base.MODEL.ROI_HEADS.NUM_CLASSES)
            if ms is not None:
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            if n != passes:
                raise AssertionError(f"{phase} train {name}: {n} CPG passes, not {passes}")
            return dict(batch, cpg=maps)

        for k in kernels:
            k.launches = 0
        for i in range(steps):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base_mem = torch.cuda.memory_allocated()
                before = [k.launches for k in kernels]
                t0 = time.perf_counter()
                metrics = runs[d][4](runs[d][3], with_maps(runs[d][0], cpg_ms[d]))
                torch.cuda.synchronize()
                times[d].append((time.perf_counter() - t0) * 1e3)
                peak[d] = max(peak.get(d, 0.0), (torch.cuda.max_memory_allocated() - base_mem) / 2**30)
                values = {k: v.item() for k, v in metrics.items()}
                if not all(math.isfinite(v) for v in values.values()):
                    raise AssertionError(f"{phase} train {name} {d} step {i}: losses {values}")
                got = [k.launches - n for k, n in zip(kernels, before)]
                if got != per_step:
                    raise AssertionError(f"{phase} train {name} {d} step {i}: launches {got}, not {per_step}")
                for k, c in zip(kernels, (c1, c2)):
                    cpg["launches"][k.name] += c
        launches[name] = {k.name: k.launches for k in kernels}
        for d in dtypes:
            med[(name, d)] = median(times[d][1:])
            model, optimizer, schedule, state, _ = runs[d]
            stage, syncs = {}, {}
            if cpg_on:
                cpg["ms"][(name, d)] = median(cpg_ms[d][1:])
                maps = {}
                stage["cpg"] = timed_peak(lambda: maps.update(b=with_maps(model)))
                syncs["cpg"] = count_host_syncs(lambda: with_maps(model))
                step_batch = maps["b"]
            else:
                step_batch = batch
            stage.update(wsod_stages(model, step_batch, timed_peak, (optimizer, schedule, state)))
            syncs.update(wsod_stages(model, step_batch, count_host_syncs, (optimizer, schedule, state)))
            log(f"[{phase}] (c) {name} train {DTYPE_NAMES[d]}{' (TF32 off)' if d == 'float32' else ''}, "
                f"{base.SOLVER.IMS_PER_BATCH} images {'x'.join(map(str, batch['image_sizes'][0]))} in "
                f"{'x'.join(map(str, batch['image'].shape[1:3]))}"
                + (f", R={batch['proposals'].shape[1]} each" if "proposals" in batch else
                   f", RPN top-k {base.MODEL.RPN.POST_NMS_TOPK_TRAIN}")
                + (f", the CPG pass ({passes} backwards) in each step" if cpg_on else "")
                + f": step_ms={[round(t, 3) for t in times[d]]} median_of_steps_2_to_{steps}_ms={med[(name, d)]:.3f} "
                + (f"cpg_ms={[round(t, 3) for t in cpg_ms[d]]} median {cpg['ms'][(name, d)]:.3f} " if cpg_on else "")
                + f"step_peak_gib={peak[d]:.3f} | stages_ms " + " ".join(f"{k}={v['ms']:.3f}" for k, v in stage.items())
                + " | stage peak_gib " + " ".join(f"{k}={v['peak']:.3f}" for k, v in stage.items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
                + f" | launches a step {per_step}" + (f" (CPG pass {[c1, c2]})" if cpg_on else "") + " | losses "
                + ", ".join(f"{k}={v.item():.5g}" for k, v in metrics.items()))
        del runs, model, optimizer, state
    return launches, med, cpg


def wsod_trainers(kernels, states):
    """Phase 16(c), the trainer: OICR on WSR-18 (ITER_SIZE 4) and on VGG16
    (ITER_SIZE 1) through the WSL trainer on WSOD_TRAINER_SCENES in-memory
    VOC scenes of WSOD_IMAGE_HW with their 2000 proposals, the yamls' five
    train scales and the flip, IMS_PER_BATCH 4, with TPU.IMAGE_BUCKETS that
    hold the 1200 scale: the parameters move at each ITER_SIZE-th
    mini-batch only, K1 once a mini-batch, K2 once where the map trains.
    Returns each kernel's launches and each run's s/iter, data_time and
    peak memory."""
    import tempfile

    import torch

    from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
    from jtsm_tpu_torch.wsl.train_net import Trainer

    name = "chip_smoke_voc_train"
    props = register_synthetic_voc(name, num=WSOD_TRAINER_SCENES, seed=5, image_hw=WSOD_IMAGE_HW,
                                   num_proposals=2000)
    launches, out = {k.name: 0 for k in kernels}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_wsod_") as tmp:
        for case, iters in WSOD_TRAINER_ITERS.items():
            cfg = wsod_cfg(case)
            cfg.DATASETS.TRAIN = (name,)
            cfg.DATASETS.PROPOSAL_FILES_TRAIN = (props,)
            cfg.TPU.IMAGE_BUCKETS = TC_JTSM_BUCKETS
            cfg.SOLVER.MAX_ITER = iters
            cfg.TEST.EVAL_PERIOD = 0
            cfg.MODEL.WEIGHTS = ""
            cfg.OUTPUT_DIR = os.path.join(tmp, case)
            cfg.SEED = 0
            k = cfg.WSL.ITER_SIZE
            per_iteration = {kernels[0].name: 1, kernels[1].name: 1 if cfg.MODEL.BACKBONE.FREEZE_AT < 5 else 0}
            trainer, rec, got, peak = run_trainer(
                Trainer, cfg, kernels, states[case.split("_", 1)[1]],
                watch=lambda m: [p for p in m.parameters() if p.requires_grad])
            check_launches(f"wsod trainer {case}", rec, per_iteration)
            moved = [sum(not torch.equal(a, b) for a, b in zip(rec.params[i], rec.params[i - 1]))
                     for i in range(1, iters + 1)]
            if any((i % k == 0) != (n > 0) for i, n in enumerate(moved, 1)):
                raise AssertionError(f"wsod trainer {case}: watched parameters moved {moved} (ITER_SIZE {k})")
            metrics = read_metrics(cfg.OUTPUT_DIR)
            if not all(math.isfinite(v) for m in metrics[1:] for key, v in m.items() if key.startswith("loss")):
                raise AssertionError(f"wsod trainer {case}: non-finite losses {metrics[-1]}")
            if trainer.state.step != iters // k:
                raise AssertionError(f"wsod trainer {case}: {trainer.state.step} updates in {iters} mini-batches")
            for key, n in got.items():
                launches[key] += n
            loader = trainer.data_loader
            out[case] = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                             data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak)
            log(f"[wsod] (c) {case} {cfg.TPU.COMPUTE_DTYPE} through the WSL trainer: ITER_SIZE {k}, IMS_PER_BATCH "
                f"{cfg.SOLVER.IMS_PER_BATCH}, short sides {tuple(cfg.INPUT.MIN_SIZE_TRAIN)} and the flip, "
                f"{WSOD_TRAINER_SCENES} VOC scenes {WSOD_IMAGE_HW} with 2000 proposals, {iters} mini-batches: "
                f"moved at {[i for i, n in enumerate(moved, 1) if n]}, s/iter median {out[case]['s_iter']:.4f} "
                f"data_time median {out[case]['data_time']:.4f} loader s/batch "
                f"{loader.busy_seconds / loader.batches:.4f} launches {got} peak_mem_gib {peak:.3f} | cut: "
                f"TPU.IMAGE_BUCKETS {TC_JTSM_BUCKETS} (no default bucket holds the 1200 scale), random weights")
            del trainer
    return launches, out


def phase_wsod(kernels, gen, baseline):
    """Phase 16: the WSOD baselines. (d) K1 at their box pooler's serve and
    train shapes and K2 at VGG16's train shape against the plain versions;
    (a) the narrow configurations on the card against the CPU; (b) each
    full-width configuration served; (c) its train steps and the WSL
    trainer. Returns the kernel rows, each kernel's launches on the main
    paths and the latencies and step times."""
    import torch

    from jtsm_tpu_torch.ops import roi_align

    # (d) the kernels at the heads' shapes: one level of the 1024x1024
    # bucket of a 688x917 request, WSR-18's res5 at stride 16 and VGG16's
    # plain5 at stride 8, 2000 proposals a request, P=7, sampling ratio 0
    rows = {}
    for kind, batch, stride in (("serve", 1, 16), ("serve", 1, 8), ("train", 4, 16), ("train", 4, 8)):
        r = 2000 * batch
        boxes = jtsm_mask_boxes(gen, r, (688, 917))
        bidx = torch.arange(batch, device=DEVICE, dtype=torch.int32).repeat_interleave(2000)
        levels = torch.zeros(r, dtype=torch.int32, device=DEVICE)
        net = "WSR-18 res5" if stride == 16 else "VGG16 plain5"
        for dtype in (torch.float32, torch.bfloat16):
            feat = torch.randn((batch, 1024 // stride, 1024 // stride, 512), generator=gen, device=DEVICE).to(dtype)
            tag = f"{kind} {net} {dtype_tag(feat)}"
            rows[f"fwd {tag}"] = check_and_time_fwd(tag, [feat], [1.0 / stride], boxes, bidx, levels, 7, baseline,
                                                    phase="wsod")
            if kind == "train" and stride == 8:
                rows[f"bwd {tag}"] = check_and_time_bwd(tag, [feat], [1.0 / stride], boxes, bidx, levels, 7, gen,
                                                        baseline, phase="wsod")

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 16")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        wsod_narrow_checks(kernels)
        t0 = time.perf_counter()
        states = wsod_states()
        log(f"[wsod] seeded full-width weights of WSR-18 and VGG16 in {time.perf_counter() - t0:.1f}s")
        names = [case for case, _, _ in WSOD_CASES]
        serve_launches, latency = wsod_serve(kernels[0], states, names, wsod_cfg, "wsod", WSOD_ROUNDS,
                                             WSOD_STAGE_ROUNDS)
        train_launches, steps, _ = wsod_train(kernels, states, names, wsod_cfg, "wsod", WSOD_TRAIN_STEPS)
        trainer_launches, trainers = wsod_trainers(kernels, states)
        launches = {k.name: sum(t[k.name] for t in train_launches.values()) + trainer_launches[k.name]
                    for k in kernels}
        launches[kernels[0].name] += sum(serve_launches.values())
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    return rows, launches, latency, steps, trainers


TRAIN_FAMILIES = ("retinanet", "rpn", "keypoint_rcnn", "panoptic_fpn", "semantic")
# phase 19's Mask R-CNN variants: their Python builders
SURFACE_BUILDERS = {"giou": "mask_rcnn_R_50_FPN_giou_cfg", "pred_boxes": "mask_rcnn_R_50_FPN_pred_boxes_cfg",
                    "syncbn": "mask_rcnn_R_50_FPN_syncbn_cfg"}
SURFACE_FAMILIES = tuple(SURFACE_BUILDERS)
TRAIN_TITLES = dict(FAMILY_TITLES, semantic="SemanticSegmentor R50-FPN", giou="Mask R-CNN R50-FPN giou",
                    pred_boxes="Mask R-CNN R50-FPN pred boxes", syncbn="Mask R-CNN R50-FPN SyncBN")
TRAIN_K = {"retinanet": (0, 0), "rpn": (0, 0), "keypoint_rcnn": (2, 2), "panoptic_fpn": (2, 2), "semantic": (0, 0),
           "giou": (2, 2), "pred_boxes": (2, 2), "syncbn": (2, 2)}
MASK_RCNN_LOSSES = ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc"]
TRAIN_LOSSES = {
    "retinanet": ["loss_box_reg", "loss_cls"],
    "rpn": ["loss_rpn_cls", "loss_rpn_loc"],
    "keypoint_rcnn": ["loss_box_reg", "loss_cls", "loss_keypoint", "loss_rpn_cls", "loss_rpn_loc"],
    "panoptic_fpn": ["loss_box_reg", "loss_cls", "loss_mask", "loss_rpn_cls", "loss_rpn_loc", "loss_sem_seg"],
    "semantic": ["loss_sem_seg"],
    "giou": MASK_RCNN_LOSSES,
    "pred_boxes": MASK_RCNN_LOSSES,
    "syncbn": MASK_RCNN_LOSSES,
}
FAM_TRAIN_STEPS = 6  # each dtype, in turns; the medians take steps 2-6
FAM_NARROW_STEPS = 3
FAM_NARROW_HW = (128, 176)  # the gates' larger bucket
# the narrow steps' rates, no clip: the total loss falls at each step and
# each update moves the next losses (a CPU rehearsal shows the trajectory:
# at 0.002 Keypoint R-CNN's and Panoptic FPN's rise by the third step).
# Of a two-stage model the ROI heads' own losses may rise where a step
# moves a proposal into or out of the foreground
FAM_NARROW_LR = {"retinanet": 2e-4, "rpn": 5e-4, "keypoint_rcnn": 5e-4, "panoptic_fpn": 2e-4, "semantic": 2e-3,
                 "giou": 2e-4, "pred_boxes": 2e-4, "syncbn": 2e-4}
# card against CPU, set from two card runs (H100 80GB HBM3, 700 W) with a
# margin: each step's losses relative (measured 1.0e-5 at most, Panoptic
# FPN's third step), each update of its L2 norm (measured 1.709e-3 at
# most, the RPN's third, where an anchor's delta crosses the L1 loss's
# kink on one side only; 6.1e-4 the next)
FAM_LOSS_TOL = 1e-4
FAM_UPDATE_TOL = 3e-3
FAM_TRAINER_SCENES = 8
FAM_TRAINER_ITERS = 6


def train_family_cfg(family, narrow=False):
    """The full-width config of ``family`` (the Python builders; the
    semantic one of ``configs/Misc/semantic_R_50_FPN_1x.yaml``) or its
    narrow gate config (SemanticSegmentor: Panoptic FPN's gate without its
    instance branches; phase 22's and 23's models: their builders' narrow
    forms) in
    the sampling regime in which the card and the CPU
    sample the same slots: an RPN slot for every anchor and an ROI slot for
    every proposal and ground-truth row, at positive fraction 1.0, so that
    the mask and keypoint picks take every foreground slot and no draw
    matters; FAM_NARROW_LR, no clip."""
    from jtsm_tpu_torch import config
    from jtsm_tpu_torch.config import semantic_R_50_FPN_cfg

    if family in LVIS_CITY_BUILDERS and not narrow:
        return getattr(config, LVIS_CITY_BUILDERS[family])()
    if family in C4_BUILDERS or family in CASCADE_BUILDERS:
        builder = getattr(config, C4_BUILDERS.get(family) or CASCADE_BUILDERS[family])
        if not narrow:
            return builder()
        cfg = builder(narrow=True)
    elif family in SURFACE_BUILDERS:
        full = getattr(config, SURFACE_BUILDERS[family])()
        if not narrow:
            return full
        cfg = surface_changes(config.mask_rcnn_gate_cfg(), full)
        # 124 proposals and 4 ground-truth rows: 128 ROI slots, so that the
        # mask pick (128 a image) takes every foreground slot without a draw
        cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 124
    elif family == "semantic":
        if not narrow:
            return semantic_R_50_FPN_cfg()
        cfg = family_cfgs("panoptic_fpn")[1]
        cfg.MODEL.META_ARCHITECTURE = "SemanticSegmentor"
        cfg.MODEL.MASK_ON = False
    else:
        cfg = family_cfgs(family)[0 if not narrow else 1]
    if not narrow:
        return cfg
    m = cfg.MODEL
    m.RPN.BATCH_SIZE_PER_IMAGE = 8192  # the 128x176 bucket has 5634 anchors
    m.RPN.POSITIVE_FRACTION = 1.0
    cfg.TPU.MAX_GT_INSTANCES = 4
    proposals = cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if m.LOAD_PROPOSALS else m.RPN.POST_NMS_TOPK_TRAIN
    m.ROI_HEADS.BATCH_SIZE_PER_IMAGE = proposals + 4
    m.ROI_HEADS.POSITIVE_FRACTION = 1.0
    cfg.SOLVER.BASE_LR = FAM_NARROW_LR[family]
    cfg.SOLVER.WARMUP_ITERS = 0
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = False
    return cfg


def surface_changes(cfg, full):
    """``cfg`` (a narrow Mask R-CNN) with what sets ``full``'s variant apart:
    the box losses and their weights, TRAIN_ON_PRED_BOXES, the norms and the
    box head's convolutions (32 wide, the gate's FPN width), STRIDE_IN_1X1."""
    m, f = cfg.MODEL, full.MODEL
    for node, key in (("RPN", "BBOX_REG_LOSS_TYPE"), ("RPN", "BBOX_REG_LOSS_WEIGHT"),
                      ("ROI_BOX_HEAD", "BBOX_REG_LOSS_TYPE"), ("ROI_BOX_HEAD", "BBOX_REG_LOSS_WEIGHT"),
                      ("ROI_BOX_HEAD", "TRAIN_ON_PRED_BOXES"), ("RESNETS", "NORM"), ("RESNETS", "STRIDE_IN_1X1"),
                      ("FPN", "NORM"), ("ROI_BOX_HEAD", "NORM"), ("ROI_BOX_HEAD", "NUM_CONV"),
                      ("ROI_MASK_HEAD", "NORM")):
        m[node][key] = f[node][key]
    m.ROI_BOX_HEAD.CONV_DIM = m.FPN.OUT_CHANNELS
    return cfg


def family_train_state(cfg, seed):
    """Seeded weights to train from, as a user fine-tunes from an ImageNet
    backbone: the ResNet's (the FPN's bottom-up, or a C4 model's backbone)
    from ``random_state_dict``, with each FrozenBN's
    statistics set to those of its input on a batch of two seeded 256x384
    images (one pass, in order), so that it normalises as a trained one does (without
    that, a seeded ResNet-50's res3-res5 maps have a spread near 100, and
    RetinaNet's focal loss starts near 700 and reaches NaN in bf16 by the
    third step; a deformable block's offset kernel takes CASCADE_GAINS'
    0.05, so that its offsets are a few pixels); the FPN and the heads from
    the JAX package's initialisers (RetinaNet's towers at std 0.01 and its
    focal prior)."""
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.layers.batch_norm import FrozenBatchNorm2d
    from jtsm_tpu_torch.modeling import build_model

    torch.manual_seed(seed)
    model = build_model(cfg, device="cpu")
    state = model.state_dict()
    # the ResNet: the FPN's bottom-up, or the C4 backbone itself
    bottom_up = getattr(model.backbone, "bottom_up", model.backbone)
    prefix = "backbone.bottom_up." if bottom_up is not model.backbone else "backbone."
    state.update({k: v for k, v in gained(random_state_dict(model, seed)).items() if k.startswith(prefix)})
    model.load_state_dict(state)

    def calibrate(bn, inputs):
        x = inputs[0].float()
        bn.running_mean.copy_(x.mean(dim=(0, 2, 3)))
        bn.running_var.copy_(x.var(dim=(0, 2, 3)))

    hooks = [m.register_forward_pre_hook(calibrate) for m in bottom_up.modules() if isinstance(m, FrozenBatchNorm2d)]
    g = torch.Generator().manual_seed(seed)
    images = torch.rand((2, 256, 384, 3), generator=g) * 255  # the pixels' scale: PIXEL_STD is 1
    with torch.no_grad():
        bottom_up(((images - model.pixel_mean) / model.pixel_std).permute(0, 3, 1, 2))
    for h in hooks:
        h.remove()
    return model.state_dict()


def family_train_batch(cfg, seed, b, hw, g, valid):
    """``synthetic_train_batch`` with what each family trains on: classes
    within MODEL.ROI_HEADS.NUM_CLASSES, 17 keypoints on a grid in each box
    (a fifth of them invisible) under KEYPOINT_ON, a stuff map of four
    horizontal bands (255 past each image) for the sem-seg head, and under
    MODEL.LOAD_PROPOSALS PRECOMPUTED_PROPOSAL_TOPK_TRAIN seeded proposals
    (``seeded_proposals``)."""
    import numpy as np

    batch = synthetic_train_batch(seed, b, hw, g, valid)
    rng = np.random.default_rng(seed + 1)
    batch["gt_classes"] %= cfg.MODEL.ROI_HEADS.NUM_CLASSES
    batch["orig_sizes"] = batch["image_sizes"].copy()
    if cfg.MODEL.KEYPOINT_ON:
        bx = batch["gt_boxes"]
        k = np.arange(17)
        fx, fy = 0.15 + 0.7 * (k % 5) / 4.0, 0.15 + 0.7 * (k // 5) / 3.0
        kp = np.zeros((b, g, 17, 3), np.float32)
        kp[..., 0] = bx[..., 0:1] + fx * (bx[..., 2:3] - bx[..., 0:1])
        kp[..., 1] = bx[..., 1:2] + fy * (bx[..., 3:4] - bx[..., 1:2])
        kp[..., 2] = np.where(rng.uniform(size=(b, g, 17)) < 0.2, 0, 2)
        batch["gt_keypoints"] = kp
    if cfg.MODEL.META_ARCHITECTURE in ("PanopticFPN", "SemanticSegmentor"):
        h, w = hw
        band = (np.arange(h) * 4 // h).astype(np.int32)
        sem = np.broadcast_to(band[None, :, None] % cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES, (b, h, w)).copy()
        batch["gt_sem_seg"] = sem
    if cfg.MODEL.META_ARCHITECTURE != "PanopticFPN" and not cfg.MODEL.MASK_ON:
        batch.pop("gt_mask_crops")
    if cfg.MODEL.LOAD_PROPOSALS:
        batch["proposals"], batch["proposal_scores"] = seeded_proposals(
            rng, batch["image_sizes"], cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN, batch["gt_boxes"],
            batch["gt_valid"])
    return batch


def family_train_stages(family, model, optimizer, schedule, state, batch, measure):
    """One train step of ``model`` split by stage, ``measure`` making each
    call and returning its reading: the backbone (with the batch's copy to
    the card), RetinaNet's head and losses, or the sem-seg head with its
    loss, the RPN (head, draws, losses, proposals) and the ROI heads (box
    branch, the mask or keypoint branch, their losses); the backward; the
    SGD update."""
    import torch

    from jtsm_tpu_torch.engine.train_loop import sgd_update
    from jtsm_tpu_torch.layers import batch_statistics, exact_float32

    r = {"losses": {}}

    def backbone():
        r["feats"], r["sizes"] = model._features(batch)
        r["t"] = model.targets(batch)

    def rpn():
        if model.proposal_generator is None:  # Fast R-CNN: the batch's proposals
            r["props"], r["scores"] = model.batch_proposals(batch)
            return
        proposals, scores, losses = model.proposal_generator(r["sizes"], r["feats"], r["t"]["gt_boxes"],
                                                             r["t"]["gt_valid"], state.generator)
        r.update(props=proposals, scores=scores)
        r["losses"].update(losses)

    def roi_heads():
        losses = model.roi_heads(r["feats"], r["props"], r["scores"], r["sizes"], r["t"], state.generator)
        w = getattr(model, "instance_loss_weight", 1.0)
        r["losses"].update({k: v * w for k, v in losses.items()})

    def backward():
        optimizer.zero_grad(set_to_none=True)
        sum(r["losses"].values()).backward()

    def sgd():
        sgd_update(optimizer, schedule(state.step))
        state.step += 1

    stages = {"backbone": backbone}
    if family == "retinanet":
        stages["head"] = lambda: r.update(zip(("anchors", "logits", "deltas"), model.head_outputs(r["feats"])))
        stages["losses"] = lambda: r["losses"].update(model.losses(r["anchors"], r["logits"], r["deltas"], batch))
    else:
        if family in ("panoptic_fpn", "semantic"):
            stages["sem_seg"] = lambda: r["losses"].update(model.sem_seg_head.losses(
                model.sem_seg_head(r["feats"]), r["t"]["gt_sem_seg"]))
        if family != "semantic":
            stages["rpn"] = rpn
        if family in ("keypoint_rcnn", "panoptic_fpn") + SURFACE_FAMILIES + tuple(C4_BUILDERS) + tuple(
                CASCADE_BUILDERS) + tuple(LVIS_CITY_BUILDERS):
            stages["roi_heads"] = roi_heads
    stages.update(backward=backward, sgd=sgd)
    with exact_float32(model.compute_dtype == torch.float32), batch_statistics():
        return {k: measure(fn) for k, fn in stages.items()}


def families_narrow_checks(families, kernels):
    """17(a) and 18(a): each family's narrow gate config (the committed gate
    weights; SemanticSegmentor Panoptic FPN's backbone and sem-seg head)
    takes FAM_NARROW_STEPS steps on the card and on this machine's CPU from
    the same weights on one seeded batch of 2 images of FAM_NARROW_HW:
    each step's losses within FAM_LOSS_TOL relative, each update (the
    parameters' change, float64 on the CPU) within FAM_UPDATE_TOL of its
    norm; the total loss falls at each step. These launches compare the
    card with the CPU and count in no main path's total."""
    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, variables_to_state_dict
    from jtsm_tpu_torch.modeling import build_model

    before = [k.launches for k in kernels]
    failed = []
    for family in families:
        cfg = train_family_cfg(family, narrow=True)
        weights = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
        batch = family_train_batch(cfg, 11, 2, FAM_NARROW_HW, cfg.TPU.MAX_GT_INSTANCES, 3)
        runs = {}
        for device in (DEVICE, "cpu"):
            model = build_model(cfg, device=device)
            keys = model.state_dict().keys()
            model.load_state_dict({k: v for k, v in weights.items() if k in keys})
            runs[device] = steps_and_updates(cfg, model, batch, FAM_NARROW_STEPS)
            del model
        (l_card, u_card), (l_cpu, u_cpu) = runs[DEVICE], runs["cpu"]
        norms = [float(u.norm()) for u in u_cpu]
        upd_errs = [float((a - b).norm()) / n for a, b, n in zip(u_card, u_cpu, norms)]
        step_errs = [max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-12) for k in b) for a, b in zip(l_card, l_cpu)]
        falls = all(l_cpu[i + 1]["total_loss"] < l_cpu[i]["total_loss"] for i in range(FAM_NARROW_STEPS - 1))
        rose = sorted({k for i in range(FAM_NARROW_STEPS - 1) for k in TRAIN_LOSSES[family]
                       if l_cpu[i + 1][k] >= l_cpu[i][k]})
        log(f"[{'dense_train' if family in ('retinanet', 'rpn') else 'families_train'}] (a) {family} narrow gate "
            f"(float32, gate weights, {FAM_NARROW_HW[0]}x{FAM_NARROW_HW[1]}, 2 images): {FAM_NARROW_STEPS} steps at "
            f"BASE_LR {cfg.SOLVER.BASE_LR:g}, no clip: losses' rel_err by step {[f'{e:.3e}' for e in step_errs]} "
            f"(tol {FAM_LOSS_TOL:g}), updates' L2 norms {[f'{n:.4g}' for n in norms]} rel_err "
            f"{[f'{e:.3e}' for e in upd_errs]} (tol {FAM_UPDATE_TOL:g}), the total loss falls at each step: {falls} "
            f"(losses that rose at a step: {rose or 'none'}); CPU "
            + " | ".join(", ".join(f"{k}={x[k]:.6g}" for k in TRAIN_LOSSES[family]) for x in l_cpu))
        if not (sorted(l_cpu[0]) == sorted(TRAIN_LOSSES[family] + ["total_loss"]) and max(step_errs) <= FAM_LOSS_TOL
                and min(norms) > 0 and max(upd_errs) <= FAM_UPDATE_TOL and falls
                and all(math.isfinite(v) for x in l_card for v in x.values())):
            failed.append(family)
    if failed:
        raise AssertionError(f"narrow train checks: the card disagrees with the CPU, or the loss rose, in {failed}")
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[train checks] launches on the card in these checks (no main path's): {got}")
    return got


def families_full_train(families, kernels, phase, part="b", after=None, hw=FLAGSHIP_HW):
    """17(b) and 18(b): each family at full width and depth
    (``family_train_state``) takes FAM_TRAIN_STEPS steps on a seeded batch of
    TRAIN_BATCH images of FLAGSHIP_HW in each of bf16 (as configured) and
    f32, in turns: every loss finite, K1 and K2 launched TRAIN_K[family]
    times a step; the median of steps 2-6, the stage split with its host
    syncs, the step's peak memory; then ``after(family, dtype, run, batch)``
    when given (``run``: the model, optimizer, schedule, train state and
    step). Returns each family's kernel launches as the counters read after
    its steps, the medians and the weights (by family) for the trainer."""
    import torch

    from jtsm_tpu_torch.engine import create_train_state, make_train_step
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.solver import build_lr_schedule, build_optimizer

    launches, med, states = {}, {}, {}
    for family in families:
        base = train_family_cfg(family)
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        batch = family_train_batch(base, 17, TRAIN_BATCH, hw, base.TPU.MAX_GT_INSTANCES, 8)
        t0 = time.perf_counter()
        states[family] = family_train_state(base, seed=17)
        log(f"[{phase}] {family}: seeded full-width weights in {time.perf_counter() - t0:.1f}s")
        runs, times, peak = {}, {d: [] for d in dtypes}, {}
        for d in dtypes:
            cfg = base.clone()
            cfg.TPU.COMPUTE_DTYPE = d
            model = build_model(cfg)
            model.load_state_dict(states[family])
            optimizer = build_optimizer(cfg, model)
            schedule = build_lr_schedule(cfg)
            runs[d] = (model, optimizer, schedule, create_train_state(model, optimizer, seed=0),
                       make_train_step(model, optimizer, schedule))
        for k in kernels:
            k.launches = 0
        want = list(TRAIN_K[family])
        for i in range(FAM_TRAIN_STEPS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base_mem = torch.cuda.memory_allocated()
                before = [k.launches for k in kernels]
                t0 = time.perf_counter()
                metrics = runs[d][4](runs[d][3], batch)
                torch.cuda.synchronize()
                times[d].append((time.perf_counter() - t0) * 1e3)
                peak[d] = max(peak.get(d, 0.0), (torch.cuda.max_memory_allocated() - base_mem) / 2**30)
                values = {k: v.item() for k, v in metrics.items()}
                if sorted(values) != sorted(TRAIN_LOSSES[family] + ["total_loss"]):
                    raise AssertionError(f"{family} {d} step {i}: loss keys {sorted(values)}")
                if not all(math.isfinite(v) for v in values.values()):
                    raise AssertionError(f"{family} {d} step {i}: losses {values}")
                per_step = [k.launches - n for k, n in zip(kernels, before)]
                if per_step != want:
                    raise AssertionError(f"{family} {d} step {i}: launches {per_step}, not {want}")
        launches[family] = {k.name: k.launches for k in kernels}
        for d in dtypes:
            med[(family, d)] = median(times[d][1:])
            model, optimizer, schedule, state, _ = runs[d]
            stage_ms = family_train_stages(family, model, optimizer, schedule, state, batch, timed_ms)
            syncs = family_train_stages(family, model, optimizer, schedule, state, batch, count_host_syncs)
            log(f"[{phase}] ({part}) {TRAIN_TITLES[family]} train {DTYPE_NAMES[d]}"
                f"{' (TF32 off)' if d == 'float32' else ''}, {TRAIN_BATCH} images {hw[0]}x{hw[1]}, "
                f"seeded weights (seed 17): step_ms={[round(t, 3) for t in times[d]]} "
                f"median_of_steps_2_to_{FAM_TRAIN_STEPS}_ms={med[(family, d)]:.3f} step_peak_gib={peak[d]:.3f} "
                f"launches a step K1={want[0]} K2={want[1]} | stages_ms "
                + " ".join(f"{k}={v:.3f}" for k, v in stage_ms.items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
                + f" | losses {', '.join(f'{k}={v.item():.5g}' for k, v in metrics.items())}")
            if after is not None:
                after(family, d, runs[d], batch)
        del runs, model, optimizer, state
    return launches, med, states


def phase_dense_train(kernels):
    """Phase 17: RetinaNet and the RPN alone train. (a) their narrow gate
    configs on the card against the CPU; (b) each at full width in bf16
    and f32 by stage. Returns the kernels' launches on (b) (none: no ROIs
    are pooled) and the median step times."""
    families_narrow_checks(("retinanet", "rpn"), kernels)
    by_family, med, _ = families_full_train(("retinanet", "rpn"), kernels, "dense_train")
    launches = {k.name: sum(f[k.name] for f in by_family.values()) for k in kernels}
    if any(launches.values()):
        raise AssertionError(f"dense_train: a kernel launched on the dense detectors' steps: {by_family}")
    return launches, med


def phase_families_train(kernels, gen, baseline):
    """Phase 18: Keypoint R-CNN, Panoptic FPN and SemanticSegmentor train.
    (c) K1 and K2 at the keypoint pooler's train shape against their plain
    versions; (a) the narrow configs on the card against the CPU; (b) each
    at full width in bf16 and f32 by stage, K1 and K2 counted a step;
    (d) Keypoint R-CNN through ``DefaultTrainer`` on the in-memory person
    set. Returns the kernel rows, each kernel's launches on (b) and (d),
    those of Keypoint R-CNN's steps and trainer and those of Panoptic FPN's
    steps as the counters read them, the median step times and the
    trainer's run."""
    import tempfile

    import torch

    import jtsm_tpu_torch.ops.roi_align as roi_align
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco_person
    from jtsm_tpu_torch.engine import DefaultTrainer
    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    # (c) the keypoint pick: up to 128 foreground slots an image, B=2, P=14,
    # C=256 over an 800x1344 pyramid
    rows = {}
    scales = [1.0 / s for s in LEVEL_STRIDES]
    pyr32 = flagship_pyramid(gen, dtype=torch.float32, batch=TRAIN_BATCH)
    boxes = spread_boxes(gen, 128 * TRAIN_BATCH)
    levels = assign_boxes_to_levels(boxes, 2, 5)
    bidx = torch.arange(TRAIN_BATCH, dtype=torch.int32, device=DEVICE).repeat_interleave(128)
    for dtype in (torch.float32, torch.bfloat16):
        feats = [f.to(dtype) for f in pyr32]
        tag = f"keypoint pooler train {dtype_tag(feats[0])} B={TRAIN_BATCH}"
        rows[f"fwd {dtype_tag(feats[0])}"] = check_and_time_fwd(tag, feats, scales, boxes, bidx, levels, 14,
                                                                baseline, "families_train")
        rows[f"bwd {dtype_tag(feats[0])}"] = check_and_time_bwd(tag, feats, scales, boxes, bidx, levels, 14, gen,
                                                                baseline, "families_train")
    del pyr32

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 18")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        families_narrow_checks(("keypoint_rcnn", "panoptic_fpn", "semantic"), kernels)
        by_family, med, states = families_full_train(("keypoint_rcnn", "panoptic_fpn", "semantic"), kernels,
                                                     "families_train")

        # (d) Keypoint R-CNN through the trainer on the person set
        name = "chip_smoke_person_train"
        register_synthetic_coco_person(name, num=FAM_TRAINER_SCENES, seed=3, image_hw=SCORE_HW)
        cfg = train_family_cfg("keypoint_rcnn")
        cfg.DATASETS.TRAIN = (name,)
        cfg.SOLVER.IMS_PER_BATCH = TRAIN_BATCH
        cfg.SOLVER.MAX_ITER = FAM_TRAINER_ITERS
        cfg.SOLVER.CHECKPOINT_PERIOD = 10 * FAM_TRAINER_ITERS
        cfg.TEST.EVAL_PERIOD = 0
        cfg.MODEL.WEIGHTS = ""
        cfg.SEED = 0
        with tempfile.TemporaryDirectory(prefix="chip_smoke_kp_") as tmp:
            cfg.OUTPUT_DIR = tmp
            trainer, rec, got, peak = run_trainer(DefaultTrainer, cfg, kernels, states["keypoint_rcnn"])
            check_launches("keypoint trainer", rec, dict(zip([k.name for k in kernels], TRAIN_K["keypoint_rcnn"])))
            metrics = read_metrics(tmp)
            if [m["iteration"] for m in metrics] != list(range(FAM_TRAINER_ITERS)) or not all(
                    math.isfinite(m[k]) for m in metrics[1:] for k in m if k.startswith("loss")):
                raise AssertionError(f"keypoint trainer: metrics.json {metrics[-1]}")
            loader = trainer.data_loader
            run = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                       data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak,
                       loader=loader.busy_seconds / loader.batches)
            log(f"[families_train] (d) Keypoint R-CNN R50-FPN {cfg.TPU.COMPUTE_DTYPE} through DefaultTrainer: "
                f"{FAM_TRAINER_SCENES} in-memory person scenes {SCORE_HW[0]}x{SCORE_HW[1]}, short sides "
                f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)} (max {cfg.INPUT.MAX_SIZE_TRAIN}) and the flip, IMS_PER_BATCH "
                f"{TRAIN_BATCH}, {FAM_TRAINER_ITERS} iterations: s/iter median {run['s_iter']:.4f} data_time median "
                f"{run['data_time']:.4f} loader s/batch {run['loader']:.4f} launches {got} peak_mem_gib {peak:.3f} "
                f"| losses at the last iteration "
                + ", ".join(f"{k}={v:.5g}" for k, v in metrics[-1].items() if k.startswith("loss")))
            del trainer
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    kp_train = {k.name: by_family["keypoint_rcnn"][k.name] + got[k.name] for k in kernels}
    launches = {k.name: sum(f[k.name] for f in by_family.values()) + got[k.name] for k in kernels}
    return rows, launches, kp_train, by_family["panoptic_fpn"], med, run


SURFACE_STATS_TOL = 1e-4  # the SyncBN narrow run's running statistics, card against CPU, after 3 steps
# 19(a): the card may sit this many times further from the CPU's float32
# run than that run sits from the CPU's float64 run (two float32 runs that
# round apart, each about as far from the exact value)
SURFACE_NOISE = 3.0
# 19(a)'s steps: the SyncBN narrow model (the gate's convolutions under
# batch statistics) proposes from near-tied objectness, and after its first
# update float32 and float64 on the CPU alone part by 0.21 of the second
# update's norm and 0.60 of the third's (one proposal more or less), so
# the card is held to its first step
SURFACE_STEPS = {"giou": FAM_NARROW_STEPS, "pred_boxes": FAM_NARROW_STEPS, "syncbn": 1}
SURFACE_VOC_SCENES = 8
WSDDN_TRAINER_ITERS = 4
# TPU.IMAGE_BUCKETS of 19(c): a 375x500 VOC image cropped to 0.9-1 of each
# side and resized to the short side 1216 is up to 1216x1801, which no
# default bucket holds
WSDDN_BUCKETS = [[800, 1344], [1344, 800], [1024, 1024], [1216, 1824], [1824, 1216]]
SURFACE_TRAINER_ITERS = 6
SURFACE_PRECISE_BN = (3, 2)  # TEST.EVAL_PERIOD (PreciseBN's period) and TEST.PRECISE_BN.NUM_ITER


def ieee_cpu():
    """A context in which this machine's CPU convolutions are PyTorch's own:
    under batch statistics a weight's gradient is a small difference of
    large terms, and oneDNN's float32 convolutions lose digits there
    (``tests/test_torch_syncbn_train.py``)."""
    import contextlib

    import torch

    @contextlib.contextmanager
    def ctx():
        saved = torch.backends.mkldnn.enabled
        torch.backends.mkldnn.enabled = False
        try:
            yield
        finally:
            torch.backends.mkldnn.enabled = saved

    return ctx()


def running_stats(model):
    """Each trainable batch norm's running mean and variance, float64 on
    the CPU."""
    from jtsm_tpu_torch.layers import batch_norms

    return [(bn.running_mean.detach().double().cpu(), bn.running_var.detach().double().cpu())
            for bn in batch_norms(model)]


def stats_gap(want, got):
    """The largest gap of ``got``'s statistics from ``want``'s: a mean's over
    the activations' scale (the root of the largest E[x^2]), a variance's
    over its own largest value."""
    gap = 0.0
    for (wm, wv), (gm, gv) in zip(want, got):
        gap = max(gap, float((wm - gm).abs().max() / (wv + wm * wm).sqrt().max()),
                  float((wv - gv).abs().max() / wv.abs().max()))
    return gap


def float64_model(model):
    """``model`` (on the CPU) computing in float64 throughout: the
    parameters, the buffers and every layer's compute dtype."""
    import torch

    model.double()
    for m in model.modules():
        if hasattr(m, "compute_dtype"):
            m.compute_dtype = torch.float64
    return model


def surface_narrow_checks(kernels):
    """Phase 19(a): the narrow forms of the giou, pred-boxes and SyncBN Mask
    R-CNNs (``surface_changes`` on the gate config: the gate's weights, and
    for SyncBN the initialisers' batch norms and box-head convolutions,
    drawn once on the CPU from seed 0) take FAM_NARROW_STEPS steps on the
    card, on this machine's CPU in float32 and on the CPU in float64, from
    the same weights on one seeded batch, in the sampling regime in which
    all sample the same slots (SyncBN one step, SURFACE_STEPS). The float64 run measures how far float32
    rounding alone moves each step (on this gate 2.5e-3 to 1.4e-2 of the
    first update's norm, and more at each later step: deep gradients, and
    under batch statistics E[x^2] - E[x]^2, cancel digits): each step's
    losses within max(FAM_LOSS_TOL, SURFACE_NOISE x that step's float32
    gap), each update within max(FAM_UPDATE_TOL, SURFACE_NOISE x its
    gap), SyncBN's running statistics within max(SURFACE_STATS_TOL,
    SURFACE_NOISE x theirs); the total loss falls at each step on the CPU.
    Then WSDDN R-18 DC5 narrowed (``wsddn_R_18_narrow_cfg``, INPUT.CROP on)
    on the first batch of the WSL train loader over in-memory VOC scenes,
    as 16(a) checks its steps. The CPU runs with PyTorch's own
    convolutions (``ieee_cpu``). These launches compare the card with the
    CPU and count in no main path's total."""
    import torch

    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, random_state_dict, variables_to_state_dict
    from jtsm_tpu_torch.config import wsddn_R_18_narrow_cfg
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.train_net import Trainer

    before = [k.launches for k in kernels]
    failed = []
    torch.backends.cudnn.deterministic = True

    def runs_of(cfg, weights, batch, prepare, precisions, steps=FAM_NARROW_STEPS):
        runs = {}
        for device, f64 in precisions:
            model = build_model(cfg, device=device)
            model.load_state_dict(weights)
            prepare(float64_model(model) if f64 else model)
            if device == "cpu":
                with ieee_cpu():
                    runs[(device, f64)] = (*steps_and_updates(cfg, model, batch, steps), running_stats(model))
            else:
                runs[(device, f64)] = (*steps_and_updates(cfg, model, batch, steps), running_stats(model))
            del model
        return runs

    def gaps(a, b):
        """``a``'s losses, updates and statistics against ``b``'s."""
        (la, ua, sa), (lb, ub, sb) = a, b
        return dict(step=[max(abs(x[k] - y[k]) / max(abs(y[k]), 1e-12) for k in y) for x, y in zip(la, lb)],
                    upd=[float((x - y).norm() / y.norm()) for x, y in zip(ua, ub)],
                    stats=stats_gap(sb, sa) if sb else None)

    for family in SURFACE_FAMILIES:
        cfg = train_family_cfg(family, narrow=True)
        gate = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
        torch.manual_seed(0)  # the initialisers of what the gate lacks
        weights = build_model(cfg, device="cpu").state_dict()
        weights.update({k: v for k, v in gate.items() if k in weights and v.shape == weights[k].shape})
        batch = family_train_batch(cfg, 11, 2, FAM_NARROW_HW, cfg.TPU.MAX_GT_INSTANCES, 3)
        runs = runs_of(cfg, weights, batch, lambda m: None, ((DEVICE, False), ("cpu", False), ("cpu", True)),
                       SURFACE_STEPS[family])
        card, cpu, cpu64 = runs[(DEVICE, False)], runs[("cpu", False)], runs[("cpu", True)]
        got, noise = gaps(card, cpu), gaps(cpu, cpu64)
        l_cpu, norms = cpu[0], [float(u.norm()) for u in cpu[1]]
        tol = dict(step=[max(FAM_LOSS_TOL, SURFACE_NOISE * n) for n in noise["step"]],
                   upd=[max(FAM_UPDATE_TOL, SURFACE_NOISE * n) for n in noise["upd"]],
                   stats=None if noise["stats"] is None else max(SURFACE_STATS_TOL, SURFACE_NOISE * noise["stats"]))
        falls = all(l_cpu[i + 1]["total_loss"] < l_cpu[i]["total_loss"] for i in range(len(l_cpu) - 1))
        log(f"[train_surface] (a) {family} narrow (the gate's R50, float32, {FAM_NARROW_HW[0]}x{FAM_NARROW_HW[1]}, "
            f"2 images): {len(l_cpu)} step(s) at BASE_LR {cfg.SOLVER.BASE_LR:g}, no clip: card against CPU "
            f"losses' rel_err by step {[f'{e:.3e}' for e in got['step']]} (tol {[f'{t:.3e}' for t in tol['step']]}), "
            f"updates' L2 norms {[f'{n:.4g}' for n in norms]} rel_err {[f'{e:.3e}' for e in got['upd']]} (tol "
            f"{[f'{t:.3e}' for t in tol['upd']]}), "
            + (f"running statistics gap {got['stats']:.3e} (tol {tol['stats']:.3e}), " if got["stats"] is not None
               else "") + "float32 against float64 on the CPU: losses "
            f"{[f'{e:.3e}' for e in noise['step']]}, updates {[f'{e:.3e}' for e in noise['upd']]}"
            + (f", statistics {noise['stats']:.3e}" if noise["stats"] is not None else "")
            + f"; the total loss falls at each step: {falls}; CPU "
            + " | ".join(", ".join(f"{k}={x[k]:.6g}" for k in MASK_RCNN_LOSSES) for x in l_cpu))
        if not (sorted(l_cpu[0]) == sorted(MASK_RCNN_LOSSES + ["total_loss"]) and min(norms) > 0 and falls
                and all(e <= t for e, t in zip(got["step"], tol["step"]))
                and all(e <= t for e, t in zip(got["upd"], tol["upd"]))
                and (got["stats"] is None) == (family != "syncbn") and (got["stats"] or 0.0) <= (tol["stats"] or 0.0)
                and all(math.isfinite(v) for x in card[0] for v in x.values())):
            failed.append(family)

    name = "chip_smoke_voc_crop_narrow"
    props = register_synthetic_voc(name, num=SURFACE_VOC_SCENES, seed=2, image_hw=(150, 200), num_proposals=64)
    try:
        cfg = wsddn_R_18_narrow_cfg()
        cfg.merge_from_list(WSOD_NARROW_SOLVER["wsddn_WSR_18"])
        cfg.DATASETS.TRAIN = (name,)
        cfg.DATASETS.PROPOSAL_FILES_TRAIN = (props,)
        cfg.SOLVER.IMS_PER_BATCH = 2
        it = iter(Trainer.build_train_loader(cfg))
        batch = {k: v for k, v in next(it).items() if k != "image_ids"}
        it.close()
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)

    def no_dropout(model):
        model.roi_heads.dan.dropout = 0.0  # the two devices' generators draw other bits

    runs = runs_of(cfg, random_state_dict(build_model(cfg, device="cpu"), seed=1), batch, no_dropout,
                   ((DEVICE, False), ("cpu", False)))
    got = gaps(runs[(DEVICE, False)], runs[("cpu", False)])
    norms = [float(u.norm()) for u in runs[("cpu", False)][1]]
    log(f"[train_surface] (a) wsddn_R_18 narrow (float32, INPUT.CROP {cfg.INPUT.CROP.TYPE} {list(cfg.INPUT.CROP.SIZE)}, "
        f"a cropped batch of 2 images {'x'.join(map(str, batch['image'].shape[1:3]))}, sizes "
        f"{batch['image_sizes'].tolist()}, {batch['proposals'].shape[1]} proposal slots each): {FAM_NARROW_STEPS} "
        f"steps at BASE_LR {cfg.SOLVER.BASE_LR:g}: losses' rel_err by step {[f'{e:.3e}' for e in got['step']]} (tol "
        f"1e-4), updates' L2 norms {[f'{n:.4g}' for n in norms]} rel_err {[f'{e:.3e}' for e in got['upd']]} (tol "
        f"{WSOD_UPDATE_TOL:g}), total_loss CPU {[round(x['total_loss'], 6) for x in runs[('cpu', False)][0]]}")
    if not (max(got["step"]) <= 1e-4 and min(norms) > 0 and max(got["upd"]) <= WSOD_UPDATE_TOL
            and all(math.isfinite(v) for x in runs[(DEVICE, False)][0] for v in x.values())):
        failed.append("wsddn_R_18")
    torch.backends.cudnn.deterministic = False
    if failed:
        raise AssertionError(f"train_surface narrow checks: the card disagrees with the CPU beyond float32's own "
                             f"rounding, or the loss rose, in {failed}")
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[train_surface] (a) launches on the card in these checks (no main path's): {got}")
    return got


def pred_box_pooler_rows(states, gen, baseline):
    """K1 and K2 against their plain versions at the mask pooler of the
    pred-boxes step: the maps, the boxes that the box head's deltas decode
    to (some past the image's edges) and their levels, captured from one
    full-width forward of TRAIN_BATCH seeded images of FLAGSHIP_HW in each
    dtype. Returns the rows."""
    import torch

    from jtsm_tpu_torch.layers import batch_statistics, exact_float32
    from jtsm_tpu_torch.modeling import build_model, poolers

    base = train_family_cfg("pred_boxes")
    batch = family_train_batch(base, 17, TRAIN_BATCH, FLAGSHIP_HW, base.TPU.MAX_GT_INSTANCES, 8)
    rows = {}
    for d in (base.TPU.COMPUTE_DTYPE, "float32"):
        cfg = base.clone()
        cfg.TPU.COMPUTE_DTYPE = d
        model = build_model(cfg)
        model.load_state_dict(states["pred_boxes"])
        model.train()
        seen = []
        routed = poolers.roi_align_multilevel

        def capture(maps, scales, boxes, bidx, levels, size, *args):
            if size[0] == 14:
                seen.append(([m.detach() for m in maps], scales, boxes.detach(), bidx, levels))
            return routed(maps, scales, boxes, bidx, levels, size, *args)

        poolers.roi_align_multilevel = capture
        try:
            with torch.no_grad(), exact_float32(d == "float32"), batch_statistics():
                model(batch, generator=torch.Generator(device=DEVICE).manual_seed(0))
        finally:
            poolers.roi_align_multilevel = routed
        maps, scales, boxes, bidx, levels = seen[0]
        h, w = FLAGSHIP_HW
        outside = int(((boxes[:, 0] < 0) | (boxes[:, 1] < 0) | (boxes[:, 2] > w) | (boxes[:, 3] > h)).sum())
        tag = f"pred-boxes mask pooler {dtype_tag(maps[0])} B={TRAIN_BATCH} ({outside} of {boxes.shape[0]} boxes " \
              f"past the image)"
        rows[f"fwd {dtype_tag(maps[0])}"] = check_and_time_fwd(tag, maps, list(scales), boxes, bidx, levels, 14,
                                                               baseline, "train_surface")
        rows[f"bwd {dtype_tag(maps[0])}"] = check_and_time_bwd(tag, maps, list(scales), boxes, bidx, levels, 14,
                                                               gen, baseline, "train_surface")
        del model, seen, maps
    return rows


def wsddn_trainer(kernels, gen, baseline):
    """Phase 19(c): WSDDN R-18 DC5 at full width (``wsddn_R_18_DC5_cfg()``,
    seeded weights) through the WSL trainer on SURFACE_VOC_SCENES in-memory
    VOC scenes of WSOD_IMAGE_HW with 2000 proposals, at the yaml's 24 train
    scales (480 to 1216) with INPUT.CROP first and the flip, IMS_PER_BATCH
    4, WSDDN_TRAINER_ITERS iterations, TPU.IMAGE_BUCKETS WSDDN_BUCKETS: K1
    and K2 once an iteration (res3 to res5 train). Then K1 and K2 against
    their plain versions at its train shape: the res5 map of one of its
    batches (stride 16) and that batch's proposal slots, P=7. Returns the
    kernel rows, the launches and the run's s/iter, data_time and peak
    memory. The padded proposal slots (zero-size boxes at the origin) are
    pooled, and take a zero cotangent, as the loss leaves them."""
    import tempfile

    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.config import wsddn_R_18_DC5_cfg
    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.train_net import Trainer

    name = "chip_smoke_voc_crop"
    props = register_synthetic_voc(name, num=SURFACE_VOC_SCENES, seed=5, image_hw=WSOD_IMAGE_HW,
                                   num_proposals=2000)
    cfg = wsddn_R_18_DC5_cfg()
    cfg.DATASETS.TRAIN = (name,)
    cfg.DATASETS.PROPOSAL_FILES_TRAIN = (props,)
    cfg.TPU.IMAGE_BUCKETS = WSDDN_BUCKETS
    cfg.SOLVER.MAX_ITER = WSDDN_TRAINER_ITERS
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.WEIGHTS = ""
    cfg.SEED = 0
    t0 = time.perf_counter()
    state = random_state_dict(build_model(cfg, device="cpu"), seed=0)
    log(f"[train_surface] (c) seeded full-width WSDDN R-18 DC5 weights in {time.perf_counter() - t0:.1f}s")
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_wsddn_") as tmp:
            cfg.OUTPUT_DIR = tmp
            trainer, rec, got, peak = run_trainer(Trainer, cfg, kernels, state)
            check_launches("wsddn trainer", rec, {k.name: 1 for k in kernels})
            metrics = read_metrics(tmp)
            if [m["iteration"] for m in metrics] != list(range(WSDDN_TRAINER_ITERS)) or not all(
                    math.isfinite(v) for m in metrics[1:] for key, v in m.items() if key.startswith("loss")):
                raise AssertionError(f"wsddn trainer: metrics.json {metrics[-1]}")
            run = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                       data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak)
            it = iter(trainer.data_loader)
            batch = next(it)
            it.close()
            log(f"[train_surface] (c) WSDDN R-18 DC5 {cfg.TPU.COMPUTE_DTYPE} through the WSL trainer: INPUT.CROP "
                f"{cfg.INPUT.CROP.TYPE} {list(cfg.INPUT.CROP.SIZE)} first, short sides {cfg.INPUT.MIN_SIZE_TRAIN[0]}-"
                f"{cfg.INPUT.MIN_SIZE_TRAIN[-1]} (24 scales, max {cfg.INPUT.MAX_SIZE_TRAIN}) and the flip, "
                f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH}, {SURFACE_VOC_SCENES} VOC scenes {WSOD_IMAGE_HW} with 2000 "
                f"proposals in {cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN} slots, {WSDDN_TRAINER_ITERS} iterations: "
                f"s/iter median {run['s_iter']:.4f} data_time median {run['data_time']:.4f} launches {got} "
                f"peak_mem_gib {peak:.3f} | losses at the last iteration "
                + ", ".join(f"{k}={v:.5g}" for k, v in metrics[-1].items() if k.startswith("loss"))
                + f" | cut: TPU.IMAGE_BUCKETS {WSDDN_BUCKETS} (no default bucket holds the 1216 scale of a crop), "
                "random weights")
            del trainer
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    b, hh, ww = batch["image"].shape[:3]
    k = batch["proposals"].shape[1]
    boxes = torch.as_tensor(batch["proposals"], device=DEVICE).reshape(-1, 4).contiguous()
    live = torch.isfinite(torch.as_tensor(batch["proposal_scores"], device=DEVICE)).reshape(-1)
    bidx = torch.arange(b, device=DEVICE, dtype=torch.int32).repeat_interleave(k)
    levels = torch.zeros(b * k, dtype=torch.int32, device=DEVICE)
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        feat = torch.randn((b, hh // 16, ww // 16, 512), generator=gen, device=DEVICE).to(dtype)
        tag = (f"WSDDN R-18 res5 train {dtype_tag(feat)} ({b}, {hh // 16}, {ww // 16}, 512) of a cropped batch, "
               f"{int(live.sum())} live proposals")
        rows[f"fwd {dtype_tag(feat)}"] = check_and_time_fwd(tag, [feat], [1.0 / 16], boxes, bidx, levels, 7,
                                                            baseline, "train_surface")
        rows[f"bwd {dtype_tag(feat)}"] = check_and_time_bwd(tag, [feat], [1.0 / 16], boxes, bidx, levels, 7, gen,
                                                            baseline, "train_surface", live)
    return rows, got, run


def syncbn_trainers(kernels, state):
    """Phase 19(d): the SyncBN Mask R-CNN at full width through
    ``DefaultTrainer`` on SURFACE_VOC_SCENES in-memory COCO scenes of
    SCORE_HW (the yaml's short sides and the flip, IMS_PER_BATCH
    TRAIN_BATCH, SURFACE_TRAINER_ITERS iterations, the scoring hook left
    out): once with TEST.PRECISE_BN (every SURFACE_PRECISE_BN[0]
    iterations over SURFACE_PRECISE_BN[1] batches: K1 twice more a batch
    there, the running statistics moved), once with SOLVER.OPTIMIZER ADAM
    and WarmupPolyLR (the logged rates the schedule's). K1 and K2 twice an
    iteration. Returns the launches and each run's s/iter, data_time,
    PreciseBN's seconds and peak memory."""
    import tempfile

    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco
    from jtsm_tpu_torch.engine import DefaultTrainer, hooks
    from jtsm_tpu_torch.layers import batch_norms
    from jtsm_tpu_torch.solver import Adam, build_lr_schedule

    import torch

    class Trainer(DefaultTrainer):
        precise_bn_seconds = []

        def build_hooks(self):
            return [h for h in super().build_hooks() if not isinstance(h, hooks.EvalHook)]

        def update_precise_bn(self, num_iter=200):
            t0 = time.perf_counter()
            super().update_precise_bn(num_iter)
            torch.cuda.synchronize()
            self.precise_bn_seconds.append(time.perf_counter() - t0)

    name = "chip_smoke_coco_syncbn"
    register_synthetic_coco(name, num=SURFACE_VOC_SCENES, seed=4, image_hw=SCORE_HW)
    period, num_iter = SURFACE_PRECISE_BN
    launches, runs = {k.name: 0 for k in kernels}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_syncbn_") as tmp:
            for run_name, opts in (("precise_bn", ["TEST.PRECISE_BN.ENABLED", "True", "TEST.PRECISE_BN.NUM_ITER",
                                                   str(num_iter), "TEST.EVAL_PERIOD", str(period)]),
                                   ("adam_poly", ["SOLVER.OPTIMIZER", "ADAM", "SOLVER.LR_SCHEDULER_NAME",
                                                  "WarmupPolyLR", "SOLVER.BASE_LR", "1e-4", "TEST.EVAL_PERIOD", "0"])):
                cfg = train_family_cfg("syncbn")
                cfg.merge_from_list(opts)
                cfg.DATASETS.TRAIN = (name,)
                cfg.SOLVER.IMS_PER_BATCH = TRAIN_BATCH
                cfg.SOLVER.MAX_ITER = SURFACE_TRAINER_ITERS
                cfg.SOLVER.CHECKPOINT_PERIOD = 10 * SURFACE_TRAINER_ITERS
                cfg.MODEL.WEIGHTS = ""
                cfg.SEED = 0
                cfg.OUTPUT_DIR = os.path.join(tmp, run_name)
                Trainer.precise_bn_seconds = []
                stats = {}

                def watch(model):
                    stats["start"] = [bn.running_var.detach().clone() for bn in batch_norms(model)]
                    return ()

                trainer, rec, got, peak = run_trainer(Trainer, cfg, kernels, state, watch=watch)
                calls = len(Trainer.precise_bn_seconds)
                for i, per in enumerate(rec.launches):
                    extra = 2 * num_iter if run_name == "precise_bn" and (i + 1) % period == 0 else 0
                    if per != [2 + extra, 2]:
                        raise AssertionError(f"syncbn trainer {run_name} iteration {i}: launches {per}, not "
                                             f"[{2 + extra}, 2]")
                moved = sum(not bool((a == bn.running_var).all()) for a, bn in
                            zip(stats["start"], batch_norms(trainer.model)))
                metrics = read_metrics(cfg.OUTPUT_DIR)
                if (not all(math.isfinite(v) for m in metrics[1:] for k, v in m.items() if k.startswith("loss"))
                        or moved != len(stats["start"])):
                    raise AssertionError(f"syncbn trainer {run_name}: {moved} of {len(stats['start'])} statistics "
                                         f"moved; metrics.json {metrics[-1]}")
                if run_name == "precise_bn" and calls != SURFACE_TRAINER_ITERS // period:
                    raise AssertionError(f"syncbn trainer: PreciseBN ran {calls} times")
                if run_name == "adam_poly":
                    schedule = build_lr_schedule(cfg)
                    lr_gap = max(abs(m["lr"] - schedule(m["iteration"])) / schedule(m["iteration"]) for m in metrics)
                    if type(trainer.optimizer) is not Adam or lr_gap > 1e-6:
                        raise AssertionError(f"syncbn trainer adam_poly: {type(trainer.optimizer).__name__}, logged "
                                             f"rates off the schedule by {lr_gap:.3e}")
                for k, n in got.items():
                    launches[k] += n
                runs[run_name] = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                                      data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak,
                                      precise_bn_s=median(Trainer.precise_bn_seconds))
                log(f"[train_surface] (d) Mask R-CNN R50-FPN SyncBN {cfg.TPU.COMPUTE_DTYPE} through DefaultTrainer, "
                    f"{run_name}: SOLVER.OPTIMIZER {cfg.SOLVER.OPTIMIZER} {cfg.SOLVER.LR_SCHEDULER_NAME}, "
                    + (f"TEST.PRECISE_BN every {period} iterations over {num_iter} batches ({calls} runs, median "
                       f"{runs[run_name]['precise_bn_s']:.4f} s), " if calls else "")
                    + f"{SURFACE_VOC_SCENES} in-memory COCO scenes {SCORE_HW[0]}x{SCORE_HW[1]}, short sides "
                    f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)} (max {cfg.INPUT.MAX_SIZE_TRAIN}) and the flip, IMS_PER_BATCH "
                    f"{TRAIN_BATCH}, {SURFACE_TRAINER_ITERS} iterations: s/iter median {runs[run_name]['s_iter']:.4f} "
                    f"data_time median {runs[run_name]['data_time']:.4f} launches {got} peak_mem_gib {peak:.3f}, "
                    f"{moved} batch norms' statistics moved | losses at the last iteration "
                    + ", ".join(f"{k}={v:.5g}" for k, v in metrics[-1].items() if k.startswith("loss")))
                del trainer
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    return launches, runs


def phase_train_surface(kernels, gen, baseline):
    """Phase 19: the training surface of this slice. (a) the narrow giou,
    pred-boxes and SyncBN Mask R-CNNs and the cropped WSDDN R-18 on the card
    against the CPU; (b) the three at full width in bf16 and f32 by stage,
    K1 and K2 twice a step, and K1 and K2 against their plain versions at
    the pred-boxes mask pooler's inputs; (c) WSDDN R-18 DC5 through the WSL
    trainer with the crop, and K1 and K2 at its train shape; (d) the SyncBN
    Mask R-CNN through ``DefaultTrainer`` with PreciseBN, and with ADAM and
    WarmupPolyLR. The plain ROIAlign raises on the card. Returns the kernel
    rows (by site), each kernel's launches on (b)-(d), the median step times
    and the trainers' runs."""
    from jtsm_tpu_torch.ops import roi_align

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 19")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        surface_narrow_checks(kernels)
        by_family, med, states = families_full_train(SURFACE_FAMILIES, kernels, "train_surface")
        rows = {"pred": pred_box_pooler_rows(states, gen, baseline)}
        rows["wsddn"], wsddn_launches, wsddn_run = wsddn_trainer(kernels, gen, baseline)
        trainer_launches, runs = syncbn_trainers(kernels, states["syncbn"])
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    runs["wsddn"] = wsddn_run
    launches = {k.name: sum(f[k.name] for f in by_family.values()) + wsddn_launches[k.name]
                + trainer_launches[k.name] for k in kernels}
    return rows, launches, by_family["pred_boxes"], wsddn_launches, med, runs


ZOO_CASES = ("oicr_CA_WSR_18", "oicr_SP_WSR_18", "pcl_gam_WSR_18", "contextlocnet_WSR_18", "contextlocnet_V_16",
             "cmil_WSR_18", "cmil_V_16")  # entries of config.WSOD_ZOO
ZOO_NARROW = ("pcl_gam_WSR_18", "oicr_SP_WSR_18", "oicr_CA_WSR_18", "contextlocnet_WSR_18", "cmil_WSR_18")
# phase 20's serving depth, cut so that phase 21 fits the script's time
# (it was 8 requests and 2 stage rounds)
ZOO_ROUNDS = 4  # requests in each dtype
ZOO_STAGE_ROUNDS = 1
ZOO_TRAIN_STEPS = 6  # each dtype, in turns; the medians take steps 2-6
ZOO_TRAINER_SCENES = 8
ZOO_TRAINER_ITERS = 8  # 2 updates of CMIL WSR-18's ITER_SIZE 4
# 20(a): one step from the narrow models' seeded weights, no clip
ZOO_NARROW_SOLVER = ["SOLVER.CLIP_GRADIENTS.ENABLED", "False", "SOLVER.BASE_LR", "1e-6", "SOLVER.WARMUP_ITERS", "0"]


def zoo_cfg(name, narrow=False):
    import jtsm_tpu_torch.config as config

    return config.WSOD_ZOO[name][1](narrow=narrow)


def zoo_narrow_batch():
    """16(a)'s two-request batch, with proposals 10-13 of each image copies
    of proposal 3 (CMIL's merges at lambda 1.0)."""
    import numpy as np

    rng = np.random.RandomState(0)
    h, w, r = 128, 176, 64
    xy = rng.rand(2, r, 2) * [w - 30, h - 30]
    batch = {
        "image": (rng.rand(2, h, w, 3) * 255).astype(np.float32),
        "image_sizes": np.array([[h, w], [h - 16, w - 32]], np.int32),
        "orig_sizes": np.array([[2 * h, 2 * w], [h - 16, w - 32]], np.int32),
        "proposals": np.concatenate([xy, xy + rng.rand(2, r, 2) * 60 + 10], -1).astype(np.float32),
        "proposal_scores": rng.rand(2, r).astype(np.float32),
        "gt_classes": np.array([[3, 7, 0], [12, 0, 0]], np.int32),
        "gt_valid": np.array([[1, 1, 0], [1, 0, 0]], bool),
    }
    batch["proposal_scores"][1, -5:] = -np.inf
    batch["proposals"][:, 10:14] = batch["proposals"][:, 3:4]
    return batch


def zoo_ops_checks():
    """``roi_loop_pool``, ``roi_label`` and ``roi_merge`` on the card
    against this machine's CPU on the same seeded inputs: the pooled values
    equal and the map's gradient within 1e-5 of its scale (the sums of a
    pixel's bins in another order), every field of ``roi_label`` equal,
    the merge's ids equal and its rows within 1e-6."""
    import torch

    from jtsm_tpu_torch.structures.boxes import pairwise_iou
    from jtsm_tpu_torch.wsl.ops import roi_label, roi_loop_pool
    from jtsm_tpu_torch.wsl.modeling.wsod_zoo import roi_merge, roi_merge_ids

    g = torch.Generator().manual_seed(0)
    feat = torch.relu(torch.randn((2, 40, 56, 64), generator=g))
    size = torch.exp(torch.empty(600, 2).uniform_(math.log(8), math.log(500), generator=g))
    xy = torch.rand(600, 2, generator=g) * torch.tensor([56 * 16.0, 40 * 16.0]) - size / 4
    boxes = torch.cat([xy, xy + size], 1)
    bidx = torch.randint(0, 2, (600,), generator=g, dtype=torch.int32)
    cot = torch.randn((1800, 7, 7, 64), generator=g)
    out = {}
    for device in (DEVICE, "cpu"):
        f = feat.to(device).requires_grad_()
        pooled = roi_loop_pool(f, boxes.to(device), bidx.to(device), 1.0 / 16)
        (pooled * cot.to(device)).sum().backward()
        out[device] = (pooled.detach().cpu(), f.grad.cpu())
    pool_err = (out[DEVICE][0] - out["cpu"][0]).abs().max().item()
    grad_err = ((out[DEVICE][1] - out["cpu"][1]).abs().max() / out["cpu"][1].abs().max()).item()

    r, c = 300, 20
    pb = boxes[:r].reshape(1, r, 4).repeat(2, 1, 1)
    pb[:, 100:104] = pb[:, 7:8]
    scores = torch.rand((2, r, c), generator=g)
    scores[1, -20:] = float("-inf")
    labels = (torch.rand((2, c), generator=g) < 0.2).float()
    labels[:, 3] = 1.0
    cw = torch.rand((2, c), generator=g)
    obj = torch.rand((2, r), generator=g)
    obj[:, 100:104] = obj[:, 7:8]
    logits = torch.randn((2, r, c), generator=g)
    lab, merged = {}, {}
    for device in (DEVICE, "cpu"):
        b = pb.to(device)
        lab[device] = {k: v.cpu() for k, v in roi_label(scores.to(device), pairwise_iou(b, b), labels.to(device),
                                                         cw.to(device), 0.6, 0.4, 0.1, 1).items()}
        m = roi_merge(roi_merge_ids(obj.to(device), b, 0.3), logits.to(device), logits.to(device))
        merged[device] = {k: v.cpu() for k, v in m.items()}
    label_equal = all(torch.equal(lab[DEVICE][k], lab["cpu"][k]) for k in lab["cpu"])
    ids_equal = torch.equal(merged[DEVICE]["ids"], merged["cpu"]["ids"])
    merge_err = (merged[DEVICE]["merged_cls"] - merged["cpu"]["merged_cls"]).abs().max().item()
    log(f"[wsod_zoo] (a) ops on the card against the CPU: roi_loop_pool ((2, 40, 56, 64) ReLU map, 600 ROIs, "
        f"3x600 bins rows) max_abs_err={pool_err:.3e} (tol 0), map gradient rel_err={grad_err:.3e} (tol 1e-5); "
        f"roi_label (2x{r} proposals, {c} classes) fields equal: {label_equal}; roi_merge (lambda 0.3, "
        f"{int(merged['cpu']['ids'].amax()) + 1} clusters of {r}) ids equal: {ids_equal}, rows max_abs_err="
        f"{merge_err:.3e} (tol 1e-6)")
    if not (pool_err == 0.0 and grad_err <= 1e-5 and label_equal and ids_equal and merge_err <= 1e-6):
        raise AssertionError("wsod_zoo ops: the card disagrees with the CPU")


def zoo_narrow_checks(kernels):
    """Phase 20(a): the five heads' narrow configurations (seeded weights,
    dropout 0, sampling that keeps every labelled proposal) on the card
    against this machine's CPU: the two-request batch's detections matched
    by (source proposal, class), and one train step (no clip) whose losses
    and update lie within max(1e-4 and WSOD_UPDATE_TOL, SURFACE_NOISE x
    the CPU's float32-to-float64 gap); then the three ops. These launches
    compare the card with the CPU and count in no main path's total."""
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.modeling import build_model

    batch = zoo_narrow_batch()
    before = [k.launches for k in kernels]
    failed = []
    torch.backends.cudnn.deterministic = True
    for name in ZOO_NARROW:
        cfg = zoo_cfg(name, narrow=True)
        cfg.merge_from_list(ZOO_NARROW_SOLVER)
        weights = random_state_dict(build_model(cfg, device="cpu"), seed=1)
        runs = {}
        for device, f64 in ((DEVICE, False), ("cpu", False), ("cpu", True)):
            model = build_model(cfg, device=device)
            model.load_state_dict(weights)
            if f64:
                float64_model(model)
            model.roi_heads.dan.dropout = 0.0  # the two devices' generators draw other bits
            det = None if f64 else {k: v.cpu() for k, v in model.inference(batch).items()}
            runs[(device, f64)] = (det, *steps_and_updates(cfg, model, batch, 1))
            del model
        (d_card, l_card, u_card), (d_cpu, l_cpu, u_cpu), (_, l64, u64) = (
            runs[(DEVICE, False)], runs[("cpu", False)], runs[("cpu", True)])
        m = match_detections(d_card, d_cpu, score_tol=1e-4)

        def rel(a, b):
            return (max(abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-12) for k in b[0]),
                    float((a[1] - b[1]).norm() / b[1].norm()))

        (loss_err, upd_err), (loss_gap, upd_gap) = rel((l_card[0], u_card[0]), (l_cpu[0], u_cpu[0])), rel(
            (l_cpu[0], u_cpu[0]), (l64[0], u64[0]))
        loss_tol, upd_tol = max(1e-4, SURFACE_NOISE * loss_gap), max(WSOD_UPDATE_TOL, SURFACE_NOISE * upd_gap)
        log(f"[wsod_zoo] (a) {name} narrow ({cfg.MODEL.ROI_HEADS.NAME}, float32, DAN "
            f"{list(cfg.MODEL.ROI_BOX_HEAD.DAN_DIM)}, 64 proposals): card vs CPU: detections {m['matched']} matched "
            f"by (source proposal, class), {m['reordered']} in another slot, {m['at_cut']} at the cut, boxes "
            f"max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4); one step: losses "
            f"rel_err {loss_err:.3e} (tol {loss_tol:.3e}), update L2 norm {float(u_cpu[0].norm()):.4g} rel_err "
            f"{upd_err:.3e} (tol {upd_tol:.3e}); CPU float32 against float64: losses {loss_gap:.3e}, update "
            f"{upd_gap:.3e}; losses " + ", ".join(f"{k}={v:.6g}" for k, v in l_cpu[0].items()))
        if not (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["class_scores"] <= 1e-4 and loss_err <= loss_tol
                and upd_err <= upd_tol and float(u_cpu[0].norm()) > 0
                and all(math.isfinite(v) for v in l_card[0].values())):
            failed.append(name)
    torch.backends.cudnn.deterministic = False
    if failed:
        raise AssertionError(f"wsod_zoo narrow checks: the card disagrees with the CPU in {failed}")
    zoo_ops_checks()
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[wsod_zoo] (a) launches on the card in these checks (no main path's): {got}")
    if not got[kernels[0].name] or not got[kernels[1].name]:
        raise AssertionError("wsod_zoo narrow checks: K1 or K2 never launched on the card")


def zoo_trainer(kernels, states):
    """Phase 20(e): CMIL on WSR-18 at full width through the WSL trainer
    (16(c)'s: ZOO_TRAINER_SCENES in-memory VOC scenes with 2000 proposals,
    the yaml's scales and the flip, TPU.IMAGE_BUCKETS that hold the 1200
    scale): the parameters move at each ITER_SIZE-th mini-batch only, K1
    once a mini-batch, K2 never. Returns the launches and the run's s/iter,
    data_time and peak memory."""
    import tempfile

    import torch

    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
    from jtsm_tpu_torch.wsl.train_net import Trainer

    name = "chip_smoke_voc_zoo"
    props = register_synthetic_voc(name, num=ZOO_TRAINER_SCENES, seed=7, image_hw=WSOD_IMAGE_HW, num_proposals=2000)
    cfg = zoo_cfg("cmil_WSR_18")
    cfg.DATASETS.TRAIN = (name,)
    cfg.DATASETS.PROPOSAL_FILES_TRAIN = (props,)
    cfg.TPU.IMAGE_BUCKETS = TC_JTSM_BUCKETS
    cfg.SOLVER.MAX_ITER = ZOO_TRAINER_ITERS
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.WEIGHTS = ""
    cfg.SEED = 0
    model = wsod_model(cfg, states)
    state = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    k = cfg.WSL.ITER_SIZE
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
            cfg.OUTPUT_DIR = tmp
            trainer, rec, got, peak = run_trainer(
                Trainer, cfg, kernels, state, watch=lambda m: [p for p in m.parameters() if p.requires_grad])
            check_launches("wsod_zoo trainer", rec, {kernels[0].name: 1, kernels[1].name: 0})
            moved = [sum(not torch.equal(a, b) for a, b in zip(rec.params[i], rec.params[i - 1]))
                     for i in range(1, ZOO_TRAINER_ITERS + 1)]
            if any((i % k == 0) != (n > 0) for i, n in enumerate(moved, 1)):
                raise AssertionError(f"wsod_zoo trainer: watched parameters moved {moved} (ITER_SIZE {k})")
            metrics = read_metrics(tmp)
            if not all(math.isfinite(v) for m in metrics[1:] for key, v in m.items() if key.startswith("loss")):
                raise AssertionError(f"wsod_zoo trainer: non-finite losses {metrics[-1]}")
            run = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                       data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak)
            log(f"[wsod_zoo] (e) cmil_WSR_18 {cfg.TPU.COMPUTE_DTYPE} through the WSL trainer: ITER_SIZE {k}, "
                f"IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH}, short sides {tuple(cfg.INPUT.MIN_SIZE_TRAIN)} and the "
                f"flip, {ZOO_TRAINER_SCENES} VOC scenes {WSOD_IMAGE_HW} with 2000 proposals, {ZOO_TRAINER_ITERS} "
                f"mini-batches: moved at {[i for i, n in enumerate(moved, 1) if n]}, s/iter median "
                f"{run['s_iter']:.4f} data_time median {run['data_time']:.4f} launches {got} peak_mem_gib "
                f"{peak:.3f} | losses at the last iteration "
                + ", ".join(f"{key}={v:.5g}" for key, v in metrics[-1].items() if key.startswith("loss"))
                + f" | cut: TPU.IMAGE_BUCKETS {TC_JTSM_BUCKETS}, random weights")
            del trainer
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    return got, run


def zoo_kernel_rows(gen, baseline):
    """Phase 20(d): K1 and K2 against their plain versions at the new
    launch sites: the GAM-attended WSR-18 res5 map (a seeded GAM layer over
    a (1|4, 64, 64, 512) map, serve R=2000 and train R=8000; K2 at the
    train shape, then the gradient of ``conv6`` through K1 and K2 against
    the same through the plain forward and backward), the cascade's mined
    rows (4 images, 20 classes x 32 boxes each, on the train map) and
    CMIL's VGG16 box pooler (a (4, 128, 128, 512) plain5 map, R=8000), in
    float32 and bfloat16. Returns the rows by site."""
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.ops import roi_align
    from jtsm_tpu_torch.wsl.modeling.mil_heads import GAMLayer

    rows = {"gam": {}, "cascade": {}, "cmil_vgg": {}}
    gam = GAMLayer(512, 20)
    gam.load_state_dict(random_state_dict(gam, seed=3))
    gam.to(DEVICE)
    for dtype in (torch.float32, torch.bfloat16):
        tag = dtype_tag(torch.empty(0, dtype=dtype))
        for kind, b in (("serve", 1), ("train", 4)):
            x = torch.relu(torch.randn((b, 512, 64, 64), generator=gen, device=DEVICE)).to(dtype)
            gam.conv6.compute_dtype = gam.conv7.compute_dtype = dtype
            with torch.no_grad():
                attended = gam(x)[0].permute(0, 2, 3, 1).contiguous()
            boxes = jtsm_mask_boxes(gen, 2000 * b, (688, 917))
            bidx = torch.arange(b, device=DEVICE, dtype=torch.int32).repeat_interleave(2000)
            levels = torch.zeros(2000 * b, dtype=torch.int32, device=DEVICE)
            site = f"GAM-attended WSR-18 res5 {kind} {tag} ({b}, 64, 64, 512)"
            rows["gam"][f"fwd {kind} {tag}"] = check_and_time_fwd(site, [attended], [1.0 / 16], boxes, bidx, levels,
                                                                  7, baseline, "wsod_zoo")
            if kind == "train":
                rows["gam"][f"bwd {tag}"] = check_and_time_bwd(site, [attended], [1.0 / 16], boxes, bidx, levels, 7,
                                                               gen, baseline, "wsod_zoo")
            if kind == "train" and dtype == torch.float32:
                cot = torch.randn((2000 * b, 7, 7, 512), generator=gen, device=DEVICE).to(dtype)
                grads = {}
                for route, fn in (("kernels", roi_align.roi_align_multilevel),
                                  ("plain", roi_align.roi_align_multilevel_plain_autograd)):
                    gam.zero_grad()
                    att = gam(x)[0].permute(0, 2, 3, 1).contiguous()
                    (fn([att], [1.0 / 16], boxes, bidx, levels, 7, 0, True).float() * cot.float()).sum().backward()
                    grads[route] = gam.conv6.weight.grad.detach().clone()
                err = ((grads["kernels"] - grads["plain"]).norm() / grads["plain"].norm()).item()
                tol = 1e-4
                log(f"[wsod_zoo] (d) {site}: conv6's weight gradient through K1 and K2 against the plain forward "
                    f"and backward: rel_err {err:.3e} (tol {tol:g}), norm {grads['plain'].norm().item():.4g}")
                if not err <= tol:
                    raise AssertionError(f"wsod_zoo: conv6's gradient through the kernels is {err} from plain's")
                rows["gam"][f"bwd {tag}"]["conv6_rel_err"] = err
        feat = torch.randn((4, 64, 64, 512), generator=gen, device=DEVICE).to(dtype)
        size = torch.exp(torch.empty(4 * 640, 2, device=DEVICE).uniform_(math.log(16), math.log(600), generator=gen))
        xy = torch.rand(4 * 640, 2, generator=gen, device=DEVICE) * (torch.tensor([917.0, 688.0], device=DEVICE) - size)
        boxes = torch.cat([xy, xy + size], 1)
        bidx = torch.arange(4, device=DEVICE, dtype=torch.int32).repeat_interleave(640)
        levels = torch.zeros(4 * 640, dtype=torch.int32, device=DEVICE)
        site = f"cascade mined rows {tag} (4, 64, 64, 512), 640 an image"
        rows["cascade"][f"fwd {tag}"] = check_and_time_fwd(site, [feat], [1.0 / 16], boxes, bidx, levels, 7, baseline,
                                                           "wsod_zoo")
        rows["cascade"][f"bwd {tag}"] = check_and_time_bwd(site, [feat], [1.0 / 16], boxes, bidx, levels, 7, gen,
                                                           baseline, "wsod_zoo")
        feat = torch.randn((4, 128, 128, 512), generator=gen, device=DEVICE).to(dtype)
        boxes = jtsm_mask_boxes(gen, 8000, (688, 917))
        bidx = torch.arange(4, device=DEVICE, dtype=torch.int32).repeat_interleave(2000)
        levels = torch.zeros(8000, dtype=torch.int32, device=DEVICE)
        site = f"CMIL VGG16 plain5 train {tag} (4, 128, 128, 512)"
        rows["cmil_vgg"][f"fwd {tag}"] = check_and_time_fwd(site, [feat], [1.0 / 8], boxes, bidx, levels, 7, baseline,
                                                            "wsod_zoo")
        rows["cmil_vgg"][f"bwd {tag}"] = check_and_time_bwd(site, [feat], [1.0 / 8], boxes, bidx, levels, 7, gen,
                                                            baseline, "wsod_zoo")
    return rows


def phase_wsod_zoo(kernels, gen, baseline):
    """Phase 20: Cascade OICR, OICR-SP, PCL with GAM, ContextLocNet and CMIL.
    (d) K1 and K2 at the new launch sites; (a) the narrow heads and the
    three ops on the card against the CPU; (b) the seven full-width
    configurations served; (c) their train steps; (e) CMIL through the WSL
    trainer. The plain ROIAlign raises on the card. Returns the kernel rows
    by site, each kernel's launches on (b), (c) and (e) (and by site), the
    latencies, the step times and the trainer's run."""
    from jtsm_tpu_torch.ops import roi_align

    k1, k2 = (k.name for k in kernels)
    rows = zoo_kernel_rows(gen, baseline)
    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 20")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        zoo_narrow_checks(kernels)
        t0 = time.perf_counter()
        states = wsod_states()
        log(f"[wsod_zoo] seeded full-width weights of WSR-18 and VGG16 in {time.perf_counter() - t0:.1f}s")
        serve_launches, latency = wsod_serve(kernels[0], states, ZOO_CASES, zoo_cfg, "wsod_zoo", ZOO_ROUNDS,
                                             ZOO_STAGE_ROUNDS)
        train_launches, steps, _ = wsod_train(kernels, states, ZOO_CASES, zoo_cfg, "wsod_zoo", ZOO_TRAIN_STEPS)
        trainer_launches, trainer = zoo_trainer(kernels, states)
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    launches = {k.name: sum(t[k.name] for t in train_launches.values()) + trainer_launches[k.name] for k in kernels}
    launches[k1] += sum(serve_launches.values())
    # by site: the GAM-attended map (PCL with GAM, served and trained), the
    # cascade's mined rows (REFINE_NUM - 1 of each Cascade OICR step's K1
    # launches) and CMIL's VGG16 box pooler (served and trained)
    ca = zoo_cfg("oicr_CA_WSR_18").WSL.REFINE_NUM
    sites = {
        "gam": {k1: serve_launches["pcl_gam_WSR_18"] + train_launches["pcl_gam_WSR_18"][k1],
                k2: train_launches["pcl_gam_WSR_18"][k2]},
        "cascade": {k1: train_launches["oicr_CA_WSR_18"][k1] * (ca - 1) // ca, k2: train_launches["oicr_CA_WSR_18"][k2]},
        "cmil_vgg": {k1: serve_launches["cmil_V_16"] + train_launches["cmil_V_16"][k1],
                     k2: train_launches["cmil_V_16"][k2]},
    }
    return rows, launches, sites, latency, steps, trainer


# phase 21: CSC, CSC-OICR and WSJDS with the class-peak-gradient pass, UWSOD
# with RPNWSL on the multi-rate VGG16 (config.WSOD_ZOO's five entries and
# the WSJDS builder)
CSC_CASES = ("csc_WSR_18", "csc_V_16", "csc_oicr_V_16", "csc_oicr_reg_last_V_16", "uwsod_V_16", "wsjds_V_16")
CSC_NARROW = ("csc_WSR_18", "csc_oicr_V_16", "wsjds_crf_V_16", "uwsod_V_16")
CSC_ROUNDS = 4  # requests in each dtype
CSC_STAGE_ROUNDS = 1
CSC_TRAIN_STEPS = 6  # each dtype, in turns; the medians take steps 2-6
CSC_TRAINER_SCENES = 8
CSC_TRAINER_ITERS = {"csc_V_16": 6, "uwsod_V_16": 4}
CSC_TRAINER_MAX_ITER = 2  # csc_V_16's WSL.CSC_MAX_ITER in 21(e): the maps for iterations 0-2, then none
# 21(a): the narrow models' MIL layer opens the CPG gate for class 3 (image
# 0's) and not for class 12 (image 1's), as tests/test_torch_csc.py sets
# its seeded weights: the MIL and refinement kernels times 0.02 (at 0.1
# WSR-18's seeded features still outweigh the bias), the class bias raised
# at these classes
CSC_NARROW_BIAS = {3: 6.0, 12: 4.0}
CSC_MAP_TOL = 2e-2  # a CPG map's float32 noise through VGG16 at random weights: 7.6e-3 on this CPU
# 21(c) and (e): the CSC heads train at 1/100 of their yamls' BASE_LR. At
# the yamls' rates the first update saturates a present class's image
# score to 1 in float32, where the CSC loss's clip (1 - 1e-20, which is 1)
# lets log1p(-1) meet its zero weight: NaN, in both packages (ROADMAP §3,
# tests/test_torch_csc_ops.py)
CSC_LR_FACTOR = 0.01
# UWSOD's narrow RPN samples every labelled anchor (no draw decides a loss)
# and its regression loss is smooth below 1/9: the PGT box's own anchor
# regresses to its prediction, where L1's gradient sign is rounding noise
CSC_UWSOD_NARROW = ["MODEL.RPN.BATCH_SIZE_PER_IMAGE", "8192", "MODEL.RPN.POSITIVE_FRACTION", "1.0",
                    "MODEL.RPN.SMOOTH_L1_BETA", str(1.0 / 9)]


def csc_cfg(name, narrow=False):
    """The configuration of a CSC_CASES or CSC_NARROW entry: its
    ``WSOD_ZOO`` builder, or ``wsjds_V_16_DC5_cfg`` (``_crf``: with the CRF
    constraint)."""
    import jtsm_tpu_torch.config as config

    if name.startswith("wsjds"):
        return config.wsjds_V_16_DC5_cfg(narrow=narrow, crf="crf" in name)
    return config.WSOD_ZOO[name][1](narrow=narrow)


def is_cpg_head(cfg):
    from jtsm_tpu_torch.wsl.modeling.wsjds import CPG_ROI_HEADS

    return cfg.MODEL.ROI_HEADS.NAME in CPG_ROI_HEADS


def csc_narrow_weights(model):
    """``random_state_dict`` of ``model`` (seed 1), its MIL and refinement
    kernels times 0.02 and its class bias raised at CSC_NARROW_BIAS."""
    from jtsm_tpu_torch.checkpoint import random_state_dict

    state = random_state_dict(model, seed=1)
    for k, v in state.items():
        if k.startswith(("roi_heads.mil.", "roi_heads.refine")) and k.endswith(".weight"):
            state[k] = v * 0.02
    for c, add in CSC_NARROW_BIAS.items():
        state["roi_heads.mil.cls.bias"][c] += add
    return state


def csc_ops_checks():
    """``csc_full`` and ``crf_mean_field`` on the card against this
    machine's CPU at a train batch's shapes (4 images of 20 peaked maps at
    704x928, 2000 proposals on half and whole pixels, predictions in (0,
    1); the CRF over (4, 88, 116, 20)
    probabilities, WSJDS's seg grid at stride 8), each within max(PR 15's
    tolerance, 3 x the CPU's float32-to-float64 gap)."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.wsl.modeling.wsod_zoo import csc_full
    from jtsm_tpu_torch.wsl.ops import crf_mean_field

    g = torch.Generator().manual_seed(21)
    b, c, h, w, r = 4, 20, 704, 928, 2000
    # four Gaussian peaks a map (sigma 20 to 80 px): the proposals that
    # frame one score above their context, the rest below
    yy = torch.arange(h, dtype=torch.float32)[:, None]
    xx = torch.arange(w, dtype=torch.float32)[None, :]
    cpg = torch.zeros((b, c, h, w))
    for _ in range(4):
        cy, cx = torch.rand((b, c, 1, 1), generator=g) * h, torch.rand((b, c, 1, 1), generator=g) * w
        sd = 20 + torch.rand((b, c, 1, 1), generator=g) * 60
        cpg += torch.rand((b, c, 1, 1), generator=g) * torch.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * sd * sd))
    cpg = cpg / cpg.amax(dim=(2, 3), keepdim=True)
    xy = torch.floor(torch.rand((b, r, 2), generator=g) * torch.tensor([w - 40.0, h - 40.0]) * 2) / 2
    boxes = torch.cat([xy, xy + 16 + torch.floor(torch.rand((b, r, 2), generator=g) * 400) / 2], -1)
    valid = torch.rand((b, r), generator=g) > 0.05
    labels = (torch.rand((b, c), generator=g) < 0.2).float()
    labels[:, 3] = 1.0
    preds = torch.rand((b, c), generator=g)
    unary = torch.softmax(torch.randn((b, 88, 116, c), generator=g) * 2, dim=-1)
    image = torch.rand((b, 88, 116, 3), generator=g) * 255
    out = {}
    for device, dtype in ((DEVICE, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        args = [t.to(device) for t in (cpg, boxes, valid, labels)] + [preds.to(device, dtype)]
        with exact_float32():
            out[(device, dtype)] = (csc_full(*args).cpu().double(),
                                    crf_mean_field(unary.to(device, dtype), image.to(device, dtype)).cpu().double())
    card, cpu, f64 = out[(DEVICE, torch.float32)], out[("cpu", torch.float32)], out[("cpu", torch.float64)]
    errs = [float((a - b_).abs().max()) for a, b_ in zip(card, cpu)]
    gaps = [float((a - b_).abs().max()) for a, b_ in zip(cpu, f64)]
    tols = [max(1e-6, 3 * gaps[0]), max(1e-5, 3 * gaps[1])]
    negative = int((cpu[0] < 0).sum())
    log(f"[csc_uwsod] (a) ops on the card against the CPU: csc_full ({b}x{c} maps {h}x{w}, {r} proposals, "
        f"{negative} negative weights) max_abs_err={errs[0]:.3e} (tol {tols[0]:.3e}); crf_mean_field "
        f"{tuple(unary.shape)} max_abs_err={errs[1]:.3e} (tol {tols[1]:.3e}); CPU float32 against float64: "
        f"{gaps[0]:.3e}, {gaps[1]:.3e}")
    if not (errs[0] <= tols[0] and errs[1] <= tols[1] and negative > 0):
        raise AssertionError(f"csc_uwsod ops: the card disagrees with the CPU: {errs} (tol {tols})")


def csc_narrow_checks(kernels):
    """Phase 21(a): the narrow CSC on WSR-18 (FREEZE_AT 0), CSC-OICR on
    VGG16, WSJDS with the CRF and UWSOD (seeded weights, CSC_NARROW_BIAS,
    dropout 0) on the card against this machine's CPU: the two-request
    batch's detections matched by (source proposal, class) (WSJDS's
    ``masks_full`` within 1e-4), the CPG maps within max(CSC_MAP_TOL, 3 x
    the CPU's float32-to-float64 gap), and one train step given the CPU's
    float32 maps (no clip) whose losses and update lie within max(1e-4 and
    WSOD_UPDATE_TOL, SURFACE_NOISE x that gap); then ``csc_full`` and
    ``crf_mean_field``. These launches count in no main path's total."""
    import torch

    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.wsl.modeling.wsjds import class_peak_gradients

    batch = zoo_narrow_batch()
    before = [k.launches for k in kernels]
    failed = []
    torch.backends.cudnn.deterministic = True
    for name in CSC_NARROW:
        cfg = csc_cfg(name, narrow=True)
        cfg.merge_from_list(ZOO_NARROW_SOLVER + (CSC_UWSOD_NARROW if name.startswith("uwsod") else []))
        weights = csc_narrow_weights(build_model(cfg, device="cpu"))
        runs, maps = {}, {}
        for device, f64 in (("cpu", False), (DEVICE, False), ("cpu", True)):
            model = build_model(cfg, device=device)
            model.load_state_dict(weights)
            if f64:
                float64_model(model)
            model.roi_heads.dan.dropout = 0.0
            det = None if f64 else {k: v.cpu() for k, v in model.inference(batch).items()}
            step_batch = batch
            if is_cpg_head(cfg):
                got, passes = class_peak_gradients(model, batch, 20)
                maps[(device, f64)] = got.double().cpu()
                step_batch = dict(batch, cpg=maps[("cpu", False)].float().to(device))
            runs[(device, f64)] = (det, *steps_and_updates(cfg, model, step_batch, 1))
            del model
        (d_card, l_card, u_card), (d_cpu, l_cpu, u_cpu), (_, l64, u64) = (
            runs[(DEVICE, False)], runs[("cpu", False)], runs[("cpu", True)])
        if "masks_full" in d_cpu:  # WSJDS: compared pair by pair as masks
            d_card, d_cpu = dict(d_card, masks=d_card["masks_full"]), dict(d_cpu, masks=d_cpu["masks_full"])
        m = match_detections(d_card, d_cpu, score_tol=1e-4)

        def rel(a, b):
            return (max(abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-12) for k in b[0]),
                    float((a[1] - b[1]).norm() / b[1].norm()))

        (loss_err, upd_err), (loss_gap, upd_gap) = rel((l_card[0], u_card[0]), (l_cpu[0], u_cpu[0])), rel(
            (l_cpu[0], u_cpu[0]), (l64[0], u64[0]))
        loss_tol, upd_tol = max(1e-4, SURFACE_NOISE * loss_gap), max(WSOD_UPDATE_TOL, SURFACE_NOISE * upd_gap)
        ok = (m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["class_scores"] <= 1e-4 and m["masks"] <= 1e-4
              and loss_err <= loss_tol and upd_err <= upd_tol and float(u_cpu[0].norm()) > 0
              and all(math.isfinite(v) for v in l_card[0].values()))
        extra = f", masks_full max_abs_err {m['masks']:.3e} (tol 1e-4)" if "masks" in d_cpu else ""
        if maps:
            map_err = float((maps[(DEVICE, False)] - maps[("cpu", False)]).abs().max())
            map_gap = float((maps[("cpu", False)] - maps[("cpu", True)]).abs().max())
            map_tol = max(CSC_MAP_TOL, SURFACE_NOISE * map_gap)
            lit = int((maps[("cpu", False)].amax(dim=(2, 3)) > 0).sum())
            ok = ok and map_err <= map_tol and lit > 0
            extra += (f"; CPG maps ({passes} passes, {lit} maps past the gate) max_abs_err {map_err:.3e} "
                      f"(tol {map_tol:.3e}, float32 against float64 {map_gap:.3e})")
        log(f"[csc_uwsod] (a) {name} narrow ({cfg.MODEL.ROI_HEADS.NAME}, float32): card vs CPU: detections "
            f"{m['matched']} matched, {m['reordered']} in another slot, {m['at_cut']} at the cut, boxes "
            f"max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4){extra}; one step: "
            f"losses rel_err {loss_err:.3e} (tol {loss_tol:.3e}), update L2 norm {float(u_cpu[0].norm()):.4g} "
            f"rel_err {upd_err:.3e} (tol {upd_tol:.3e}); CPU float32 against float64: losses {loss_gap:.3e}, update "
            f"{upd_gap:.3e}; losses " + ", ".join(f"{k}={v:.6g}" for k, v in l_cpu[0].items()))
        if not ok:
            failed.append(name)
    torch.backends.cudnn.deterministic = False
    if failed:
        raise AssertionError(f"csc_uwsod narrow checks: the card disagrees with the CPU in {failed}")
    csc_ops_checks()
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[csc_uwsod] (a) launches on the card in these checks (no main path's): {got}")
    if not got[kernels[0].name] or not got[kernels[1].name]:
        raise AssertionError("csc_uwsod narrow checks: K1 or K2 never launched on the card")


def csc_states(states):
    """``wsod_states`` with the MIL and refinement kernels times 0.02: at
    the seed's scale the class softmax saturates, an absent class's image
    score rounds to 1, and the CSC loss, whose clip at 1 - 1e-20 is 1 in
    float32 (as in the JAX package), is infinite."""
    return {net: {k: v * 0.02 if k.startswith(("roi_heads.mil.", "roi_heads.refine")) and k.endswith(".weight")
                  else v for k, v in state.items()} for net, state in states.items()}


def cpg_launches(cfg, passes):
    """(K1, K2) of one CPG pass with ``passes`` backwards: none where the
    pooled map is detached (FREEZE_AT 5), else K1 once (the forward) and K2
    once a backward."""
    if cfg.MODEL.BACKBONE.FREEZE_AT >= 5:
        return 0, 0
    return 1, passes


def csc_trainers(kernels, states):
    """Phase 21(e): csc_V_16 through the WSL trainer with WSL.CSC_MAX_ITER
    CSC_TRAINER_MAX_ITER at CSC_LR_FACTOR of its rate (the trainer's CPG pass before each of the first
    iterations, then none: K1 twice and K2 once plus once a pass, then once
    each; ``loss_cls_pos`` and ``loss_cls_neg`` then ``loss_mil``), and
    uwsod_V_16 (MODEL.LOAD_PROPOSALS False: its yaml names no proposal
    files, ROADMAP §3; K1 once an iteration, K2 never), each on
    CSC_TRAINER_SCENES in-memory VOC scenes, the yamls' scales and the flip,
    IMS_PER_BATCH 4, TPU.IMAGE_BUCKETS that hold the 1200 scale. Returns
    each kernel's launches (and the CPG passes') and each run's s/iter,
    data_time (the CPG pass inside it) and peak memory."""
    import tempfile

    import torch

    from jtsm_tpu_torch.data import DatasetCatalog, MetadataCatalog
    from jtsm_tpu_torch.data.datasets.synthetic_voc import register_synthetic_voc
    from jtsm_tpu_torch.wsl.modeling.wsjds import cpg_slots
    from jtsm_tpu_torch.wsl.train_net import Trainer

    name = "chip_smoke_voc_csc"
    props = register_synthetic_voc(name, num=CSC_TRAINER_SCENES, seed=11, image_hw=WSOD_IMAGE_HW,
                                   num_proposals=2000)
    passes = []

    class CountingTrainer(Trainer):
        """The WSL trainer, keeping each iteration's occupied class slots
        (the CPG pass's backwards) beside its transform."""

        def __init__(self, cfg):
            super().__init__(cfg)
            transform = self._trainer.batch_transform
            if transform is not None:
                def counting(state, batch, iteration):
                    out = transform(state, batch, iteration)
                    on = "cpg" in out
                    passes.append(int(cpg_slots(batch["gt_classes"], batch["gt_valid"])[1].any(axis=0).sum())
                                  if on else 0)
                    return out

                self._trainer.batch_transform = counting

    launches, cpg_total, out = {k.name: 0 for k in kernels}, {k.name: 0 for k in kernels}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_csc_") as tmp:
            for case, iters in CSC_TRAINER_ITERS.items():
                cfg = csc_cfg(case)
                cfg.DATASETS.TRAIN = (name,)
                if case.startswith("uwsod"):
                    cfg.MODEL.LOAD_PROPOSALS = False
                else:
                    cfg.DATASETS.PROPOSAL_FILES_TRAIN = (props,)
                    cfg.WSL.CSC_MAX_ITER = CSC_TRAINER_MAX_ITER
                    cfg.SOLVER.BASE_LR *= CSC_LR_FACTOR
                cfg.TPU.IMAGE_BUCKETS = TC_JTSM_BUCKETS
                cfg.SOLVER.MAX_ITER = iters
                cfg.TEST.EVAL_PERIOD = 0
                cfg.MODEL.WEIGHTS = ""
                cfg.OUTPUT_DIR = os.path.join(tmp, case)
                cfg.SEED = 0
                model = wsod_model(cfg, states)
                state = {k: v.cpu() for k, v in model.state_dict().items()}
                del model
                passes.clear()
                trainer, rec, got, peak = run_trainer(
                    CountingTrainer, cfg, kernels, state, watch=lambda m: [p for p in m.parameters() if p.requires_grad])
                cpg_on = is_cpg_head(cfg)
                for i, n in enumerate(rec.launches):
                    p = passes[i] if cpg_on else 0
                    on = cpg_on and i <= CSC_TRAINER_MAX_ITER
                    want = [1 + int(on), (1 + p) if cfg.MODEL.BACKBONE.FREEZE_AT < 5 else 0]
                    if n != want or (on != (p > 0) and cpg_on):
                        raise AssertionError(f"csc_uwsod trainer {case} iteration {i}: launches {n}, not {want} "
                                             f"({p} CPG passes)")
                    if on:
                        cpg_total[kernels[0].name] += 1
                        cpg_total[kernels[1].name] += p
                moved = [sum(not torch.equal(a, b) for a, b in zip(rec.params[i], rec.params[i - 1]))
                         for i in range(1, iters + 1)]
                if not all(moved):
                    raise AssertionError(f"csc_uwsod trainer {case}: watched parameters moved {moved}")
                metrics = read_metrics(cfg.OUTPUT_DIR)
                if not all(math.isfinite(v) for m in metrics[1:] for key, v in m.items() if key.startswith("loss")):
                    raise AssertionError(f"csc_uwsod trainer {case}: non-finite losses {metrics[-1]}")
                keys = [sorted(k for k in m if k.startswith("loss")) for m in metrics[1:]]
                if cpg_on:
                    want_keys = [["loss_cls_neg", "loss_cls_pos"] if i <= CSC_TRAINER_MAX_ITER else ["loss_mil"]
                                 for i in range(iters - 1)]
                    if keys != want_keys:
                        raise AssertionError(f"csc_uwsod trainer {case}: losses by iteration {keys}")
                for key, n in got.items():
                    launches[key] += n
                out[case] = dict(s_iter=median(iteration_times(trainer, "time", 1)), launches=got,
                                 data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak,
                                 data_times=[round(v, 4) for v in iteration_times(trainer, "data_time", 0)])
                log(f"[csc_uwsod] (e) {case} {cfg.TPU.COMPUTE_DTYPE} through the WSL trainer: ITER_SIZE "
                    f"{cfg.WSL.ITER_SIZE}, IMS_PER_BATCH {cfg.SOLVER.IMS_PER_BATCH}, short sides "
                    f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)} and the flip, {CSC_TRAINER_SCENES} VOC scenes {WSOD_IMAGE_HW}"
                    + (f" with 2000 proposals, WSL.CSC_MAX_ITER {CSC_TRAINER_MAX_ITER} (CPG passes by iteration "
                       f"{passes})" if cpg_on else ", no proposal files (MODEL.LOAD_PROPOSALS False)")
                    + f", {iters} iterations: s/iter median {out[case]['s_iter']:.4f} data_time by iteration "
                    f"{out[case]['data_times']} (the CPG pass inside it) launches {got} peak_mem_gib {peak:.3f} | "
                    + (f"losses by iteration {keys} | " if cpg_on else "") + "last " + ", ".join(
                        f"{key}={v:.5g}" for key, v in metrics[-1].items() if key.startswith("loss"))
                    + f" | cut: TPU.IMAGE_BUCKETS {TC_JTSM_BUCKETS}, random weights")
                del trainer
    finally:
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    return launches, cpg_total, out


def wsjds_seg_split(states):
    """WSJDS's ``seg`` stage op by op, serving one ``wsod_request`` in each
    of bf16 and f32: the ASPP head's convolutions (each with its norm and
    ReLU) on the request's plain5 map, the image pool, the projection, the
    predictor, and the whole stage (``segment``: the head, the sigmoid
    masks resized to the image and windowed by the detections), each the
    median of 5 calls to a synchronize. Returns the milliseconds by dtype
    and op."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32, interpolate_bilinear

    base = csc_cfg("wsjds_V_16")
    req = wsod_request(base, 1)
    out = {}
    for d in (base.TPU.COMPUTE_DTYPE, "float32"):
        cfg = base.clone()
        cfg.TPU.COMPUTE_DTYPE = d
        model = wsod_model(cfg, states)
        heads, aspp = model.roi_heads, model.roi_heads.sem_seg_head.aspp
        with torch.no_grad(), exact_float32(d == "float32"):
            feats, sizes = model._features(req)
            x = feats[heads.in_features[-1]]
            det = model.inference(req)
            res = [conv(x) for conv in aspp.branches]
            pooled = x.mean(dim=(2, 3), keepdim=True)
            res.append(interpolate_bilinear(aspp.image_pool_conv(pooled), tuple(x.shape[-2:])))
            cat = torch.cat(res, dim=1)
            logits = heads.sem_seg_head.predictor(aspp.project(cat))
            ops = {name: (lambda c=conv: c(x)) for name, conv in zip(
                ("conv1x1", "conv3x3_d6", "conv3x3_d12", "conv3x3_d18"), aspp.branches)}
            ops["image_pool"] = lambda: interpolate_bilinear(aspp.image_pool_conv(x.mean(dim=(2, 3), keepdim=True)),
                                                             tuple(x.shape[-2:]))
            ops["project"] = lambda: aspp.project(cat)
            ops["predictor"] = lambda: heads.sem_seg_head.predictor(aspp.project(cat))
            ops["seg"] = lambda: heads.segment(feats, {k: det[k] for k in ("boxes", "classes", "valid")})
            out[d] = {name: median([timed_ms(fn) for _ in range(5)]) for name, fn in ops.items()}
        log(f"[csc_uwsod] (b) wsjds_V_16 {DTYPE_NAMES[d]} seg stage op by op, plain5 {tuple(x.shape)}, logits "
            f"{tuple(logits.shape)}: " + " ".join(f"{k}={v:.3f}" for k, v in out[d].items()) + " ms")
        del model
    return out


def csc_kernel_rows(gen, baseline):
    """Phase 21(d): K1 and K2 against their plain versions at the new
    launch sites, in float32 and bfloat16: the CPG pass's VGG16 box pooler
    (a (4, 128, 128, 512) plain5 map of a 1024x1024 bucket, R=8000: K1 in
    its forward, K2 in each of its backwards) and UWSOD's branch-averaged
    plain5 (the mean of three seeded branch maps, serve B=1 with
    RPNWSL's 2048 proposals, train B=4 with 4x2048). Returns the rows by
    site."""
    import torch

    rows = {"cpg": {}, "uwsod": {}}
    for dtype in (torch.float32, torch.bfloat16):
        tag = dtype_tag(torch.empty(0, dtype=dtype))
        feat = torch.randn((4, 128, 128, 512), generator=gen, device=DEVICE).to(dtype)
        boxes = jtsm_mask_boxes(gen, 8000, (688, 917))
        bidx = torch.arange(4, device=DEVICE, dtype=torch.int32).repeat_interleave(2000)
        levels = torch.zeros(8000, dtype=torch.int32, device=DEVICE)
        site = f"CPG pass VGG16 plain5 {tag} (4, 128, 128, 512)"
        rows["cpg"][f"fwd {tag}"] = check_and_time_fwd(site, [feat], [1.0 / 8], boxes, bidx, levels, 7, baseline,
                                                       "csc_uwsod")
        rows["cpg"][f"bwd {tag}"] = check_and_time_bwd(site, [feat], [1.0 / 8], boxes, bidx, levels, 7, gen,
                                                       baseline, "csc_uwsod")
        for kind, b in (("serve", 1), ("train", 4)):
            branches = torch.randn((3, b, 128, 128, 512), generator=gen, device=DEVICE).to(dtype)
            avg = branches.mean(dim=0)
            r = 2048 * b
            boxes = jtsm_mask_boxes(gen, r, (688, 917))
            bidx = torch.arange(b, device=DEVICE, dtype=torch.int32).repeat_interleave(2048)
            levels = torch.zeros(r, dtype=torch.int32, device=DEVICE)
            site = f"UWSOD branch-averaged plain5 {kind} {tag} ({b}, 128, 128, 512)"
            rows["uwsod"][f"fwd {kind} {tag}"] = check_and_time_fwd(site, [avg], [1.0 / 8], boxes, bidx, levels, 7,
                                                                    baseline, "csc_uwsod")
    return rows


def phase_csc_uwsod(kernels, gen, baseline):
    """Phase 21: CSC, CSC-OICR, WSJDS and UWSOD. (d) K1 and K2 at the new
    launch sites; (a) the narrow models, ``csc_full`` and
    ``crf_mean_field`` on the card against the CPU; (b) the six full-width
    configurations served; (c) their train steps with the CPG pass; (e)
    csc_V_16 and uwsod_V_16 through the WSL trainer. The plain ROIAlign
    raises on the card. Returns the kernel rows by site, each kernel's
    launches on (b), (c) and (e) (all, UWSOD's, the CPG passes'), the
    latencies, the step times and the trainers' runs."""
    from jtsm_tpu_torch.ops import roi_align

    rows = csc_kernel_rows(gen, baseline)
    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 21")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        csc_narrow_checks(kernels)
        t0 = time.perf_counter()
        states = csc_states(wsod_states())
        log(f"[csc_uwsod] seeded full-width weights of WSR-18 and VGG16 in {time.perf_counter() - t0:.1f}s")
        serve_launches, latency = wsod_serve(kernels[0], states, CSC_CASES, csc_cfg, "csc_uwsod", CSC_ROUNDS,
                                             CSC_STAGE_ROUNDS)
        wsjds_seg_split(states)
        train_launches, steps, train_cpg = wsod_train(kernels, states, CSC_CASES, csc_cfg, "csc_uwsod",
                                                      CSC_TRAIN_STEPS)
        trainer_launches, trainer_cpg, trainers = csc_trainers(kernels, states)
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    k1 = kernels[0].name
    launches = {k.name: sum(t[k.name] for t in train_launches.values()) + trainer_launches[k.name] for k in kernels}
    launches[k1] += sum(serve_launches.values())
    uwsod = serve_launches["uwsod_V_16"] + train_launches["uwsod_V_16"][k1] + trainers["uwsod_V_16"]["launches"][k1]
    cpg = {k.name: train_cpg["launches"][k.name] + trainer_cpg[k.name] for k in kernels}
    return rows, launches, uwsod, cpg, latency, {key: (ms, train_cpg["ms"].get(key, 0.0)) for key, ms in steps.items()}, \
        trainers


# ---------------------------------------------------------------------------
# Phase 22: the C4 family, Trident OICR and Faster R-CNN on the WSR-50 FPN
# ---------------------------------------------------------------------------

# the supervised models of phase 22: their Python builders and titles, K1's
# launches a request (C4 Mask R-CNN pools the proposals, then its
# detections again for the mask head) and (K1, K2) a train step (the C4 mask
# head reads the box branch's res5 features: one pooling a step)
C4_BUILDERS = {"c4_mask": "mask_rcnn_R_50_C4_cfg", "wsr_c4": "faster_rcnn_WSR_50_C4_cfg",
               "wsr_fpn": "faster_rcnn_WSR_50_FPN_cfg"}
C4_K1 = {"c4_mask": 2, "wsr_c4": 1, "wsr_fpn": 1}
C4_SERVED = ("c4_mask", "wsr_fpn")  # at full width, beside Trident OICR (TRD)
TRD = "oicr_TRD_WSR_18"
C4_ROUNDS = 4  # requests in each dtype
C4_STAGE_ROUNDS = 1
C4_TRAINER_SCENES = 8
C4_TRAINER_ITERS = 6  # the iteration timer starts after 3
TRAIN_K.update(c4_mask=(1, 1), wsr_c4=(1, 1), wsr_fpn=(1, 1))
TRAIN_LOSSES.update(c4_mask=MASK_RCNN_LOSSES, wsr_c4=["loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc"],
                    wsr_fpn=["loss_box_reg", "loss_cls", "loss_rpn_cls", "loss_rpn_loc"])
TRAIN_TITLES.update(c4_mask="Mask R-CNN R50-C4", wsr_c4="Faster R-CNN WSR-50-C4", wsr_fpn="Faster R-CNN WSR-50-FPN")
FAM_NARROW_LR.update(c4_mask=2e-4, wsr_c4=2e-4, wsr_fpn=2e-4)


def trd_cfg(name=TRD, narrow=False):
    """Trident OICR on WSR-18 (``oicr_TRD_WSR_18_DC5_cfg``), or its narrow
    form."""
    import jtsm_tpu_torch.config as config

    return config.oicr_TRD_WSR_18_DC5_cfg(narrow=narrow)


def c4_kernel_rows(gen, baseline):
    """Phase 22(d): K1 and K2 against their plain versions at the new
    launch sites, in float32 and bfloat16: the C4 res4 pooler of an
    800x1344 pair, (2, 50, 84, 1024) at P=14 (serving's 2 x 1000
    proposals, the mask branch's 2 x 100 detections pooled again, and a
    train step's 2 x 512 sampled ROIs with K2), and Trident's
    branch-averaged WSR-18 res5 (the mean of three seeded branch maps,
    serve B=1 R=2000, train B=4 R=8000; K1 only: FREEZE_AT 5 detaches every
    branch). Returns the rows by site."""
    import torch

    rows = {"c4": {}, "trd": {}}
    h, w = FLAGSHIP_HW
    for dtype in (torch.float32, torch.bfloat16):
        tag = dtype_tag(torch.empty(0, dtype=dtype))
        res4 = torch.randn((TRAIN_BATCH, h // 16, w // 16, 1024), generator=gen, device=DEVICE).to(dtype)
        for kind, r in (("serve", 1000), ("mask", 100), ("train", 512)):
            boxes = spread_boxes(gen, TRAIN_BATCH * r)
            bidx = torch.arange(TRAIN_BATCH, device=DEVICE, dtype=torch.int32).repeat_interleave(r)
            levels = torch.zeros(TRAIN_BATCH * r, dtype=torch.int32, device=DEVICE)
            site = f"C4 res4 {kind} {tag} {tuple(res4.shape)} R={TRAIN_BATCH}x{r}"
            rows["c4"][f"fwd {kind} {tag}"] = check_and_time_fwd(site, [res4], [1.0 / 16], boxes, bidx, levels, 14,
                                                                  baseline, "c4_trident_fpn")
            if kind == "train":
                rows["c4"][f"bwd {kind} {tag}"] = check_and_time_bwd(site, [res4], [1.0 / 16], boxes, bidx, levels,
                                                                      14, gen, baseline, "c4_trident_fpn")
        del res4
        for kind, b in (("serve", 1), ("train", 4)):
            branches = torch.randn((3, b, 64, 64, 512), generator=gen, device=DEVICE).to(dtype)
            avg = branches.mean(dim=0)
            r = 2000 * b
            boxes = jtsm_mask_boxes(gen, r, (688, 917))
            bidx = torch.arange(b, device=DEVICE, dtype=torch.int32).repeat_interleave(2000)
            levels = torch.zeros(r, dtype=torch.int32, device=DEVICE)
            site = f"Trident branch-averaged res5 {kind} {tag} ({b}, 64, 64, 512)"
            rows["trd"][f"fwd {kind} {tag}"] = check_and_time_fwd(site, [avg], [1.0 / 16], boxes, bidx, levels, 7,
                                                                   baseline, "c4_trident_fpn")
    return rows


def c4_narrow_weights(model):
    """``random_state_dict`` of ``model`` (seed 1) with the box
    classifier's kernel times 0.05: at random weights res5's mean
    saturates the softmax, whose ties at 1.0 rank either way on two
    devices."""
    from jtsm_tpu_torch.checkpoint import random_state_dict

    return {k: v * 0.05 if k.endswith("cls_score.weight") else v
            for k, v in random_state_dict(model, seed=1).items()}


def shared_proposals(model, recorded):
    """Makes ``model``'s RPN hand its ROI heads the proposals recorded in
    ``recorded`` for its mode (serving, training) where a first model put
    them, its own losses kept: with seeded weights two objectness logits
    may tie within rounding at the RPN's top-k cut, and two devices then
    keep another proposal; the heads are held on the same ones."""
    rpn = model.proposal_generator
    forward = rpn.forward

    def shared(*args, **kwargs):
        proposals, scores, losses = forward(*args, **kwargs)
        key = rpn.training
        if key not in recorded:
            recorded[key] = (proposals.detach().cpu(), scores.detach().cpu())
        p, s = recorded[key]
        return p.to(proposals), s.to(scores), losses

    rpn.forward = shared


def c4_narrow_checks(kernels):
    """Phase 22(a): the narrow C4 Mask R-CNN, WSR-50 C4 and WSR-50 FPN
    (``train_family_cfg``'s sampling: every anchor and proposal a slot, so
    that no draw decides a loss; at most 128 foreground slots an image, so
    the C4 mask head reads them all; the ROI heads on the CPU's proposals,
    ``shared_proposals``) and the narrow Trident OICR (every
    stage training, dropout 0) on the card against this machine's CPU: a
    request's detections (matched by class, box and score; Trident's by
    (source proposal, class)) and one train step (no clip) whose losses and
    update lie within max(1e-4 and WSOD_UPDATE_TOL, SURFACE_NOISE x the
    CPU's float32-to-float64 gap): phase 20(a)'s rule. These launches count in no
    main path's total."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.modeling import build_model

    before = [k.launches for k in kernels]
    failed = []
    torch.backends.cudnn.deterministic = True
    for name in tuple(C4_BUILDERS) + (TRD,):
        if name == TRD:
            cfg = trd_cfg(narrow=True)
            cfg.merge_from_list(ZOO_NARROW_SOLVER)
            batch = zoo_narrow_batch()
        else:
            cfg = train_family_cfg(name, narrow=True)
            cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # random weights score below 0.05
            batch = family_train_batch(cfg, 11, 2, FAM_NARROW_HW, cfg.TPU.MAX_GT_INSTANCES, 3)
            batch["orig_sizes"] = np.array([[256, 352], [128, 176]], np.int32)
        weights = c4_narrow_weights(build_model(cfg, device="cpu"))
        runs, recorded = {}, {}
        for device, f64 in (("cpu", False), (DEVICE, False), ("cpu", True)):
            model = build_model(cfg, device=device)
            model.load_state_dict(weights)
            if f64:
                float64_model(model)
            if name != TRD:
                shared_proposals(model, recorded)
            if name == TRD:
                model.roi_heads.dan.dropout = 0.0  # the two devices' generators draw other bits
            det = None if f64 else {k: v.cpu() for k, v in model.inference(batch).items()}
            runs[(device, f64)] = (det, *steps_and_updates(cfg, model, batch, 1))
            del model
        (d_card, l_card, u_card), (d_cpu, l_cpu, u_cpu), (_, l64, u64) = (
            runs[(DEVICE, False)], runs[("cpu", False)], runs[("cpu", True)])
        if name == TRD:
            m = match_detections(d_card, d_cpu, score_tol=1e-4)
            det_ok = m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["class_scores"] <= 1e-4
            det_text = (f"{m['matched']} matched by (source proposal, class), {m['reordered']} in another slot, "
                        f"{m['at_cut']} at the cut, boxes max_abs_err={m['boxes']:.3e} px (tol 1e-3), scores "
                        f"{m['scores']:.3e} (tol 1e-4)")
        else:
            d_cpu["upscale"] = torch.as_tensor(batch["orig_sizes"][:, 0] / batch["image_sizes"][:, 0])
            m = match_family_outputs(d_card, d_cpu, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
            det_ok = m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["matched"] > 0
            det_text = (f"{m['matched']} matched by class, box and score, {m['at_cut']} at the cut, {m['suppressed']} "
                        f"suppressed on one side at the NMS threshold; boxes max_abs_err={m['boxes']:.3e} input px "
                        f"(tol 1e-3), scores {m['scores']:.3e} (tol 1e-4)"
                        + (f", mask probabilities {m['masks']:.3e} (tol 1e-4)" if "masks" in d_cpu else ""))

        def rel(a, b):
            return (max(abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-12) for k in b[0]),
                    float((a[1] - b[1]).norm() / b[1].norm()))

        (loss_err, upd_err), (loss_gap, upd_gap) = rel((l_card[0], u_card[0]), (l_cpu[0], u_cpu[0])), rel(
            (l_cpu[0], u_cpu[0]), (l64[0], u64[0]))
        loss_tol, upd_tol = max(1e-4, SURFACE_NOISE * loss_gap), max(WSOD_UPDATE_TOL, SURFACE_NOISE * upd_gap)
        log(f"[c4_trident_fpn] (a) {name} narrow ({cfg.MODEL.ROI_HEADS.NAME}, float32): card vs CPU: detections "
            f"{det_text}; one step: losses rel_err {loss_err:.3e} (tol {loss_tol:.3e}), update L2 norm "
            f"{float(u_cpu[0].norm()):.4g} rel_err {upd_err:.3e} (tol {upd_tol:.3e}); CPU float32 against float64: "
            f"losses {loss_gap:.3e}, update {upd_gap:.3e}; losses "
            + ", ".join(f"{k}={v:.6g}" for k, v in l_cpu[0].items()))
        if not (det_ok and loss_err <= loss_tol and upd_err <= upd_tol and float(u_cpu[0].norm()) > 0
                and all(math.isfinite(v) for v in l_card[0].values())):
            failed.append(name)
    torch.backends.cudnn.deterministic = False
    if failed:
        raise AssertionError(f"c4_trident_fpn narrow checks: the card disagrees with the CPU in {failed}")
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[c4_trident_fpn] (a) launches on the card in these checks (no main path's): {got}")
    if not got[kernels[0].name] or not got[kernels[1].name]:
        raise AssertionError("c4_trident_fpn narrow checks: K1 or K2 never launched on the card")


def c4_stages(family, model, req, measure):
    """One request through a supervised model of phase 22 by stage,
    ``measure`` making each call and returning its reading: the backbone
    (with the request's copy to the card), the RPN head, its decode (top-k,
    NMS); the C4 heads' ``pool`` (K1 on res4), ``res5`` (the three
    bottleneck blocks over every proposal), ``box`` (the predictor and the
    per-class NMS) and the mask branch (the detections pooled again, res5
    again, the mask head); the FPN heads' box branch ``roi_box``."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32

    heads, rpn = model.roi_heads, model.proposal_generator
    r = {}
    readings = {}
    with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
        readings["backbone"] = measure(lambda: r.update(zip(("feats", "sizes"), model._features(req))))
        readings["rpn_head"] = measure(lambda: r.update(zip(("anchors", "logits", "deltas"),
                                                            rpn.head_outputs(r["feats"]))))
        readings["rpn_decode"] = measure(lambda: r.update(zip(("proposals", "scores"), rpn.predict_proposals(
            r["anchors"], r["logits"], r["deltas"], r["sizes"]))))
        if not hasattr(heads, "res5"):
            readings["roi_box"] = measure(lambda: r.update(det=heads.detect(
                r["feats"], r["proposals"], r["scores"], r["sizes"])))
            return readings
        readings["pool"] = measure(lambda: r.update(pooled=heads.pool(r["feats"], r["proposals"])))
        readings["res5"] = measure(lambda: r.update(res5=heads.res5(r["pooled"])))
        readings["box"] = measure(lambda: r.update(det=heads.detections(r["res5"], r["proposals"], r["scores"],
                                                                        r["sizes"])))
        if heads.mask_on:
            readings["mask"] = measure(lambda: heads.forward_with_given_boxes(r["feats"], r["det"]))
    return readings


def c4_serve(kernel):
    """Phase 22(b), the supervised models: C4 Mask R-CNN and the WSR-50 FPN
    at full width (seeded weights, ``random_state_dict``) serve C4_ROUNDS
    800x1344 requests of phase 15 in each of bf16 and f32, in turns, K1
    C4_K1 times a request; then the stage split with its host syncs and
    each stage's peak memory. Returns K1's launches by model and the mean
    latencies."""
    import numpy as np
    import torch

    from jtsm_tpu_torch import config
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model

    rng = np.random.default_rng(22)
    h, w = FLAGSHIP_HW
    warm = request(rng, (h, w), (h, w), (h, w))
    reqs = [request(rng, (h, w), (h, w), (h, w)), request(rng, (h, w), (h - 50, w - 11), (h - 50, w - 11))]
    launches, latency = {}, {}
    for family in C4_SERVED:
        base = getattr(config, C4_BUILDERS[family])()
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        state = random_state_dict(build_model(base, device="cpu"), seed=22)
        predictors, mem = {}, {}
        for d in dtypes:
            c = base.clone()
            c.TPU.COMPUTE_DTYPE = d
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            predictors[d] = Predictor(c, state)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            predictors[d](warm)
            torch.cuda.synchronize()
            mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
        lat = {d: [] for d in dtypes}
        kernel.launches = 0
        for i in range(C4_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                before = kernel.launches
                t0 = time.perf_counter()
                out = predictors[d](reqs[i % 2])
                torch.cuda.synchronize()
                lat[d].append((time.perf_counter() - t0) * 1e3)
                if kernel.launches - before != C4_K1[family]:
                    raise AssertionError(f"c4_trident_fpn {family} {d} request {i}: K1 launched "
                                         f"{kernel.launches - before} times, not {C4_K1[family]}")
                n = base.TEST.DETECTIONS_PER_IMAGE
                want = {"boxes": (1, n, 4), "scores": (1, n), "classes": (1, n), "valid": (1, n)}
                if base.MODEL.MASK_ON:  # the C4 mask head's 14x14 (2 x res5's 7x7)
                    want["masks"] = (1, n, 14, 14)
                if {k: tuple(v.shape) for k, v in out.items()} != want or not all(
                        torch.isfinite(v.float()).all() for v in out.values()):
                    raise AssertionError(f"c4_trident_fpn {family} {d} request {i}: outputs "
                                         f"{ {k: tuple(v.shape) for k, v in out.items()} }, expected {want}")
        launches[family] = kernel.launches
        stage = {d: {} for d in dtypes}
        for i in range(C4_STAGE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                for k, v in c4_stages(family, predictors[d].model, reqs[0], timed_peak).items():
                    stage[d].setdefault(k, []).append(v)
        for d in dtypes:
            syncs = c4_stages(family, predictors[d].model, reqs[0], count_host_syncs)
            latency[(family, d)] = sum(lat[d]) / len(lat[d])
            log(f"[c4_trident_fpn] (b) {TRAIN_TITLES[family]} {h}x{w} {DTYPE_NAMES[d]}"
                f"{' (TF32 off)' if d == 'float32' else ''}, seeded weights (seed 22), {C4_ROUNDS} requests in turns: "
                f"latency_ms={[round(x, 3) for x in lat[d]]} mean_ms={latency[(family, d)]:.3f} "
                f"roi_align_fwd_launches {C4_K1[family]} a request | stages_ms (median of {C4_STAGE_ROUNDS}) "
                + " ".join(f"{k}={median([x['ms'] for x in v]):.3f}" for k, v in stage[d].items())
                + " | stage peak_gib " + " ".join(f"{k}={max(x['peak'] for x in v):.3f}" for k, v in stage[d].items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
                + f" | weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")
        del predictors
    return launches, latency


def c4_trainer(kernels, state):
    """Phase 22(e): C4 Mask R-CNN (bf16, as configured) through
    ``DefaultTrainer`` on C4_TRAINER_SCENES in-memory COCO scenes of
    SCORE_HW, the yaml's train scales and the flip, IMS_PER_BATCH
    TRAIN_BATCH, from phase 22(c)'s seeded weights: K1 and K2 once an
    iteration, every loss finite. Returns the launches and the run."""
    import tempfile

    from jtsm_tpu_torch import config
    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco
    from jtsm_tpu_torch.engine import DefaultTrainer

    name = "chip_smoke_c4_train"
    register_synthetic_coco(name, num=C4_TRAINER_SCENES, seed=4, image_hw=SCORE_HW)
    cfg = config.mask_rcnn_R_50_C4_cfg()
    cfg.DATASETS.TRAIN = (name,)
    cfg.SOLVER.IMS_PER_BATCH = TRAIN_BATCH
    cfg.SOLVER.MAX_ITER = C4_TRAINER_ITERS
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * C4_TRAINER_ITERS
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.WEIGHTS = ""
    cfg.SEED = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_c4_") as tmp:
        cfg.OUTPUT_DIR = tmp
        trainer, rec, got, peak = run_trainer(DefaultTrainer, cfg, kernels, state)
        check_launches("C4 trainer", rec, dict(zip([k.name for k in kernels], TRAIN_K["c4_mask"])))
        metrics = read_metrics(tmp)
        if [m["iteration"] for m in metrics] != list(range(C4_TRAINER_ITERS)) or not all(
                math.isfinite(m[k]) for m in metrics[1:] for k in m if k.startswith("loss")):
            raise AssertionError(f"C4 trainer: metrics.json {metrics[-1]}")
        loader = trainer.data_loader
        run = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                   data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak,
                   loader=loader.busy_seconds / loader.batches, launches=got)
        log(f"[c4_trident_fpn] (e) Mask R-CNN R50-C4 {cfg.TPU.COMPUTE_DTYPE} through DefaultTrainer: "
            f"{C4_TRAINER_SCENES} in-memory COCO scenes {SCORE_HW[0]}x{SCORE_HW[1]}, short sides "
            f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)} (max {cfg.INPUT.MAX_SIZE_TRAIN}) and the flip, IMS_PER_BATCH "
            f"{TRAIN_BATCH}, {C4_TRAINER_ITERS} iterations: s/iter median {run['s_iter']:.4f} data_time median "
            f"{run['data_time']:.4f} loader s/batch {run['loader']:.4f} launches {got} peak_mem_gib {peak:.3f} "
            f"| losses at the last iteration "
            + ", ".join(f"{k}={v:.5g}" for k, v in metrics[-1].items() if k.startswith("loss")))
        del trainer
    return got, run


def phase_c4_trident_fpn(kernels, gen, baseline):
    """Phase 22: the C4 family (Mask R-CNN R50-C4, Faster R-CNN on the
    WS-ResNet-50's res4), Trident OICR on the multi-rate WSR-18 and Faster
    R-CNN on the WSR-50 FPN. (d) K1 and K2 at the C4 res4 pooler and K1 at
    Trident's averaged res5; (a) the four narrow models on the card against
    the CPU; (b) C4 Mask R-CNN and the WSR-50 FPN at 800x1344 and Trident
    OICR at 688x917 served by stage; (c) their train steps (median of
    steps 2-6); (e) C4 Mask R-CNN through ``DefaultTrainer``. The plain
    ROIAlign raises on the card. Returns the kernel rows by site, each
    kernel's launches on (b), (c) and (e), and those of C4 Mask R-CNN,
    Trident and the WSR-50 FPN apart, the latencies, the step times and
    the trainer's run."""
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.modeling import build_model
    from jtsm_tpu_torch.ops import roi_align

    rows = c4_kernel_rows(gen, baseline)
    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 22")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    try:
        c4_narrow_checks(kernels)
        serve_launches, latency = c4_serve(kernels[0])
        train_launches, steps, states = families_full_train(C4_SERVED, kernels, "c4_trident_fpn", "c")
        t0 = time.perf_counter()
        wsr = {"WSR_18": random_state_dict(build_model(wsod_cfg("oicr_WSR_18"), device="cpu"), seed=0)}
        log(f"[c4_trident_fpn] seeded full-width weights of WSR-18 OICR in {time.perf_counter() - t0:.1f}s")
        trd_serve, trd_latency = wsod_serve(kernels[0], wsr, (TRD,), trd_cfg, "c4_trident_fpn", C4_ROUNDS,
                                            C4_STAGE_ROUNDS)
        trd_train, trd_steps, _ = wsod_train(kernels, wsr, (TRD,), trd_cfg, "c4_trident_fpn", FAM_TRAIN_STEPS)
        trainer_launches, trainer = c4_trainer(kernels, states["c4_mask"])
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    names = [k.name for k in kernels]
    by_model = {
        "c4": {n: train_launches["c4_mask"][n] + trainer_launches[n] for n in names},
        "trd": dict(trd_train[TRD]),
        "wsr_fpn": dict(train_launches["wsr_fpn"]),
    }
    by_model["c4"][names[0]] += serve_launches["c4_mask"]
    by_model["trd"][names[0]] += trd_serve[TRD]
    by_model["wsr_fpn"][names[0]] += serve_launches["wsr_fpn"]
    launches = {n: sum(m[n] for m in by_model.values()) for n in names}
    return rows, launches, by_model, {**latency, **trd_latency}, {**steps, **trd_steps}, trainer


# ---------------------------------------------------------------------------
# Phase 23: Cascade R-CNN, the deformable ResNet and Fast R-CNN
# ---------------------------------------------------------------------------

# the models of phase 23: their Python builders and titles, K1's launches a
# request (the cascade pools its boxes once a stage, then the detections
# for the mask head; the dconv Mask R-CNN boxes and masks; Fast R-CNN its
# proposals) and (K1, K2) a train step (three box stages and the mask
# branch; boxes and masks; boxes)
CASCADE_BUILDERS = {"cascade": "cascade_mask_rcnn_R_50_FPN_cfg", "dconv": "mask_rcnn_R_50_FPN_dconv_cfg",
                    "fast_rcnn": "fast_rcnn_R_50_FPN_cfg"}
CASCADE_K1 = {"cascade": 4, "dconv": 2, "fast_rcnn": 1}
CASCADE_STAGE_LOSSES = [f"{k}_stage{s}" for s in range(3) for k in ("loss_box_reg", "loss_cls")]
TRAIN_K.update(cascade=(4, 4), dconv=(2, 2), fast_rcnn=(1, 1))
TRAIN_LOSSES.update(cascade=CASCADE_STAGE_LOSSES + ["loss_mask", "loss_rpn_cls", "loss_rpn_loc"],
                    dconv=MASK_RCNN_LOSSES, fast_rcnn=["loss_box_reg", "loss_cls"])
TRAIN_TITLES.update(cascade="Cascade Mask R-CNN R50-FPN", dconv="Mask R-CNN R50-FPN dconv c3-c5",
                    fast_rcnn="Fast R-CNN R50-FPN")
FAM_NARROW_LR.update(cascade=2e-4, dconv=2e-4, fast_rcnn=2e-4)
# the combined yamls of 23(f): their Python builders and K1's launches a request
COMBINED_BUILDERS = {"X-152 32x8d GN dconv cascade": "cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv_cfg",
                     "Panoptic FPN R-101 dconv cascade GN": "panoptic_fpn_R_101_dconv_cascade_gn_cfg"}
CASCADE_ROUNDS = 4  # requests in each dtype
CASCADE_STAGE_ROUNDS = 1
CASCADE_TRAINER_SCENES = 8
CASCADE_TRAINER_ITERS = 6  # the iteration timer starts after 3
# seeded weights' gains: each box classifier and regressor (the cascade's
# third stage keeps foreground at IoU 0.7, and no softmax saturates) and each
# deformable block's offset kernel (at 1/sqrt(fan-in) a seeded ResNet's
# offsets reach tens of pixels and nearly every tap samples off the map; at
# 0.05 of it they are a few, as a trained model's)
CASCADE_GAINS = {"cls_score.weight": 0.05, "bbox_pred.weight": 0.05, "conv2_offset.weight": 0.05}


def cascade_cfg(name):
    """A combined yaml's full-width config (23(f)), from its builder."""
    from jtsm_tpu_torch import config

    return getattr(config, COMBINED_BUILDERS[name])()


def gained(state):
    """``state`` with CASCADE_GAINS applied."""
    return {k: v * next((g for s, g in CASCADE_GAINS.items() if k.endswith(s)), 1.0) for k, v in state.items()}


def seeded_proposals(rng, image_sizes, k, gt_boxes=None, gt_valid=None):
    """``k`` proposal slots an image, as a precomputed proposal file gives
    them: each valid ground truth box jittered four times (by 5% of its
    size), then boxes of 16-512 px (log-uniform) inside the image; the
    scores descending. Returns (B, k, 4) and (B, k) float32."""
    import numpy as np

    b = len(image_sizes)
    boxes = np.zeros((b, k, 4), np.float32)
    for i, (h, w) in enumerate(image_sizes):
        jit = np.zeros((0, 4))
        if gt_boxes is not None:
            g = gt_boxes[i][gt_valid[i]]
            size = np.concatenate([g[:, 2:] - g[:, :2]] * 2, 1)
            jit = np.concatenate([g + rng.normal(0, 0.05, g.shape) * size for _ in range(4)])[:k]
        n = k - len(jit)
        wh = np.exp(rng.uniform(np.log(16), np.log(512), (n, 2)))
        xy = rng.uniform(0, 1, (n, 2)) * np.maximum([w, h] - wh, 1)
        boxes[i] = np.clip(np.concatenate([jit, np.concatenate([xy, xy + wh], 1)]), 0, [w, h, w, h])
    scores = np.sort(rng.normal(size=(b, k)), axis=1)[:, ::-1]
    return boxes, np.ascontiguousarray(scores, dtype=np.float32)


class DeformTimer:
    """CUDA events around each deformable convolution of ``model``, forward
    and (in a train step) backward, recorded as the stream reaches them (no
    host sync), and the shapes of their products: ``read()`` after a
    synchronize gives the milliseconds of each and the product shapes
    (rows, K*K*Cin, Cout) for ``product_ms``."""

    def __init__(self, model):
        import torch

        from jtsm_tpu_torch.layers import DeformConv

        self.events = {"fwd": [], "bwd": []}
        self.products = []
        self.handles = []
        for m in model.modules():
            if not isinstance(m, DeformConv):
                continue

            def pre(mod, args):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events["fwd"].append([e])
                x = args[0]
                o, i, k, _ = mod.weight.shape
                self.products.append((x.shape[0] * x.shape[2] * x.shape[3], k * k * i, o))

            def post(mod, args, out):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events["fwd"][-1].append(e)

            def bwd_pre(mod, grad_out):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events["bwd"].append([e])

            def bwd_post(mod, grad_in, grad_out):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                self.events["bwd"][-1].append(e)

            self.handles += [m.register_forward_pre_hook(pre), m.register_forward_hook(post),
                             m.register_full_backward_pre_hook(bwd_pre), m.register_full_backward_hook(bwd_post)]

    def reset(self):
        self.events = {"fwd": [], "bwd": []}
        self.products = []

    def read(self):
        return {k: sum(a.elapsed_time(b) for a, b in v if b is not None) for k, v in self.events.items()}

    def remove(self):
        for h in self.handles:
            h.remove()


def product_ms(products, backward):
    """The device milliseconds of the deformable convolutions' matrix
    products alone (float32, as they run) at these shapes: one product
    each in a forward, two more (the columns' and the kernel's gradients)
    with ``backward``."""
    import torch

    total = 0.0
    for rows, depth, out in sorted(set(products)):
        n = products.count((rows, depth, out))
        a = torch.randn((rows, depth), device=DEVICE)
        w = torch.randn((depth, out), device=DEVICE)
        g = torch.randn((rows, out), device=DEVICE)
        total += n * cuda_time_ms(lambda: a @ w, 5, queued=True)
        if backward:
            total += n * (cuda_time_ms(lambda: g @ w.T, 5, queued=True) + cuda_time_ms(lambda: a.T @ g, 5, queued=True))
        del a, w, g
    return total


def cascade_narrow_checks(kernels):
    """Phase 23(a): the narrow cascade, dconv Mask R-CNN and Fast R-CNN
    (``train_family_cfg``'s sampling: every anchor and proposal a slot, so
    that no draw decides a loss; the ROI heads of the RPN models on the CPU's
    proposals, ``shared_proposals``; Fast R-CNN on seeded proposals) on the
    card against this machine's CPU: a request's detections (matched by
    class, box and score), the dconv backbone's FPN maps, and one train step
    (no clip) whose per-stage losses and update lie within max(1e-4 and
    WSOD_UPDATE_TOL, SURFACE_NOISE x the CPU's float32-to-float64 gap):
    phase 20(a)'s rule. These launches count in no main path's total."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.modeling import build_model

    before = [k.launches for k in kernels]
    failed = []
    torch.backends.cudnn.deterministic = True
    for name in CASCADE_BUILDERS:
        cfg = train_family_cfg(name, narrow=True)
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0  # random weights score below 0.05
        batch = family_train_batch(cfg, 11, 2, FAM_NARROW_HW, cfg.TPU.MAX_GT_INSTANCES, 3)
        batch["orig_sizes"] = np.array([[256, 352], [128, 176]], np.int32)
        weights = gained(random_state_dict(build_model(cfg, device="cpu"), seed=1))
        runs, recorded = {}, {}
        for device, f64 in (("cpu", False), (DEVICE, False), ("cpu", True)):
            model = build_model(cfg, device=device)
            model.load_state_dict(weights)
            if f64:
                float64_model(model)
            if model.proposal_generator is not None:
                shared_proposals(model, recorded)
            with torch.no_grad(), exact_float32():
                feats = {k: v.double().cpu() for k, v in model._features(
                    {k: v.astype(np.float64) if f64 and v.dtype == np.float32 else v
                     for k, v in batch.items()})[0].items()}
            det = None if f64 else {k: v.cpu() for k, v in model.inference(batch).items()}
            runs[(device, f64)] = (det, feats, *steps_and_updates(cfg, model, batch, 1))
            del model
        (d_card, f_card, l_card, u_card), (d_cpu, f_cpu, l_cpu, u_cpu), (_, f64s, l64, u64) = (
            runs[(DEVICE, False)], runs[("cpu", False)], runs[("cpu", True)])
        d_cpu["upscale"] = torch.as_tensor(batch["orig_sizes"][:, 0] / batch["image_sizes"][:, 0])
        m = match_family_outputs(d_card, d_cpu, cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
        det_ok = m["boxes"] <= 1e-3 and m["scores"] <= 1e-4 and m["masks"] <= 1e-4 and m["matched"] > 0

        def gap(a, b):
            return max(float((a[k] - b[k]).abs().max() / b[k].abs().max()) for k in b)

        feat_err, feat_gap = gap(f_card, f_cpu), gap(f_cpu, f64s)
        feat_tol = max(1e-4, SURFACE_NOISE * feat_gap)

        def rel(a, b):
            return (max(abs(a[0][k] - b[0][k]) / max(abs(b[0][k]), 1e-12) for k in b[0]),
                    float((a[1] - b[1]).norm() / b[1].norm()))

        (loss_err, upd_err), (loss_gap, upd_gap) = rel((l_card[0], u_card[0]), (l_cpu[0], u_cpu[0])), rel(
            (l_cpu[0], u_cpu[0]), (l64[0], u64[0]))
        loss_tol, upd_tol = max(1e-4, SURFACE_NOISE * loss_gap), max(WSOD_UPDATE_TOL, SURFACE_NOISE * upd_gap)
        log(f"[cascade_dconv] (a) {name} narrow ({cfg.MODEL.ROI_HEADS.NAME}, float32): card vs CPU: detections "
            f"{m['matched']} matched by class, box and score, {m['at_cut']} at the cut, {m['suppressed']} "
            f"suppressed on one side at the NMS threshold; boxes max_abs_err={m['boxes']:.3e} input px (tol 1e-3), "
            f"scores {m['scores']:.3e} (tol 1e-4)" + (f", mask probabilities {m['masks']:.3e} (tol 1e-4)"
                                                      if "masks" in d_cpu else "")
            + f"; FPN maps rel_err {feat_err:.3e} (tol {feat_tol:.3e}); one step: losses rel_err {loss_err:.3e} "
            f"(tol {loss_tol:.3e}), update L2 norm {float(u_cpu[0].norm()):.4g} rel_err {upd_err:.3e} (tol "
            f"{upd_tol:.3e}); CPU float32 against float64: maps {feat_gap:.3e}, losses {loss_gap:.3e}, update "
            f"{upd_gap:.3e}; losses " + ", ".join(f"{k}={v:.6g}" for k, v in l_cpu[0].items()))
        if not (det_ok and feat_err <= feat_tol and loss_err <= loss_tol and upd_err <= upd_tol
                and float(u_cpu[0].norm()) > 0 and all(math.isfinite(v) and v > 0 for v in l_card[0].values())):
            failed.append(name)
    torch.backends.cudnn.deterministic = False
    if failed:
        raise AssertionError(f"cascade_dconv narrow checks: the card disagrees with the CPU in {failed}")
    got = {k.name: k.launches - n for k, n in zip(kernels, before)}
    log(f"[cascade_dconv] (a) launches on the card in these checks (no main path's): {got}")
    if not got[kernels[0].name] or not got[kernels[1].name]:
        raise AssertionError("cascade_dconv narrow checks: K1 or K2 never launched on the card")


def cascade_stages(family, model, req, measure, keep=None):
    """One request through a model of phase 23 by stage, ``measure`` making
    each call and returning its reading: the backbone (with the request's
    copy to the card), the RPN head and its decode (or Fast R-CNN's
    proposals from the request), then the cascade's ``stage0``-``stage2``
    (each K1 on the current boxes, its head, the decode) and ``nms`` (the
    mean probabilities, per-class NMS), or the box branch ``roi_box``; the
    mask branch. ``keep`` receives the boxes each cascade stage pools."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32

    heads, rpn = model.roi_heads, model.proposal_generator
    r = {}
    readings = {}
    with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
        readings["backbone"] = measure(lambda: r.update(zip(("feats", "sizes"), model._features(req))))
        if rpn is None:
            readings["proposals"] = measure(lambda: r.update(zip(("proposals", "scores"), model.batch_proposals(req))))
        else:
            readings["rpn_head"] = measure(lambda: r.update(zip(("anchors", "logits", "deltas"),
                                                                rpn.head_outputs(r["feats"]))))
            readings["rpn_decode"] = measure(lambda: r.update(zip(("proposals", "scores"), rpn.predict_proposals(
                r["anchors"], r["logits"], r["deltas"], r["sizes"]))))
        if family == "cascade":
            r.update(boxes=r["proposals"], probs=[])

            def stage(s):
                if keep is not None:
                    keep[s] = r["boxes"].detach().clone()
                p, r["boxes"] = heads.run_stage(s, [r["feats"][f] for f in heads.in_features], r["boxes"],
                                                r["sizes"])
                r["probs"].append(p)

            for s in range(heads.num_stages):
                readings[f"stage{s}"] = measure(lambda s=s: stage(s))
            readings["nms"] = measure(lambda: r.update(det=heads.combine(r["probs"], r["boxes"], r["scores"],
                                                                         r["sizes"])))
        else:
            readings["roi_box"] = measure(lambda: r.update(det=heads.detect(r["feats"], r["proposals"], r["scores"],
                                                                            r["sizes"])))
        if heads.mask_on:
            readings["mask"] = measure(lambda: heads.forward_with_given_boxes(r["feats"], r["det"]))
    return readings


def cascade_request(family, rng, hw, true_hw, cfg):
    """Phase 15's request; Fast R-CNN's with PRECOMPUTED_PROPOSAL_TOPK_TEST
    seeded proposals (``seeded_proposals``)."""
    req = request(rng, hw, true_hw, true_hw)
    if cfg.MODEL.LOAD_PROPOSALS:
        req["proposals"], req["proposal_scores"] = seeded_proposals(rng, req["image_sizes"],
                                                                    cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)
    return req


def cascade_serve(kernel, keep):
    """Phase 23(b): the cascade, the dconv Mask R-CNN and Fast R-CNN at full
    width (seeded weights, ``random_state_dict`` with CASCADE_GAINS) serve
    CASCADE_ROUNDS 800x1344 requests in each of bf16 and f32, in turns, K1
    CASCADE_K1 times a request; then the stage split with its host syncs
    and each stage's peak memory, and the dconv model's deformable
    convolutions timed inside its requests (CUDA events) with their
    products' share. ``keep`` receives the cascade's stage inputs of its
    f32 stage split. Returns K1's launches by model and the mean latencies."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model

    rng = np.random.default_rng(23)
    h, w = FLAGSHIP_HW
    launches, latency = {}, {}
    for family in CASCADE_BUILDERS:
        base = train_family_cfg(family)
        warm = cascade_request(family, rng, (h, w), (h, w), base)
        reqs = [cascade_request(family, rng, (h, w), (h, w), base),
                cascade_request(family, rng, (h, w), (h - 50, w - 11), base)]
        dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
        state = gained(random_state_dict(build_model(base, device="cpu"), seed=23))
        predictors, mem = {}, {}
        for d in dtypes:
            c = base.clone()
            c.TPU.COMPUTE_DTYPE = d
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            predictors[d] = Predictor(c, state)
            torch.cuda.synchronize()
            resident = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            predictors[d](warm)
            torch.cuda.synchronize()
            mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
        timers = {d: DeformTimer(predictors[d].model) for d in dtypes} if family == "dconv" else {}
        lat, deform = {d: [] for d in dtypes}, {d: [] for d in dtypes}
        kernel.launches = 0
        for i in range(CASCADE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                before = kernel.launches
                if d in timers:
                    timers[d].reset()
                t0 = time.perf_counter()
                out = predictors[d](reqs[i % 2])
                torch.cuda.synchronize()
                lat[d].append((time.perf_counter() - t0) * 1e3)
                if d in timers:
                    deform[d].append(timers[d].read()["fwd"])
                if kernel.launches - before != CASCADE_K1[family]:
                    raise AssertionError(f"cascade_dconv {family} {d} request {i}: K1 launched "
                                         f"{kernel.launches - before} times, not {CASCADE_K1[family]}")
                n = base.TEST.DETECTIONS_PER_IMAGE
                want = {"boxes": (1, n, 4), "scores": (1, n), "classes": (1, n), "valid": (1, n)}
                if base.MODEL.MASK_ON:
                    want["masks"] = (1, n, 28, 28)
                if {k: tuple(v.shape) for k, v in out.items()} != want or not all(
                        torch.isfinite(v.float()).all() for v in out.values()):
                    raise AssertionError(f"cascade_dconv {family} {d} request {i}: outputs "
                                         f"{ {k: tuple(v.shape) for k, v in out.items()} }, expected {want}")
        launches[family] = kernel.launches
        products = {d: list(t.products) for d, t in timers.items()}
        for t in timers.values():
            t.remove()
        stage = {d: {} for d in dtypes}
        for i in range(CASCADE_STAGE_ROUNDS):
            for d in dtypes if i % 2 == 0 else dtypes[::-1]:
                got = cascade_stages(family, predictors[d].model, reqs[0], timed_peak,
                                     keep if d == "float32" and family == "cascade" else None)
                for k, v in got.items():
                    stage[d].setdefault(k, []).append(v)
        for d in dtypes:
            syncs = cascade_stages(family, predictors[d].model, reqs[0], count_host_syncs)
            latency[(family, d)] = sum(lat[d]) / len(lat[d])
            text = ""
            if family == "dconv":
                dms = median(deform[d])
                pms = product_ms(products[d], backward=False)
                text = (f" | deformable convs ({len(products[d])} a request) device_ms median {dms:.3f} "
                        f"({dms / median(lat[d]) * 100:.1f}% of the request), of it their products {pms:.3f} ms, "
                        f"the bilinear gather and the rest {dms - pms:.3f} ms "
                        f"({(dms - pms) / median(lat[d]) * 100:.1f}% of the request)")
            log(f"[cascade_dconv] (b) {TRAIN_TITLES[family]} {h}x{w} {DTYPE_NAMES[d]}"
                f"{' (TF32 off)' if d == 'float32' else ''}, seeded weights (seed 23), {CASCADE_ROUNDS} requests "
                f"in turns: latency_ms={[round(x, 3) for x in lat[d]]} mean_ms={latency[(family, d)]:.3f} "
                f"roi_align_fwd_launches {CASCADE_K1[family]} a request | stages_ms (median of "
                f"{CASCADE_STAGE_ROUNDS}) "
                + " ".join(f"{k}={median([x['ms'] for x in v]):.3f}" for k, v in stage[d].items())
                + " | stage peak_gib " + " ".join(f"{k}={max(x['peak'] for x in v):.3f}" for k, v in stage[d].items())
                + " | host syncs " + " ".join(f"{k}={n}" for k, n in syncs.items())
                + f" | weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}" + text)
        del predictors
    return launches, latency


def dconv_step_share(family, d, run, batch):
    """``families_full_train``'s hook for 23(c): two more steps of the dconv
    model with its deformable convolutions timed (forward and backward,
    CUDA events) beside the step, and their products' share."""
    import torch

    if family != "dconv":
        return
    model, _, _, state, step = run
    timer = DeformTimer(model)
    shares = []
    for _ in range(2):
        timer.reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batch)
        torch.cuda.synchronize()
        shares.append(((time.perf_counter() - t0) * 1e3, timer.read()))
    products = list(timer.products)
    timer.remove()
    step_ms, ev = shares[-1]
    pms = product_ms(products, backward=True)
    total = ev["fwd"] + ev["bwd"]
    log(f"[cascade_dconv] (c) {TRAIN_TITLES[family]} train {DTYPE_NAMES[d]}: deformable convs ({len(products)} a "
        f"step) device_ms forward {ev['fwd']:.3f} backward {ev['bwd']:.3f} in a {step_ms:.3f} ms step "
        f"({total / step_ms * 100:.1f}%), of it their products (three a conv) {pms:.3f} ms, the bilinear gather, "
        f"its scatter-add backward and the rest {total - pms:.3f} ms ({(total - pms) / step_ms * 100:.1f}% of the "
        f"step)")


def cascade_kernel_rows(gen, baseline, stage_boxes, fast_boxes):
    """Phase 23(d): K1 and K2 against their plain versions at the new
    launch sites, in float32 and bfloat16, over an 800x1344 pyramid (C=256):
    the cascade's stage-1 and stage-2 pools (the boxes the f32 stage split
    of 23(b) decoded, R=1000, P=7), a cascade train step's box pool (B=2,
    2x512 rows, P=7, with K2; three a step) and Fast R-CNN's pool of 1000
    seeded precomputed proposals. Returns the rows by site."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    rows = {"stage": {}, "step": {}, "fast": {}}
    scales = [1.0 / s for s in LEVEL_STRIDES]
    for dtype in (torch.float32, torch.bfloat16):
        tag = dtype_tag(torch.empty(0, dtype=dtype))
        pyr = flagship_pyramid(gen, dtype=dtype)
        for s in (1, 2):
            boxes = stage_boxes[s].reshape(-1, 4).float().contiguous()
            bidx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=DEVICE)
            rows["stage"][f"fwd stage{s} {tag}"] = check_and_time_fwd(
                f"cascade stage {s} {tag} (decoded boxes)", pyr, scales, boxes, bidx,
                assign_boxes_to_levels(boxes, 2, 5), 7, baseline, "cascade_dconv")
        boxes = torch.as_tensor(fast_boxes.reshape(-1, 4), device=DEVICE).contiguous()
        bidx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=DEVICE)
        rows["fast"][f"fwd {tag}"] = check_and_time_fwd(
            f"Fast R-CNN {tag} (precomputed proposals)", pyr, scales, boxes, bidx,
            assign_boxes_to_levels(boxes, 2, 5), 7, baseline, "cascade_dconv")
        del pyr
        pyr2 = flagship_pyramid(gen, dtype=dtype, batch=TRAIN_BATCH)
        boxes = spread_boxes(gen, TRAIN_BATCH * 512)
        bidx = torch.arange(TRAIN_BATCH, device=DEVICE, dtype=torch.int32).repeat_interleave(512)
        levels = assign_boxes_to_levels(boxes, 2, 5)
        site = f"cascade train stage {tag} B={TRAIN_BATCH} R={TRAIN_BATCH}x512"
        rows["step"][f"fwd {tag}"] = check_and_time_fwd(site, pyr2, scales, boxes, bidx, levels, 7, baseline,
                                                        "cascade_dconv")
        rows["step"][f"bwd {tag}"] = check_and_time_bwd(site, pyr2, scales, boxes, bidx, levels, 7, gen, baseline,
                                                        "cascade_dconv")
        del pyr2
    return rows


def cascade_trainer(kernels, state):
    """Phase 23(e): the cascade (bf16, as configured) through
    ``DefaultTrainer`` on CASCADE_TRAINER_SCENES in-memory COCO scenes of
    SCORE_HW, the yaml's train scales and the flip, IMS_PER_BATCH
    TRAIN_BATCH, from 23(c)'s seeded weights: K1 and K2 four times an
    iteration, every loss finite. Returns the launches and the run."""
    import tempfile

    from jtsm_tpu_torch.data.datasets.synthetic import register_synthetic_coco
    from jtsm_tpu_torch.engine import DefaultTrainer

    name = "chip_smoke_cascade_train"
    register_synthetic_coco(name, num=CASCADE_TRAINER_SCENES, seed=5, image_hw=SCORE_HW)
    cfg = train_family_cfg("cascade")
    cfg.DATASETS.TRAIN = (name,)
    cfg.SOLVER.IMS_PER_BATCH = TRAIN_BATCH
    cfg.SOLVER.MAX_ITER = CASCADE_TRAINER_ITERS
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * CASCADE_TRAINER_ITERS
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.WEIGHTS = ""
    cfg.SEED = 0
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cascade_") as tmp:
        cfg.OUTPUT_DIR = tmp
        trainer, rec, got, peak = run_trainer(DefaultTrainer, cfg, kernels, state)
        check_launches("cascade trainer", rec, dict(zip([k.name for k in kernels], TRAIN_K["cascade"])))
        metrics = read_metrics(tmp)
        if [m["iteration"] for m in metrics] != list(range(CASCADE_TRAINER_ITERS)) or not all(
                math.isfinite(m[k]) for m in metrics[1:] for k in m if k.startswith("loss")):
            raise AssertionError(f"cascade trainer: metrics.json {metrics[-1]}")
        loader = trainer.data_loader
        run = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                   data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak,
                   loader=loader.busy_seconds / loader.batches, launches=got)
        log(f"[cascade_dconv] (e) Cascade Mask R-CNN R50-FPN {cfg.TPU.COMPUTE_DTYPE} through DefaultTrainer: "
            f"{CASCADE_TRAINER_SCENES} in-memory COCO scenes {SCORE_HW[0]}x{SCORE_HW[1]}, short sides "
            f"{tuple(cfg.INPUT.MIN_SIZE_TRAIN)} (max {cfg.INPUT.MAX_SIZE_TRAIN}) and the flip, IMS_PER_BATCH "
            f"{TRAIN_BATCH}, {CASCADE_TRAINER_ITERS} iterations: s/iter median {run['s_iter']:.4f} data_time median "
            f"{run['data_time']:.4f} loader s/batch {run['loader']:.4f} launches {got} peak_mem_gib {peak:.3f} "
            f"| losses at the last iteration "
            + ", ".join(f"{k}={v:.5g}" for k, v in metrics[-1].items() if k.startswith("loss")))
        del trainer
    return got, run


def combined_requests(kernel):
    """Phase 23(f): the two combined yamls at full width in bf16 (weights
    from the JAX package's initialisers under ``torch.manual_seed(23)``: the
    offset kernels zero, as detectron2 and the JAX package start them), a
    warm-up request and one timed 800x1344 request each: K1 four times a
    request (three stages and the masks), every output finite. Returns K1's
    launches and the latencies."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.modeling import build_model

    rng = np.random.default_rng(24)
    h, w = FLAGSHIP_HW
    launches, latency = 0, {}
    for name in COMBINED_BUILDERS:
        cfg = cascade_cfg(name)
        torch.manual_seed(23)
        t0 = time.perf_counter()
        model = build_model(cfg)
        build_s = time.perf_counter() - t0
        params = sum(p.numel() for p in model.parameters())
        req = request(rng, (h, w), (h, w), (h, w))
        before = kernel.launches
        model.inference(req)  # warm-up
        torch.cuda.synchronize()
        warm = kernel.launches - before
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = model.inference(req)
        torch.cuda.synchronize()
        latency[name] = (time.perf_counter() - t0) * 1e3
        got = kernel.launches - before - warm
        launches += kernel.launches - before
        finite = all(torch.isfinite(v.float()).all() for v in out.values() if torch.is_tensor(v))
        log(f"[cascade_dconv] (f) {name} ({cfg.TPU.COMPUTE_DTYPE}, {params / 1e6:.1f}M parameters, built in "
            f"{build_s:.1f}s) {h}x{w}: request_ms={latency[name]:.3f} peak_gib "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} K1 launches {got} outputs "
            + " ".join(f"{k}{tuple(v.shape)}" for k, v in out.items() if torch.is_tensor(v))
            + f" valid {int(out['valid'].sum())}")
        if got != 4 or warm != 4 or not finite or type(model.roi_heads).__name__ != "CascadeROIHeads":
            raise AssertionError(f"cascade_dconv {name}: K1 launched {got} times (not 4) or outputs not finite")
        del model, out
    return launches, latency


def phase_cascade_dconv(kernels, gen, baseline):
    """Phase 23: Cascade Mask R-CNN, the dconv Mask R-CNN and Fast R-CNN.
    (a) the three narrow models on the card against the CPU; (b) each at
    800x1344 served by stage (the dconv model's deformable convolutions
    timed); (d) K1 and K2 at the cascade's stage pools, its train step and
    Fast R-CNN's proposals; (c) their train steps (median of steps 2-6, the
    dconv step's deformable share); (e) the cascade through
    ``DefaultTrainer``; (f) the X-152 and Panoptic FPN R-101 dconv cascades,
    one bf16 request each. The plain ROIAlign raises on the card. Returns
    the kernel rows by site, each kernel's launches on (b), (c), (e) and (f),
    those by model, the latencies, the step times and the trainer's run."""
    import numpy as np

    from jtsm_tpu_torch.ops import roi_align

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 23")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    keep = {}
    try:
        cascade_narrow_checks(kernels)
        serve_launches, latency = cascade_serve(kernels[0], keep)
        fast = seeded_proposals(np.random.default_rng(25), [FLAGSHIP_HW],
                                train_family_cfg("fast_rcnn").DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)[0]
        rows = cascade_kernel_rows(gen, baseline, keep, fast)
        train_launches, steps, states = families_full_train(tuple(CASCADE_BUILDERS), kernels, "cascade_dconv", "c",
                                                            after=dconv_step_share)
        trainer_launches, trainer = cascade_trainer(kernels, states["cascade"])
        combined_launches, combined_latency = combined_requests(kernels[0])
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    names = [k.name for k in kernels]
    by_model = {f: dict(train_launches[f]) for f in CASCADE_BUILDERS}
    for f in CASCADE_BUILDERS:
        by_model[f][names[0]] += serve_launches[f]
    for n in names:
        by_model["cascade"][n] += trainer_launches[n]
    by_model["combined"] = {names[0]: combined_launches, names[1]: 0}
    launches = {n: sum(m[n] for m in by_model.values()) for n in names}
    return rows, launches, by_model, latency, combined_latency, steps, trainer


LVIS_CITY_BUILDERS = {"lvis": "mask_rcnn_R_50_FPN_lvis_cfg", "city": "mask_rcnn_R_50_FPN_cityscapes_cfg"}
CITY_HW = (1024, 2048)  # a Cityscapes image
LVIS_CITY_HW = {"lvis": FLAGSHIP_HW, "city": CITY_HW}
TRAIN_K.update(lvis=(2, 2), city=(2, 2))
TRAIN_LOSSES.update(lvis=MASK_RCNN_LOSSES, city=MASK_RCNN_LOSSES)
TRAIN_TITLES.update(lvis="Mask R-CNN R50-FPN LVIS v1 (1203 classes)", city="Mask R-CNN R50-FPN Cityscapes (8 classes)")
LVIS_CITY_ROUNDS = 4  # requests in each dtype
LVIS_CITY_STAGE_ROUNDS = 1
LVIS_CITY_TRAINER_SCENES = {"lvis": 8, "city": 4}
LVIS_CITY_TRAINER_ITERS = 5  # the iteration timer starts after 3
LVIS_CITY_GATE_SCENES = 8  # the Mask R-CNN gate's scenes (seed 0), which it was trained on
LVIS_CITY_AP_TOL = 0.02  # phase 9's: the card's AP against the CPU's


def lvis_city_stages(model, req, measure):
    """One request through a Mask R-CNN by stage, ``measure`` making each
    call and returning its reading: the backbone (with the request's copy to
    the card), the RPN head and its decode, ``box`` (K1 over every proposal
    and the box head), ``sort`` (softmax, decode and clip per class, the
    threshold and the top 1024 of the R*K (proposal, class) candidates),
    ``nms`` (class-aware NMS, the top DETECTIONS_PER_IMAGE) and ``mask`` (K1
    over the detections, the mask head). Returns the readings and the
    outputs (``r``)."""
    import torch

    from jtsm_tpu_torch.layers import exact_float32
    from jtsm_tpu_torch.modeling.roi_heads.fast_rcnn import fast_rcnn_candidates, fast_rcnn_select

    heads, rpn = model.roi_heads, model.proposal_generator
    r, readings = {}, {}
    with torch.no_grad(), exact_float32(model.compute_dtype == torch.float32):
        readings["backbone"] = measure(lambda: r.update(zip(("feats", "sizes"), model._features(req))))
        readings["rpn_head"] = measure(lambda: r.update(zip(("anchors", "logits", "deltas"),
                                                            rpn.head_outputs(r["feats"]))))
        readings["rpn_decode"] = measure(lambda: r.update(zip(("proposals", "prop_scores"), rpn.predict_proposals(
            r["anchors"], r["logits"], r["deltas"], r["sizes"]))))
        readings["box"] = measure(lambda: r.update(zip(("cls", "box_deltas"),
                                                       heads.box_outputs(r["feats"], r["proposals"]))))
        readings["sort"] = measure(lambda: r.update(cand=fast_rcnn_candidates(
            r["cls"], r["box_deltas"], r["proposals"], torch.isfinite(r["prop_scores"]), r["sizes"],
            heads.box2box_transform, heads.num_classes, heads.score_thresh)))
        readings["nms"] = measure(lambda: r.update(det=fast_rcnn_select(
            *r["cand"][:3], heads.nms_thresh, heads.detections_per_image, cand_idx=r["cand"][3])))
        readings["mask"] = measure(lambda: r["det"].update(heads.forward_with_given_boxes(r["feats"], r["det"])))
    return readings, r


def lvis_city_card_against_cpu(family, state, req):
    """24(a) and 24(d): one float32 request of the full-width model on the
    card and on this machine's CPU, the ROI heads of both on the card's
    proposals (``shared_proposals``' reason): the box head's class
    probabilities within 1e-4 of their scale, then the detections matched by their (proposal, class)
    pair (``match_family_outputs`` with the pair as the class: a pair on one
    side only must score at the cut of the 1024 candidates or of the
    DETECTIONS_PER_IMAGE kept), boxes within 1e-3 input px, scores within
    1e-4 of their scale, masks within 1e-4. At seeded weights nearly every
    one of the R*K candidates passes SCORE_THRESH_TEST 0.0001 with nearly
    equal scores, so the cut is crowded."""
    import torch

    from jtsm_tpu_torch.modeling import build_model

    cfg = train_family_cfg(family)
    cfg.TPU.COMPUTE_DTYPE = "float32"
    runs = {}
    proposals = None
    for device in (DEVICE, "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(state)
        model.eval()

        def measure(fn):
            fn()

        if proposals is not None:
            rpn = model.proposal_generator
            predict = rpn.predict_proposals
            rpn.predict_proposals = lambda *a, **k: tuple(t.to(device) for t in proposals)
        t0 = time.perf_counter()
        _, r = lvis_city_stages(model, req, measure)
        if device != "cpu":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        if proposals is None:
            proposals = (r["proposals"].cpu(), r["prop_scores"].cpu())
        else:
            rpn.predict_proposals = predict
        det = {k: v.cpu() for k, v in r["det"].items()}
        probs = torch.softmax(r["cls"].float(), -1).cpu()
        runs[device] = (det, probs, seconds, int(torch.isfinite(r["cand"][0]).sum()))
        del model, r
    (card, p_card, s_card, n_card), (host, p_cpu, s_cpu, n_cpu) = runs[DEVICE], runs["cpu"]
    prob_scale = float(p_cpu.abs().max())
    prob_err = float((p_card - p_cpu).abs().max()) / prob_scale
    host["upscale"] = torch.as_tensor(req["orig_sizes"][:, 0] / req["image_sizes"][:, 0])
    paired = [dict(d, classes=d["pairs"]) for d in (card, host)]
    m = match_family_outputs(paired[0], paired[1], cfg.MODEL.ROI_HEADS.NMS_THRESH_TEST)
    n = cfg.TEST.DETECTIONS_PER_IMAGE
    log(f"[lvis_city] ({'a' if family == 'lvis' else 'd'}) {TRAIN_TITLES[family]} {req['image_sizes'][0].tolist()} "
        f"f32 (TF32 off), one request, the card against the CPU ({s_cpu:.1f}s there) on the card's proposals: "
        f"class probabilities max_err={prob_err:.3e} of their scale {prob_scale:.4f} (tol 1e-4); candidates above SCORE_THRESH_TEST "
        f"{cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST} kept {n_card} / {n_cpu} of {p_card.shape[1]}x"
        f"{p_card.shape[2] - 1}; detections ({n} slots) {m['matched']} matched by (proposal, class), "
        f"{m['at_cut']} at the cut, {m['suppressed']} suppressed on one side at the NMS threshold; boxes "
        f"max_abs_err={m['boxes']:.3e} input px (tol 1e-3), scores {m['scores']:.3e} (tol 1e-4), mask "
        f"probabilities {m['masks']:.3e} (tol 1e-4)")
    if not (prob_err <= 1e-4 and m["matched"] >= n // 2 and m["boxes"] <= 1e-3 and m["scores"] <= 1e-4
            and m["masks"] <= 1e-4):
        raise AssertionError(f"lvis_city {family}: the card's request disagrees with the CPU's")


def lvis_city_serve(kernel, family, keep):
    """24(a) and 24(d): the full-width model (seeded weights,
    ``random_state_dict`` with CASCADE_GAINS) serves LVIS_CITY_ROUNDS
    requests of LVIS_CITY_HW in each of bf16 and f32, in turns, K1 twice a
    request (the box and the mask pooler; the plain version raises on the
    card); then the stage split (``lvis_city_stages``) with its host syncs
    and each stage's peak memory; then one request on the card against the
    CPU. ``keep`` receives the f32 stage split's detection boxes (the mask
    pooler's input). Returns K1's launches and the mean latencies."""
    import numpy as np
    import torch

    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.engine import Predictor
    from jtsm_tpu_torch.modeling import build_model

    rng = np.random.default_rng(24)
    h, w = LVIS_CITY_HW[family]
    base = train_family_cfg(family)
    warm = request(rng, (h, w), (h, w), (h, w))
    reqs = [request(rng, (h, w), (h, w), (h, w)), request(rng, (h, w), (h - 50, w - 11), (h - 50, w - 11))]
    dtypes = (base.TPU.COMPUTE_DTYPE, "float32")
    state = gained(random_state_dict(build_model(base, device="cpu"), seed=24))
    predictors, mem = {}, {}
    for d in dtypes:
        c = base.clone()
        c.TPU.COMPUTE_DTYPE = d
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        predictors[d] = Predictor(c, state)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        predictors[d](warm)
        torch.cuda.synchronize()
        mem[d] = ((resident - before) / 2**30, (torch.cuda.max_memory_allocated() - resident) / 2**30)
    n = base.TEST.DETECTIONS_PER_IMAGE
    want = {"boxes": (1, n, 4), "scores": (1, n), "classes": (1, n), "valid": (1, n), "masks": (1, n, 28, 28)}
    lat = {d: [] for d in dtypes}
    kernel.launches = 0
    for i in range(LVIS_CITY_ROUNDS):
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            before = kernel.launches
            t0 = time.perf_counter()
            out = predictors[d](reqs[i % 2])
            torch.cuda.synchronize()
            lat[d].append((time.perf_counter() - t0) * 1e3)
            if kernel.launches - before != 2:
                raise AssertionError(f"lvis_city {family} {d} request {i}: K1 launched {kernel.launches - before} "
                                     "times, not 2")
            if {k: tuple(v.shape) for k, v in out.items()} != want or not all(
                    torch.isfinite(v.float()).all() for v in out.values()):
                raise AssertionError(f"lvis_city {family} {d} request {i}: outputs "
                                     f"{ {k: tuple(v.shape) for k, v in out.items()} }, expected {want}")
    launches = kernel.launches
    stage, latency = {d: {} for d in dtypes}, {}
    for i in range(LVIS_CITY_STAGE_ROUNDS):
        for d in dtypes if i % 2 == 0 else dtypes[::-1]:
            got, r = lvis_city_stages(predictors[d].model, reqs[0], timed_peak)
            if d == "float32":
                keep[family] = r["det"]["boxes"].reshape(-1, 4).float().contiguous()
            for k, v in got.items():
                stage[d].setdefault(k, []).append(v)
    part = "a" if family == "lvis" else "d"
    for d in dtypes:
        syncs, _ = lvis_city_stages(predictors[d].model, reqs[0], count_host_syncs)
        latency[(family, d)] = sum(lat[d]) / len(lat[d])
        log(f"[lvis_city] ({part}) {TRAIN_TITLES[family]} {h}x{w} {DTYPE_NAMES[d]}"
            f"{' (TF32 off)' if d == 'float32' else ''}, seeded weights (seed 24), {LVIS_CITY_ROUNDS} requests in "
            f"turns: latency_ms={[round(x, 3) for x in lat[d]]} mean_ms={latency[(family, d)]:.3f} "
            f"roi_align_fwd_launches 2 a request ({n} detections) | stages_ms (median of {LVIS_CITY_STAGE_ROUNDS}) "
            + " ".join(f"{k}={median([x['ms'] for x in v]):.3f}" for k, v in stage[d].items())
            + " | stage peak_gib " + " ".join(f"{k}={max(x['peak'] for x in v):.3f}" for k, v in stage[d].items())
            + " | host syncs " + " ".join(f"{k}={n_}" for k, n_ in syncs.items())
            + f" | weights_gib={mem[d][0]:.3f} request_peak_gib={mem[d][1]:.3f}")
    del predictors
    lvis_city_card_against_cpu(family, state, reqs[0])
    return launches, latency


def lvis_city_kernel_rows(gen, baseline, keep):
    """24(e): K1 and K2 against their plain versions at the new launch
    sites, in float32 and bfloat16, C=256: K1 at the LVIS mask pooler (the
    300 detection boxes of 24(a)'s f32 stage split, P=14, over an 800x1344
    pyramid); over a 1024x2048 pyramid (Cityscapes) K1 at the serving box
    (R=1000, P=7) and mask (R=100, P=14) poolers, and K1 and K2 at the train
    step's box (B=2, R=2x512, P=7) and mask (B=2, R=2x128, P=14) poolers.
    Returns the rows by site."""
    import torch

    from jtsm_tpu_torch.modeling.poolers import assign_boxes_to_levels

    rows = {site: {} for site in ("lvis_mask", "city_serve_box", "city_serve_mask", "city_train_box",
                                  "city_train_mask")}
    scales = [1.0 / s for s in LEVEL_STRIDES]
    for dtype in (torch.float32, torch.bfloat16):
        tag = dtype_tag(torch.empty(0, dtype=dtype))
        pyr = flagship_pyramid(gen, dtype=dtype)
        boxes = keep["lvis"]
        bidx = torch.zeros(boxes.shape[0], dtype=torch.int32, device=DEVICE)
        rows["lvis_mask"][f"fwd {tag}"] = check_and_time_fwd(
            f"LVIS mask pooler {tag} (R={boxes.shape[0]} detections)", pyr, scales, boxes, bidx,
            assign_boxes_to_levels(boxes, 2, 5), 14, baseline, "lvis_city")
        del pyr
        for batch, parts in ((1, (("city_serve_box", 1000, 7), ("city_serve_mask", 100, 14))),
                             (TRAIN_BATCH, (("city_train_box", 512, 7), ("city_train_mask", 128, 14)))):
            pyr = flagship_pyramid(gen, dtype=dtype, batch=batch, hw=CITY_HW)
            for site, per_image, p in parts:
                boxes = spread_boxes(gen, batch * per_image, hw=CITY_HW)
                bidx = torch.arange(batch, device=DEVICE, dtype=torch.int32).repeat_interleave(per_image)
                levels = assign_boxes_to_levels(boxes, 2, 5)
                name = f"{site} {tag} B={batch} R={batch}x{per_image} {CITY_HW[0]}x{CITY_HW[1]}"
                rows[site][f"fwd {tag}"] = check_and_time_fwd(name, pyr, scales, boxes, bidx, levels, p, baseline,
                                                              "lvis_city")
                if batch > 1:
                    rows[site][f"bwd {tag}"] = check_and_time_bwd(name, pyr, scales, boxes, bidx, levels, p, gen,
                                                                  baseline, "lvis_city")
            del pyr
    return rows


def lvis_city_trainer(kernels, family, state):
    """24(c) and 24(d): the full-width model (bf16, as configured) through
    ``DefaultTrainer`` on in-memory scenes (LVIS: LVIS_CITY_TRAINER_SCENES
    of SCORE_HW in LVIS's json form, the repeat-factor sampler at
    REPEAT_THRESHOLD 0.001; Cityscapes: 1024x2048 scenes with their
    polygons), the yaml's train scales and the flip, IMS_PER_BATCH
    TRAIN_BATCH, from 24(b)'s seeded weights: K1 and K2 twice an iteration,
    every loss finite. Returns the launches and the run."""
    import tempfile

    from jtsm_tpu_torch.data.datasets.synthetic_cityscapes import register_synthetic_cityscapes
    from jtsm_tpu_torch.data.datasets.synthetic_lvis import register_synthetic_lvis
    from jtsm_tpu_torch.engine import DefaultTrainer

    name = f"chip_smoke_{family}_train"
    if family == "lvis":
        register_synthetic_lvis(name, num=LVIS_CITY_TRAINER_SCENES[family], seed=5, image_hw=SCORE_HW)
    else:
        register_synthetic_cityscapes(name, num=LVIS_CITY_TRAINER_SCENES[family], seed=5, image_hw=CITY_HW)
    cfg = train_family_cfg(family)
    cfg.DATASETS.TRAIN = (name,)
    cfg.SOLVER.IMS_PER_BATCH = TRAIN_BATCH
    cfg.SOLVER.MAX_ITER = LVIS_CITY_TRAINER_ITERS
    cfg.SOLVER.CHECKPOINT_PERIOD = 10 * LVIS_CITY_TRAINER_ITERS
    cfg.TEST.EVAL_PERIOD = 0
    cfg.MODEL.WEIGHTS = ""
    cfg.SEED = 0
    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{family}_") as tmp:
        cfg.OUTPUT_DIR = tmp
        trainer, rec, got, peak = run_trainer(DefaultTrainer, cfg, kernels, state)
        check_launches(f"{family} trainer", rec, dict(zip([k.name for k in kernels], TRAIN_K[family])))
        metrics = read_metrics(tmp)
        if [m["iteration"] for m in metrics] != list(range(LVIS_CITY_TRAINER_ITERS)) or not all(
                math.isfinite(m[k]) for m in metrics[1:] for k in m if k.startswith("loss")):
            raise AssertionError(f"{family} trainer: metrics.json {metrics[-1]}")
        loader = trainer.data_loader
        sampler = type(loader.sampler).__name__
        if sampler != cfg.DATALOADER.SAMPLER_TRAIN:
            raise AssertionError(f"{family} trainer: sampler {sampler}, not {cfg.DATALOADER.SAMPLER_TRAIN}")
        run = dict(s_iter=median(iteration_times(trainer, "time", 1)),
                   data_time=median(iteration_times(trainer, "data_time", 1)), peak=peak,
                   loader=loader.busy_seconds / loader.batches, launches=got)
        log(f"[lvis_city] ({'c' if family == 'lvis' else 'd'}) {TRAIN_TITLES[family]} {cfg.TPU.COMPUTE_DTYPE} through "
            f"DefaultTrainer ({sampler}, REPEAT_THRESHOLD {cfg.DATALOADER.REPEAT_THRESHOLD}): "
            f"{LVIS_CITY_TRAINER_SCENES[family]} in-memory scenes, short sides {tuple(cfg.INPUT.MIN_SIZE_TRAIN)} "
            f"(max {cfg.INPUT.MAX_SIZE_TRAIN}) and the flip, IMS_PER_BATCH {TRAIN_BATCH}, {LVIS_CITY_TRAINER_ITERS} "
            f"iterations: s/iter median {run['s_iter']:.4f} data_time median {run['data_time']:.4f} loader s/batch "
            f"{run['loader']:.4f} launches {got} peak_mem_gib {peak:.3f} | losses at the last iteration "
            + ", ".join(f"{k}={v:.5g}" for k, v in metrics[-1].items() if k.startswith("loss")))
        del trainer
    return got, run


def lvis_city_gate_scores(kernel, family):
    """24(c) and 24(d): the Mask R-CNN gate carried onto the family's
    classes (``checkpoint.select_class_rows``: COCO's 80 as LVIS 1-80 of
    1203, or Cityscapes' 8 as the COCO classes their scenes are painted as)
    scored on its own 8 scenes (seed 0) in LVIS's form (``LVISEvaluator``,
    SCORE_THRESH_TEST 0.0001, 300 detections) or Cityscapes' form
    (``CityscapesInstanceEvaluator``), float32, on the card and on this
    machine's CPU: every number within LVIS_CITY_AP_TOL. Returns K1's
    launches on the card."""
    import torch

    from jtsm_tpu_torch.checkpoint import load_gate_ckpt, select_class_rows, variables_to_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_gate_cfg
    from jtsm_tpu_torch.data.datasets.cityscapes import CITYSCAPES_THING_CLASSES
    from jtsm_tpu_torch.data.datasets.synthetic import COCO_80
    from jtsm_tpu_torch.data.datasets.synthetic_cityscapes import CITY_TO_COCO, register_synthetic_cityscapes
    from jtsm_tpu_torch.data.datasets.synthetic_lvis import register_synthetic_lvis
    from jtsm_tpu_torch.engine import test
    from jtsm_tpu_torch.evaluation import CityscapesInstanceEvaluator, LVISEvaluator
    from jtsm_tpu_torch.modeling import build_model

    cfg = mask_rcnn_gate_cfg()
    name = f"chip_smoke_{family}_gate"
    gate = variables_to_state_dict(load_gate_ckpt(os.path.join(REPO, cfg.MODEL.WEIGHTS)))
    if family == "lvis":
        register_synthetic_lvis(name, num=LVIS_CITY_GATE_SCENES, seed=0)
        rows, classes, evaluator = list(range(80)), 1203, LVISEvaluator
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0001
        cfg.TEST.DETECTIONS_PER_IMAGE = 300
    else:
        register_synthetic_cityscapes(name, num=LVIS_CITY_GATE_SCENES, seed=0)
        rows, classes, evaluator = [COCO_80.index(CITY_TO_COCO[c]) for c in CITYSCAPES_THING_CLASSES], 8, \
            CityscapesInstanceEvaluator
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = classes
    cfg.DATASETS.TEST = (name,)
    weights = select_class_rows(gate, rows, classes)
    results, launches = {}, 0
    for device in (DEVICE, "cpu"):
        model = build_model(cfg, device=device)
        model.load_state_dict(weights)
        kernel.launches = 0
        t0 = time.perf_counter()
        results[device] = test(cfg, model, evaluators=[evaluator(name)])
        seconds = time.perf_counter() - t0
        if device != "cpu":
            launches = kernel.launches
            if launches != 2 * LVIS_CITY_GATE_SCENES:
                raise AssertionError(f"{family} gate: K1 launched {launches} times for {LVIS_CITY_GATE_SCENES} images")
        log(f"[lvis_city] ({'c' if family == 'lvis' else 'd'}) the Mask R-CNN gate on {classes} classes "
            f"({evaluator.__name__}, {LVIS_CITY_GATE_SCENES} scenes, f32) on {device} in {seconds:.1f}s: "
            + "; ".join(f"{t} " + " ".join(f"{k}={v:.4f}" for k, v in m.items()) for t, m in results[device].items()))
        del model
    diff = max(abs(v - results["cpu"][t][k]) for t, m in results[DEVICE].items() for k, v in m.items()
               if not (math.isnan(v) and math.isnan(results["cpu"][t][k])))
    log(f"[lvis_city] the {family} gate's numbers, card against CPU: largest difference {diff:.4f} "
        f"(tol {LVIS_CITY_AP_TOL})")
    if not diff <= LVIS_CITY_AP_TOL or results[DEVICE].keys() != results["cpu"].keys():
        raise AssertionError(f"lvis_city {family} gate: the card's numbers differ from the CPU's by {diff}")
    return launches


def phase_lvis_city(kernels, gen, baseline):
    """Phase 24: Mask R-CNN on LVIS v1 (1203 classes, 300 detections) and on
    Cityscapes (8 classes, 1024x2048). (a) LVIS requests at 800x1344 by
    stage, one on the card against the CPU; (b) LVIS train steps; (c) LVIS
    through ``DefaultTrainer`` (the repeat-factor sampler), and the gate on
    LVIS's classes scored by ``LVISEvaluator`` on the card against the CPU;
    (d) the same for Cityscapes at 1024x2048 (requests, steps, the trainer,
    ``CityscapesInstanceEvaluator``); (e) K1 and K2 at the new launch sites.
    The plain ROIAlign raises on the card. Returns the kernel rows by site,
    each kernel's launches by model (serve, train steps, trainer, gate
    scoring), the latencies and the step times."""
    from jtsm_tpu_torch.ops import roi_align

    routed = roi_align.roi_align_multilevel_plain_autograd

    def plain_on_cpu_only(features, scales, boxes, *a, **k):
        if boxes.device.type != "cpu":
            raise AssertionError("the plain ROIAlign ran on the card in phase 24")
        return routed(features, scales, boxes, *a, **k)

    roi_align.roi_align_multilevel_plain_autograd = plain_on_cpu_only
    names = [k.name for k in kernels]
    keep, by_model, latency, steps, trainers = {}, {}, {}, {}, {}
    try:
        for family in LVIS_CITY_BUILDERS:
            serve_launches, lat = lvis_city_serve(kernels[0], family, keep)
            latency.update(lat)
            train_launches, med, states = families_full_train(
                (family,), kernels, "lvis_city", "b" if family == "lvis" else "d", hw=LVIS_CITY_HW[family])
            steps.update(med)
            trainer_launches, trainers[family] = lvis_city_trainer(kernels, family, states[family])
            gate_launches = lvis_city_gate_scores(kernels[0], family)
            by_model[family] = {n: train_launches[family][n] + trainer_launches[n] for n in names}
            by_model[family][names[0]] += serve_launches + gate_launches
        rows = lvis_city_kernel_rows(gen, baseline, keep)
    finally:
        roi_align.roi_align_multilevel_plain_autograd = routed
    launches = {n: sum(m[n] for m in by_model.values()) for n in names}
    return rows, launches, by_model, latency, steps, trainers


def kernel_line(kernel, launches, rows, f32_errs):
    """One entry of the kernels JSON line. ``ms``, ``plain_ms`` and
    ``bound_ms`` keep their long-standing meaning: the float32 box and mask
    pooler rows summed, under the timer without a queue, against the bound
    of the summed work. Beside them: ``device_ms`` (the same rows, the
    device's time alone), the bf16 rows (the flagship's compute dtype) and,
    with --baseline, the earlier kernel's times on the same inputs."""

    def summed(key, who, timer):
        return rows[f"box pooler {key}"]["times"][who][timer] + rows[f"mask pooler {key}"]["times"][who][timer]

    def summed_bound(key):
        box, mask = rows[f"box pooler {key}"], rows[f"mask pooler {key}"]
        return bound(box["nbytes"] + mask["nbytes"], box["flops"] + mask["flops"])

    box, mask = rows["box pooler f32"], rows["mask pooler f32"]
    b_ms, b_by = summed_bound("f32")
    line = {
        "name": kernel.name,
        "route": "cuda",
        "source": kernel.source,
        "replaces": kernel.replaces,
        "launches": launches,
        "max_abs_err": max(f32_errs),
        "ms": summed("f32", "new", "ms"),
        "plain_ms": box["plain_ms"] + mask["plain_ms"],
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "device_ms": summed("f32", "new", "device_ms"),
        "bf16_ms": summed("bf16", "new", "ms"),
        "bf16_device_ms": summed("bf16", "new", "device_ms"),
        "bf16_bound_ms": summed_bound("bf16")[0],
        "bf16_max_abs_err": max(rows["box pooler bf16"]["err"], rows["mask pooler bf16"]["err"]),
    }
    if "baseline" in box["times"]:
        line.update({
            "baseline_ms": summed("f32", "baseline", "ms"),
            "baseline_device_ms": summed("f32", "baseline", "device_ms"),
            "bf16_baseline_ms": summed("bf16", "baseline", "ms"),
            "bf16_baseline_device_ms": summed("bf16", "baseline", "device_ms"),
        })
    return line


def build_baseline(src_dir):
    """K1 and K2 from the sources in ``src_dir`` (an earlier
    ``jtsm_tpu_torch/ops/csrc`` with the same C interfaces), compiled with the
    package's nvcc command into a temporary directory outside the checkout,
    which is removed once both libraries are loaded. Their launches count
    apart from the package's kernels."""
    import ctypes
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor
    from pathlib import Path

    from jtsm_tpu_torch.ops.cuda_build import NVCC_FLAGS, BuiltLibrary, find_nvcc
    from jtsm_tpu_torch.ops.roi_align_cuda import RoIAlignBwdKernel, RoIAlignFwdKernel

    out_dir = tempfile.mkdtemp(prefix="jtsm_baseline_kernels_")

    def one(kernel):
        src = os.path.join(src_dir, os.path.basename(kernel.source))
        out = os.path.join(out_dir, f"lib{kernel.name}.so")
        t0 = time.perf_counter()
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", out, src], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) on {src}:\n{proc.stdout}\n{proc.stderr}")
        lib = ctypes.CDLL(out)
        fn = getattr(lib, kernel.entry)
        fn.argtypes = kernel.argtypes
        fn.restype = ctypes.c_int
        kernel.built = BuiltLibrary(lib, Path(src), time.perf_counter() - t0, "")
        return kernel

    try:
        with ThreadPoolExecutor(2) as pool:
            return tuple(pool.map(one, (RoIAlignFwdKernel(), RoIAlignBwdKernel())))
    finally:
        shutil.rmtree(out_dir)


def run_phase(name, fn, *args):
    """``fn(*args)``, the phase ``name``: its time logged when it ends; a
    failure logs ``[name] FAILED: <type>: <message>`` and the traceback,
    then goes on up, so that the run ends with a non-zero exit and nothing
    runs after it."""
    import traceback

    t0 = time.perf_counter()
    try:
        out = fn(*args)
    except BaseException as e:
        log(f"[{name}] FAILED: {type(e).__name__}: {e}")
        log(traceback.format_exc().rstrip())
        raise
    log(f"[{name}] done in {time.perf_counter() - t0:.1f}s")
    return out


def main(argv=None) -> int:
    t_run = time.perf_counter()
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--baseline", metavar="DIR", help="sources of an earlier "
                        "jtsm_tpu_torch/ops/csrc to build and time beside this checkout's kernels")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "jtsm_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)

    # 1. device
    def device():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        log(f"[device] {card} | torch {torch.__version__} cuda {torch.version.cuda} "
            f"python {sys.version.split()[0]} | TF32 (matmul, cuDNN) as found: {tf32_flags()}; the port "
            f"turns both off in float32")
        return card

    card = run_phase("device", device)

    # 2. build
    from concurrent.futures import ThreadPoolExecutor

    from jtsm_tpu_torch.ops.roi_align_cuda import BWD_KERNEL, KERNEL, KERNELS, load_kernels

    def build():
        with ThreadPoolExecutor(1) as pool:
            pending = pool.submit(build_baseline, args.baseline) if args.baseline else None
            for k, built in zip(KERNELS, load_kernels()):
                log(f"[build] {k.source} -> {os.path.relpath(built.path, REPO)} in {built.seconds:.1f}s (nvcc)")
                for line in built.ptxas_log.splitlines():
                    log(f"[build] {line.strip()}")
            baseline = pending and pending.result()
        for k in baseline or ():
            log(f"[build] baseline {k.built.path} in {k.built.seconds:.1f}s (nvcc, into a temporary directory)")
        log("[build] one nvcc per source, in parallel"
            + ("" if baseline else "; no --baseline: times beside an earlier version not measured"))
        return baseline

    baseline = run_phase("build", build)

    # 3. K1 against its plain version at the served shapes
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    res = run_phase("kernels", phase_kernels, gen, baseline)

    # 4. serve the flagship at its configured dtype, then in float32
    from jtsm_tpu_torch.checkpoint import random_state_dict
    from jtsm_tpu_torch.config import mask_rcnn_R_50_FPN_cfg
    from jtsm_tpu_torch.modeling import build_model

    flagship = mask_rcnn_R_50_FPN_cfg()
    main_dtype = flagship.TPU.COMPUTE_DTYPE
    if main_dtype != "bfloat16":
        raise AssertionError(f"the flagship's TPU.COMPUTE_DTYPE is {main_dtype}, not bfloat16")
    state = random_state_dict(build_model(flagship, device="cpu"), seed=0)
    launches = run_phase("serve", phase_serve, KERNEL, (main_dtype, "float32"), state)

    # 5. trained weights, kernel against plain on the card
    run_phase("trained", phase_trained)

    # 6. the training kernels against their plain versions
    tres = run_phase("train_kernels", phase_train_kernels, gen, baseline)

    # 7. train the flagship (cuDNN's own algorithm choice, as a user trains)
    torch.backends.cudnn.deterministic = False
    train = run_phase("train", lambda: {d: phase_train(KERNELS, d, state) for d in (main_dtype, "float32")})

    # 8. a train step from trained weights, kernels against plain
    run_phase("train_trained", phase_train_trained)

    # 9. score: the gate on the card against the CPU; the flagship by stage
    score_launches = run_phase("score", phase_score, KERNEL, state)

    # 10. the JTSM flagship: K1 at its mask pooler's shape, serving, the gate
    jtsm_rows, jtsm_launches, jtsm_lat, jtsm_state = run_phase("jtsm", phase_jtsm, KERNEL, gen, baseline)

    # 11. JTSM training: K1 and K2 at its mask pooler's shape, the flagship's
    # step in both dtypes, the gate's steps on the card against the CPU
    jt_rows, jt_launches, jt_med = run_phase("jtsm_train", phase_jtsm_train, KERNELS, gen, baseline, jtsm_state)

    # 12. JTSM scoring: the gate on the card against the CPU; the flagship by stage
    js_launches = run_phase("jtsm_score", phase_jtsm_score, KERNEL, jtsm_state)

    # 13. TTA: the JTSM gate on the card against the CPU, K1 at the largest
    # view's shape, the flagship by stage, the Mask R-CNN gate
    tta_rows, tta_launches = run_phase("jtsm_tta", phase_jtsm_tta, KERNEL, gen, baseline, jtsm_state, card)

    # 14. training as the command line trains: both flagships through their
    # trainers, resume, and the gate through the trainer against plain
    tc_launches, tc_runs, tc_jtsm = run_phase("train_cli", phase_train_cli, KERNELS, jtsm_state)

    # 15. the other core meta-architectures: their gates on the card against
    # the CPU, each served at full width by stage, K1 at the keypoint
    # pooler's shape
    fam_launches, kp_launches, kp_rows, fam_latency = run_phase("families", phase_families, KERNEL, gen, baseline,
                                                                card)

    # 16. the WSOD baselines: K1 and K2 at their box pooler's shapes, the
    # narrow configs on the card against the CPU, the four full-width
    # configs served, trained and through the WSL trainer
    wsod_rows, wsod_launches, wsod_lat, wsod_steps, wsod_trainer_runs = run_phase(
        "wsod", phase_wsod, KERNELS, gen, baseline)

    # 17. the dense detectors train: RetinaNet and the RPN alone, their
    # narrow gates on the card against the CPU, full width by stage
    dense_launches, dense_med = run_phase("dense_train", phase_dense_train, KERNELS)

    # 18. Keypoint R-CNN, Panoptic FPN and SemanticSegmentor train: K1 and
    # K2 at the keypoint pooler's train shape, the narrow configs on the
    # card against the CPU, full width by stage, the keypoint trainer
    ft_rows, ft_launches, kp_train, pan_train, ft_med, kp_trainer = run_phase(
        "families_train", phase_families_train, KERNELS, gen, baseline)

    # 19. the training surface: the giou, pred-boxes and SyncBN Mask R-CNNs
    # (narrow on the card against the CPU, full width by stage, K1 and K2 at
    # the predicted mask boxes), WSDDN R-18 with the crop through the WSL
    # trainer (K1 and K2 at its res5 train shape), the SyncBN model through
    # the trainer with PreciseBN and with ADAM and WarmupPolyLR
    ts_rows, ts_launches, pred_launches, wsddn_launches, ts_med, ts_runs = run_phase(
        "train_surface", phase_train_surface, KERNELS, gen, baseline)

    # 20. the WSOD zoo: K1 and K2 at the GAM-attended map, the cascade's
    # mined rows and CMIL's VGG16 box pooler; the narrow heads and the ops
    # on the card against the CPU; the seven full-width configurations
    # served and trained; CMIL through the WSL trainer
    zoo_rows, zoo_launches_, zoo_sites, zoo_lat, zoo_steps, zoo_trainer_run = run_phase(
        "wsod_zoo", phase_wsod_zoo, KERNELS, gen, baseline)

    # 21. CSC, CSC-OICR and WSJDS with the class-peak-gradient pass, UWSOD
    # with RPNWSL: K1 and K2 at the CPG pass's box pooler and UWSOD's
    # branch-averaged map; the narrow models, csc_full and the CRF on the
    # card against the CPU; the six full-width configurations served and
    # trained (the CPG pass its own stage); csc_V_16 and uwsod_V_16 through
    # the WSL trainer
    csc_rows, csc_launches, uwsod_launches, cpg_launches_, csc_lat, csc_steps, csc_trainer_runs = run_phase(
        "csc_uwsod", phase_csc_uwsod, KERNELS, gen, baseline)

    # 22. the C4 family, Trident OICR and the WSR-50 FPN: K1 and K2 at the C4
    # res4 pooler, K1 at Trident's branch-averaged res5; the narrow models on
    # the card against the CPU; C4 Mask R-CNN, Trident OICR and the WSR-50 FPN
    # served and trained at full width; C4 Mask R-CNN through DefaultTrainer
    c4_rows, c4_all, c4_sites, c4_lat, c4_steps, c4_trainer_run = run_phase(
        "c4_trident_fpn", phase_c4_trident_fpn, KERNELS, gen, baseline)

    # 23. Cascade Mask R-CNN, the dconv Mask R-CNN and Fast R-CNN: the narrow
    # models on the card against the CPU; the three served and trained at
    # full width (the deformable convolutions' share timed); K1 and K2 at the
    # cascade's stage pools, its train step and Fast R-CNN's proposals; the
    # cascade through DefaultTrainer; the X-152 and Panoptic FPN R-101 dconv
    # cascades served once each
    cd_rows, cd_all, cd_sites, cd_lat, cd_combined_lat, cd_steps, cd_trainer_run = run_phase(
        "cascade_dconv", phase_cascade_dconv, KERNELS, gen, baseline)

    # 24. Mask R-CNN on LVIS v1 (1203 classes, 300 detections) and on
    # Cityscapes (1024x2048): served by stage (one request on the card
    # against the CPU), trained, through DefaultTrainer, the gate scored by
    # LVISEvaluator and CityscapesInstanceEvaluator on the card against the
    # CPU; K1 at the LVIS mask pooler, K1 and K2 over the 1024x2048 pyramid
    lc_rows, lc_all, lc_sites, lc_lat, lc_steps, lc_trainers = run_phase(
        "lvis_city", phase_lvis_city, KERNELS, gen, baseline)

    # per served request K1 pools boxes (R=1000, P=7) and masks (R=100,
    # P=14); per train step K1 and K2 pool and unpool boxes (R=1024, P=7)
    # and masks (R=256, P=14); per JTSM request K1 pools masks on one level
    # (R=100, P=14, C=512); per JTSM train step K1 pools masks on one level
    # (B=4, R=256, P=14, C=512), and K2 unpools them where the maps train
    # (the gate); per JTSM scored image K1 pools masks on one level (R=100,
    # P=14, C=512), and with TTA twice a view (R=100, P=14, C=512, up to
    # (1, 75, 100, 512) at the 1200 view). Times as kernel_line says;
    # launches: the main paths, serve, train, score, JTSM, JTSM train, JTSM
    # score and TTA, in both dtypes; phase 15's Panoptic FPN (box and mask
    # poolers) and Keypoint R-CNN (box and keypoint poolers, R=100 P=14);
    # phase 16's WSOD box pooler (one level, R=2000 a request, P=7) and,
    # under VGG16's step, its backward.
    k1_launches = (sum(launches.values()) + sum(t[0][KERNEL.name] for t in train.values()) + score_launches
                   + jtsm_launches + jt_launches[KERNEL.name] + js_launches + tta_launches + tc_launches[KERNEL.name]
                   + fam_launches + wsod_launches[KERNEL.name] + dense_launches[KERNEL.name]
                   + ft_launches[KERNEL.name] + ts_launches[KERNEL.name] + zoo_launches_[KERNEL.name]
                   + csc_launches[KERNEL.name] + c4_all[KERNEL.name] + cd_all[KERNEL.name] + lc_all[KERNEL.name])
    k2_launches = (sum(t[0][BWD_KERNEL.name] for t in train.values()) + jt_launches[BWD_KERNEL.name]
                   + tc_launches[BWD_KERNEL.name] + wsod_launches[BWD_KERNEL.name] + dense_launches[BWD_KERNEL.name]
                   + ft_launches[BWD_KERNEL.name] + ts_launches[BWD_KERNEL.name] + zoo_launches_[BWD_KERNEL.name]
                   + csc_launches[BWD_KERNEL.name] + c4_all[BWD_KERNEL.name] + cd_all[BWD_KERNEL.name]
                   + lc_all[BWD_KERNEL.name])
    bwd = {k[4:]: v for k, v in tres.items() if k.startswith("bwd ")}
    kernels = [
        kernel_line(KERNEL, k1_launches, res, [r["err"] for n, r in res.items() if "f32" in n]),
        kernel_line(BWD_KERNEL, k2_launches, bwd, [r["err"] for n, r in bwd.items() if "f32" in n]),
    ]
    # the single-level row (K1b's shape): the JTSM mask pooler
    l1, l1_bf16 = jtsm_rows["jtsm mask pooler f32 (L=1)"], jtsm_rows["jtsm mask pooler bf16 (L=1)"]
    kernels[0].update({
        "l1_launches": jtsm_launches,
        "l1_max_abs_err": l1["err"],
        "l1_ms": l1["times"]["new"]["ms"],
        "l1_device_ms": l1["times"]["new"]["device_ms"],
        "l1_plain_ms": l1["plain_ms"],
        "l1_bound_ms": l1["bound_ms"],
        "l1_bf16_max_abs_err": l1_bf16["err"],
        "l1_bf16_ms": l1_bf16["times"]["new"]["ms"],
        "l1_bf16_device_ms": l1_bf16["times"]["new"]["device_ms"],
        "l1_bf16_bound_ms": l1_bf16["bound_ms"],
    })
    kernels[0]["js_launches"] = js_launches
    # the TTA row: the mask pooler at the 1200 view of a VOC image, one
    # level (1, 75, 100, 512), R=100, P=14
    tta, tta_bf16 = tta_rows["tta mask pooler f32 (L=1, 1200 view)"], tta_rows["tta mask pooler bf16 (L=1, 1200 view)"]
    kernels[0].update({
        "tta_launches": tta_launches,
        "tta_max_abs_err": tta["err"],
        "tta_ms": tta["times"]["new"]["ms"],
        "tta_device_ms": tta["times"]["new"]["device_ms"],
        "tta_plain_ms": tta["plain_ms"],
        "tta_bound_ms": tta["bound_ms"],
        "tta_bf16_max_abs_err": tta_bf16["err"],
        "tta_bf16_ms": tta_bf16["times"]["new"]["ms"],
        "tta_bf16_device_ms": tta_bf16["times"]["new"]["device_ms"],
        "tta_bf16_plain_ms": tta_bf16["plain_ms"],
        "tta_bf16_bound_ms": tta_bf16["bound_ms"],
    })
    # the JTSM train rows: the mask pooler of a flagship step, one level,
    # B=4, R=256, P=14, C=512 (K1 forward, K2 backward)
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        f32, bf16 = jt_rows[f"{kind} f32"], jt_rows[f"{kind} bf16"]
        line.update({
            "jt_launches": jt_launches[line["name"]],
            "jt_max_abs_err": f32["err"],
            "jt_ms": f32["times"]["new"]["ms"],
            "jt_device_ms": f32["times"]["new"]["device_ms"],
            "jt_plain_ms": f32["plain_ms"],
            "jt_bound_ms": f32["bound_ms"],
            "jt_bf16_max_abs_err": bf16["err"],
            "jt_bf16_ms": bf16["times"]["new"]["ms"],
            "jt_bf16_device_ms": bf16["times"]["new"]["device_ms"],
            "jt_bf16_plain_ms": bf16["plain_ms"],
            "jt_bf16_bound_ms": bf16["bound_ms"],
        })
    # the keypoint pooler's row (phase 15(c)): a Keypoint R-CNN request's
    # 100 detections over an 800x1344 pyramid, C=256, P=14; its launches are
    # the keypoint pooler's in phase 15, the phase's all in fam_launches
    kp, kp_bf16 = kp_rows["f32"], kp_rows["bf16"]
    kernels[0].update({
        "kp_launches": kp_launches,
        "kp_max_abs_err": kp["err"],
        "kp_ms": kp["times"]["new"]["ms"],
        "kp_device_ms": kp["times"]["new"]["device_ms"],
        "kp_plain_ms": kp["plain_ms"],
        "kp_bound_ms": kp["bound_ms"],
        "kp_bound_by": kp["bound_by"],
        "kp_bf16_max_abs_err": kp_bf16["err"],
        "kp_bf16_ms": kp_bf16["times"]["new"]["ms"],
        "kp_bf16_device_ms": kp_bf16["times"]["new"]["device_ms"],
        "kp_bf16_plain_ms": kp_bf16["plain_ms"],
        "kp_bf16_bound_ms": kp_bf16["bound_ms"],
        "fam_launches": fam_launches,
    })
    # the WSOD rows (phase 16(d)): one level of a 1024x1024 bucket, P=7,
    # R=2000 a request (serve: B=1; train: B=4, R=8000); K1 at WSR-18's res5
    # (stride 16) and VGG16's plain5 (stride 8), K2 at VGG16's train shape;
    # their launches on phase 16's main paths
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        line["wsod_launches"] = wsod_launches[line["name"]]
        for key, row in wsod_rows.items():
            if not key.startswith(kind + " "):
                continue
            tag = "wsod_" + key[len(kind) + 1:].replace(" ", "_").replace("-", "").lower()
            line.update({f"{tag}_max_abs_err": row["err"], f"{tag}_ms": row["times"]["new"]["ms"],
                         f"{tag}_device_ms": row["times"]["new"]["device_ms"], f"{tag}_plain_ms": row["plain_ms"],
                         f"{tag}_bound_ms": row["bound_ms"], f"{tag}_bound_by": row["bound_by"]})
    # the train rows of phase 18: the keypoint pooler's train shape (B=2,
    # R=2x128, P=14, C=256 over an 800x1344 pyramid), measured in 18(c);
    # Panoptic FPN's box (R=1024, P=7) and mask (R=256, P=14) poolers have
    # the flagship's train shapes, whose rows phase 6 measured in this run.
    # Their launches: the keypoint and Panoptic FPN train steps of 18(b)
    # (and the keypoint trainer of 18(d)); fam_train_launches all of 18's
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        f32, bf16 = ft_rows[f"{kind} f32"], ft_rows[f"{kind} bf16"]
        box, mask = tres[f"{kind} box pooler f32"], tres[f"{kind} mask pooler f32"]
        box16, mask16 = tres[f"{kind} box pooler bf16"], tres[f"{kind} mask pooler bf16"]
        pan_bound, pan_by = bound(box["nbytes"] + mask["nbytes"], box["flops"] + mask["flops"])
        line.update({
            "kp_train_launches": kp_train[line["name"]],
            "kp_train_max_abs_err": f32["err"],
            "kp_train_ms": f32["times"]["new"]["ms"],
            "kp_train_device_ms": f32["times"]["new"]["device_ms"],
            "kp_train_plain_ms": f32["plain_ms"],
            "kp_train_bound_ms": f32["bound_ms"],
            "kp_train_bound_by": f32["bound_by"],
            "kp_train_bf16_max_abs_err": bf16["err"],
            "kp_train_bf16_ms": bf16["times"]["new"]["ms"],
            "kp_train_bf16_device_ms": bf16["times"]["new"]["device_ms"],
            "kp_train_bf16_plain_ms": bf16["plain_ms"],
            "kp_train_bf16_bound_ms": bf16["bound_ms"],
            "pan_train_launches": pan_train[line["name"]],
            "pan_train_max_abs_err": max(box["err"], mask["err"]),
            "pan_train_ms": box["times"]["new"]["ms"] + mask["times"]["new"]["ms"],
            "pan_train_device_ms": box["times"]["new"]["device_ms"] + mask["times"]["new"]["device_ms"],
            "pan_train_plain_ms": box["plain_ms"] + mask["plain_ms"],
            "pan_train_bound_ms": pan_bound,
            "pan_train_bound_by": pan_by,
            "pan_train_bf16_ms": box16["times"]["new"]["ms"] + mask16["times"]["new"]["ms"],
            "pan_train_bf16_device_ms": box16["times"]["new"]["device_ms"] + mask16["times"]["new"]["device_ms"],
            "fam_train_launches": ft_launches[line["name"]],
        })
    # the rows of phase 19: the pred-boxes mask pooler (B=2, R=2x128, P=14,
    # C=256 over an 800x1344 pyramid, the boxes the box head predicts) and
    # WSDDN R-18's res5 at its train shape (one level, a cropped batch of 4,
    # P=7, 4000 proposal slots an image); their launches under the pred-boxes
    # steps of 19(b) and the WSDDN trainer of 19(c); ts_launches all of
    # phase 19's main paths, (b) to (d)
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        for site, key, counts in (("pred_mask", "pred", pred_launches), ("wsddn_train", "wsddn", wsddn_launches)):
            f32, bf16 = ts_rows[key][f"{kind} f32"], ts_rows[key][f"{kind} bf16"]
            line.update({
                f"{site}_launches": counts[line["name"]],
                f"{site}_max_abs_err": f32["err"],
                f"{site}_ms": f32["times"]["new"]["ms"],
                f"{site}_device_ms": f32["times"]["new"]["device_ms"],
                f"{site}_plain_ms": f32["plain_ms"],
                f"{site}_bound_ms": f32["bound_ms"],
                f"{site}_bound_by": f32["bound_by"],
                f"{site}_bf16_max_abs_err": bf16["err"],
                f"{site}_bf16_ms": bf16["times"]["new"]["ms"],
                f"{site}_bf16_device_ms": bf16["times"]["new"]["device_ms"],
                f"{site}_bf16_plain_ms": bf16["plain_ms"],
                f"{site}_bf16_bound_ms": bf16["bound_ms"],
            })
        line["ts_launches"] = ts_launches[line["name"]]
    # the rows of phase 20(d) by site: the GAM-attended WSR-18 res5 map
    # (serve B=1, R=2000; train B=4, R=8000), the cascade's mined rows (B=4,
    # 640 an image) and CMIL's VGG16 plain5 (B=4, R=8000), each (64, 64) or
    # (128, 128) at P=7, C=512; each site's launches on phase 20's main
    # paths, zoo_launches all of them
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        for site, site_rows in zoo_rows.items():
            line[f"zoo_{site}_launches"] = zoo_sites[site][line["name"]]
            for key, row in site_rows.items():
                if not key.startswith(kind + " "):
                    continue
                tag = f"zoo_{site}_" + key[len(kind) + 1:].replace(" ", "_")
                line.update({f"{tag}_max_abs_err": row["err"], f"{tag}_ms": row["times"]["new"]["ms"],
                             f"{tag}_device_ms": row["times"]["new"]["device_ms"], f"{tag}_plain_ms": row["plain_ms"],
                             f"{tag}_bound_ms": row["bound_ms"], f"{tag}_bound_by": row["bound_by"]})
        line["zoo_launches"] = zoo_launches_[line["name"]]
    # the rows of phase 21(d): the CPG pass's VGG16 box pooler (B=4, R=8000,
    # (128, 128) at P=7, C=512; K1 in its forward, K2 in each backward) and
    # UWSOD's branch-averaged plain5 (serve B=1, R=2048; train B=4, R=8192);
    # csc_launches all of phase 21's main paths, cpg_launches those of its
    # CPG passes (in (c) and (e)), uwsod_launches K1's under UWSOD
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        for site, prefix in (("cpg", "csc_cpg"), ("uwsod", "uwsod")):
            for key, row in csc_rows[site].items():
                if not key.startswith(kind + " "):
                    continue
                tag = f"{prefix}_" + key[len(kind) + 1:].replace(" ", "_")
                line.update({f"{tag}_max_abs_err": row["err"], f"{tag}_ms": row["times"]["new"]["ms"],
                             f"{tag}_device_ms": row["times"]["new"]["device_ms"], f"{tag}_plain_ms": row["plain_ms"],
                             f"{tag}_bound_ms": row["bound_ms"], f"{tag}_bound_by": row["bound_by"]})
        line["csc_launches"] = csc_launches[line["name"]]
        line["cpg_launches"] = cpg_launches_[line["name"]]
    kernels[0]["uwsod_launches"] = uwsod_launches
    # the rows of phase 22(d): the C4 res4 pooler of an 800x1344 pair, (2,
    # 50, 84, 1024) at P=14 (serve 2x1000, the mask branch's 2x100, train
    # 2x512 with K2) and Trident's branch-averaged WSR-18 res5 (serve B=1
    # R=2000, train B=4 R=8000; K1 only). The WSR-50 FPN pools a pyramid of
    # the flagship's shapes (800x1344, C=256): its rows are phase 3's serve
    # box pooler and phase 6's train box pooler in this run. c4_launches,
    # trd_launches and wsr_fpn_launches: each model's launches on phase 22's
    # main paths (serve, train and, for C4, the trainer); c4_trident_fpn_launches
    # all of them
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        for site, prefix in (("c4", "c4"), ("trd", "trd")):
            for key, row in c4_rows[site].items():
                if not key.startswith(kind + " "):
                    continue
                tag = f"{prefix}_" + key[len(kind) + 1:].replace(" ", "_")
                line.update({f"{tag}_max_abs_err": row["err"], f"{tag}_ms": row["times"]["new"]["ms"],
                             f"{tag}_device_ms": row["times"]["new"]["device_ms"], f"{tag}_plain_ms": row["plain_ms"],
                             f"{tag}_bound_ms": row["bound_ms"], f"{tag}_bound_by": row["bound_by"]})
        fpn = {"serve": res, "train": {k[len(kind) + 1:]: v for k, v in tres.items() if k.startswith(kind + " ")}}
        for step, src in fpn.items():
            if kind == "bwd" and step == "serve":
                continue
            for tag in ("f32", "bf16"):
                row = src[f"box pooler {tag}"]
                line.update({f"wsr_fpn_{step}_{tag}_max_abs_err": row["err"],
                             f"wsr_fpn_{step}_{tag}_ms": row["times"]["new"]["ms"],
                             f"wsr_fpn_{step}_{tag}_device_ms": row["times"]["new"]["device_ms"],
                             f"wsr_fpn_{step}_{tag}_plain_ms": row["plain_ms"],
                             f"wsr_fpn_{step}_{tag}_bound_ms": row["bound_ms"],
                             f"wsr_fpn_{step}_{tag}_bound_by": row["bound_by"]})
        for site in ("c4", "trd", "wsr_fpn"):
            line[f"{site}_launches"] = c4_sites[site][line["name"]]
        line["c4_trident_fpn_launches"] = c4_all[line["name"]]
    # the rows of phase 23(d) over an 800x1344 pyramid (C=256, P=7): the
    # cascade's stage-1 and stage-2 pools (R=1000 decoded boxes), its train
    # step's box pool (B=2, 2x512, K1 and K2; three a step) and Fast R-CNN's
    # 1000 precomputed proposals. cascade_launches, dconv_launches and
    # fast_rcnn_launches: each model's launches on phase 23's main paths
    # (serve, train and, for the cascade, the trainer), combined_launches
    # K1's under 23(f), cascade_dconv_launches all of them
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        for site, prefix in (("stage", "cascade"), ("step", "cascade_step"), ("fast", "fast_rcnn")):
            for key, row in cd_rows[site].items():
                if not key.startswith(kind + " "):
                    continue
                tag = f"{prefix}_" + key[len(kind) + 1:].replace(" ", "_")
                line.update({f"{tag}_max_abs_err": row["err"], f"{tag}_ms": row["times"]["new"]["ms"],
                             f"{tag}_device_ms": row["times"]["new"]["device_ms"], f"{tag}_plain_ms": row["plain_ms"],
                             f"{tag}_bound_ms": row["bound_ms"], f"{tag}_bound_by": row["bound_by"]})
        for site in ("cascade", "dconv", "fast_rcnn", "combined"):
            line[f"{site}_launches"] = cd_sites[site][line["name"]]
        line["cascade_dconv_launches"] = cd_all[line["name"]]
    # the rows of phase 24(e), C=256: the LVIS mask pooler (R=300 detections,
    # P=14, over an 800x1344 pyramid; K1 only) and, over a 1024x2048 pyramid,
    # the Cityscapes serving box (R=1000, P=7) and mask (R=100, P=14) poolers
    # and the train step's box (B=2, 2x512, P=7) and mask (B=2, 2x128, P=14)
    # poolers with K2. lvis_launches and city_launches: each model's
    # launches on phase 24's main paths (serve, train, trainer, the gate's
    # scoring on the card), lvis_city_launches all of them
    for line, kind in ((kernels[0], "fwd"), (kernels[1], "bwd")):
        for site, site_rows in lc_rows.items():
            for key, row in site_rows.items():
                if not key.startswith(kind + " "):
                    continue
                tag = f"{site}_" + key[len(kind) + 1:]
                line.update({f"{tag}_max_abs_err": row["err"], f"{tag}_ms": row["times"]["new"]["ms"],
                             f"{tag}_device_ms": row["times"]["new"]["device_ms"], f"{tag}_plain_ms": row["plain_ms"],
                             f"{tag}_bound_ms": row["bound_ms"], f"{tag}_bound_by": row["bound_by"]})
        for site in ("lvis", "city"):
            line[f"{site}_launches"] = lc_sites[site][line["name"]]
        line["lvis_city_launches"] = lc_all[line["name"]]
    # the trainers' launches (phase 14): Mask R-CNN at NUM_WORKERS 0 and 4,
    # the resumed run, the JTSM flagship, the gate's kernel run
    for line in kernels:
        line["tc_launches"] = tc_launches[line["name"]]
    log("[train_cli] " + " ".join(
        f"NUM_WORKERS {w}: s/iter {r['s_iter']:.4f} data_time {r['data_time']:.4f} loader s/batch {r['loader']:.4f} "
        f"mapping s/batch {r['mapping']:.4f} "
        f"peak_gib {r['peak']:.3f};" for w, r in tc_runs.items())
        + f" bare step ms {tc_runs[TC_WORKERS[0]]['bare_ms']:.3f}; JTSM s/iter {tc_jtsm['s_iter']:.4f} data_time "
        f"{tc_jtsm['data_time']:.4f} peak_gib {tc_jtsm['peak']:.3f}; launches {tc_launches}")
    log("[train] median step ms " + " ".join(f"{DTYPE_NAMES[d]}={t[1]:.3f}" for d, t in train.items())
        + f"; K1 launches serve {launches}, train " + str({d: t[0][KERNEL.name] for d, t in train.items()})
        + f", score {score_launches}, jtsm {jtsm_launches}, jtsm score {js_launches}, tta {tta_launches}; "
        "JTSM request mean ms "
        + " ".join(f"{DTYPE_NAMES[d]}={ms:.3f}" for d, ms in jtsm_lat.items())
        + "; JTSM train step median ms " + " ".join(f"{DTYPE_NAMES[d]}={ms:.3f}" for d, ms in jt_med.items())
        + f", launches {jt_launches}")
    log("[families] request mean ms " + " ".join(f"{f} {DTYPE_NAMES[d]}={ms:.3f}" for (f, d), ms in fam_latency.items())
        + f"; K1 launches {fam_launches} (keypoint pooler {kp_launches}) | {card}")
    log("[wsod] request mean ms " + " ".join(f"{case} {DTYPE_NAMES[d]}={ms:.3f}" for (case, d), ms in wsod_lat.items())
        + "; train step median ms " + " ".join(f"{case} {DTYPE_NAMES[d]}={ms:.3f}" for (case, d), ms in wsod_steps.items())
        + "; WSL trainer " + " ".join(f"{case}: s/iter {r['s_iter']:.4f} data_time {r['data_time']:.4f} peak_gib "
                                      f"{r['peak']:.3f};" for case, r in wsod_trainer_runs.items())
        + f" launches {wsod_launches} | {card}")
    log("[dense_train] train step median ms " + " ".join(
        f"{f} {DTYPE_NAMES[d]}={ms:.3f}" for (f, d), ms in dense_med.items()) + f" | {card}")
    log("[families_train] train step median ms " + " ".join(
        f"{f} {DTYPE_NAMES[d]}={ms:.3f}" for (f, d), ms in ft_med.items())
        + f"; keypoint trainer s/iter {kp_trainer['s_iter']:.4f} data_time {kp_trainer['data_time']:.4f} peak_gib "
        f"{kp_trainer['peak']:.3f}; launches {ft_launches} (keypoint {kp_train}, Panoptic FPN {pan_train}) | {card}")
    log("[train_surface] train step median ms " + " ".join(
        f"{f} {DTYPE_NAMES[d]}={ms:.3f}" for (f, d), ms in ts_med.items())
        + "; trainers " + " ".join(f"{k}: s/iter {r['s_iter']:.4f} data_time {r['data_time']:.4f} peak_gib "
                                   f"{r['peak']:.3f};" for k, r in ts_runs.items())
        + f" PreciseBN s {ts_runs['precise_bn']['precise_bn_s']:.4f}; launches {ts_launches} (pred-boxes steps "
        f"{pred_launches}, WSDDN trainer {wsddn_launches}) | {card}")
    log("[wsod_zoo] request mean ms " + " ".join(
        f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in zoo_lat.items())
        + "; train step median ms " + " ".join(f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in zoo_steps.items())
        + f"; CMIL WSR-18 trainer s/iter {zoo_trainer_run['s_iter']:.4f} data_time {zoo_trainer_run['data_time']:.4f} "
        f"peak_gib {zoo_trainer_run['peak']:.3f}; launches {zoo_launches_} by site {zoo_sites} | {card}")
    log("[csc_uwsod] request mean ms " + " ".join(
        f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in csc_lat.items())
        + "; train step median ms (CPG pass included; the pass) " + " ".join(
            f"{name} {DTYPE_NAMES[d]}={ms[0]:.3f} ({ms[1]:.3f})" for (name, d), ms in csc_steps.items())
        + "; WSL trainer " + " ".join(f"{case}: s/iter {r['s_iter']:.4f} data_time {r['data_time']:.4f} peak_gib "
                                      f"{r['peak']:.3f};" for case, r in csc_trainer_runs.items())
        + f" launches {csc_launches} (UWSOD K1 {uwsod_launches}, CPG passes {cpg_launches_}) | {card}")
    log("[c4_trident_fpn] request mean ms " + " ".join(
        f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in c4_lat.items())
        + "; train step median ms " + " ".join(f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in c4_steps.items())
        + f"; C4 trainer s/iter {c4_trainer_run['s_iter']:.4f} data_time {c4_trainer_run['data_time']:.4f} peak_gib "
        f"{c4_trainer_run['peak']:.3f}; launches {c4_all} by model {c4_sites} | {card}")
    log("[cascade_dconv] request mean ms " + " ".join(
        f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in cd_lat.items())
        + "; combined yamls bf16 request ms " + " ".join(f"{name}={ms:.3f};" for name, ms in cd_combined_lat.items())
        + " train step median ms " + " ".join(f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in cd_steps.items())
        + f"; cascade trainer s/iter {cd_trainer_run['s_iter']:.4f} data_time {cd_trainer_run['data_time']:.4f} "
        f"peak_gib {cd_trainer_run['peak']:.3f}; launches {cd_all} by model {cd_sites} | {card}")
    log("[lvis_city] request mean ms " + " ".join(
        f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in lc_lat.items())
        + "; train step median ms " + " ".join(f"{name} {DTYPE_NAMES[d]}={ms:.3f}" for (name, d), ms in lc_steps.items())
        + "; trainers " + " ".join(f"{name}: s/iter {r['s_iter']:.4f} data_time {r['data_time']:.4f} peak_gib "
                                   f"{r['peak']:.3f};" for name, r in lc_trainers.items())
        + f" launches {lc_all} by model {lc_sites} | {card}")
    log(f"[done] {time.perf_counter() - t_run:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
