"""PyTorch and CUDA port of the ``jtsm_tpu`` JAX package.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``layers``, ``structures``, ``ops``, ``modeling``,
``checkpoint``, ``data``, ``evaluation``, ``engine``, ``tools``), imports
nothing of it, and runs on an NVIDIA card unless the caller passes
``device="cpu"``. The slices ported so far are Mask R-CNN R50-FPN
inference, its training step and its scoring on COCO-format data
(``engine.test``, ``python -m jtsm_tpu_torch.tools.train_net --eval-only``),
and the serving of the JTSM flagship (``wsl``), with the multilevel ROIAlign
forward and backward as hand-written CUDA kernels
(``ops/csrc/roi_align_fwd.cu``, ``ops/csrc/roi_align_bwd.cu``).
"""
