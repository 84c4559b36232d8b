"""PyTorch and CUDA port of the ``jtsm_tpu`` JAX package.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``layers``, ``structures``, ``ops``, ``modeling``,
``checkpoint``, ``engine``), imports nothing of it, and runs on an NVIDIA
card unless the caller passes ``device="cpu"``. The slices ported so far are
Mask R-CNN R50-FPN inference and its training step, with the multilevel
ROIAlign forward and backward as hand-written CUDA kernels
(``ops/csrc/roi_align_fwd.cu``, ``ops/csrc/roi_align_bwd.cu``).
"""
