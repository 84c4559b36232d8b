"""PyTorch and CUDA port of the ``jtsm_tpu`` JAX package.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``layers``, ``structures``, ``ops``, ``modeling``,
``checkpoint``, ``engine``), imports nothing of it, and runs on an NVIDIA
card unless the caller passes ``device="cpu"``. The slice ported so far is
Mask R-CNN R50-FPN inference, with the multilevel ROIAlign forward as a
hand-written CUDA kernel (``ops/csrc/roi_align_fwd.cu``).
"""
