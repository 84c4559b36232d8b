"""PyTorch and CUDA port of the ``jtsm_tpu`` JAX package.

The JAX package stays the reference; this package mirrors its layout
(``config``, ``layers``, ``structures``, ``ops``, ``modeling``,
``checkpoint``, ``data``, ``evaluation``, ``engine``, ``utils``,
``tools``), imports nothing of it, and runs on an NVIDIA card unless the
caller passes ``device="cpu"``. The slices ported so far are Mask R-CNN
R50-FPN and the JTSM flagship (``wsl``): serving, training from the
command line (``python -m jtsm_tpu_torch.tools.train_net``, ``python -m
jtsm_tpu_torch.wsl.train_net``: the train loaders, ``engine.DefaultTrainer``,
checkpoints and resume) and scoring (``--eval-only``, with test-time
augmentation), with the multilevel ROIAlign forward and backward as
hand-written CUDA kernels (``ops/csrc/roi_align_fwd.cu``,
``ops/csrc/roi_align_bwd.cu``).
"""
