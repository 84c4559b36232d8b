"""WSL models: the WS-ResNet backbones, the MIL and OICR layers, the DAN,
the JTSM ROI heads, the WSL mask head, the stuff heads and
``GeneralizedMCNNWSL`` (JAX package ``wsl/modeling/``)."""
