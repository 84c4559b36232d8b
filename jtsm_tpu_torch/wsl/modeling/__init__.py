"""WSL models: the WS-ResNet, VGG and multi-rate VGG backbones, the MIL and
OICR layers, the DAN, the WSOD ROI heads (WSDDN, OICR, PCL, ContextLocNet,
CMIL, CSC, CSC-OICR, WSJDS, UWSOD) and JTSM's, the WSL mask head, the
stuff and ASPP heads, ``RPNWSL``, ``GeneralizedRCNNWSL`` and
``GeneralizedMCNNWSL`` (JAX package ``wsl/modeling/``)."""
