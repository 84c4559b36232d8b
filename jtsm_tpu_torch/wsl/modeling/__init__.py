"""WSL models: the WS-ResNet (with its multi-rate form and FPN), VGG and
multi-rate VGG backbones, the MIL and OICR layers, the DAN, the WSOD ROI
heads (WSDDN, OICR, PCL, ContextLocNet, CMIL, CSC, CSC-OICR, WSJDS, UWSOD,
the multi-rate and Trident OICR and multi-rate WSDDN) and JTSM's, the
fully supervised ``WSRes5ROIHeads``, the WSL mask head, the stuff and ASPP
heads, ``RPNWSL``, ``GeneralizedRCNNWSL`` and ``GeneralizedMCNNWSL`` (JAX
package ``wsl/modeling/``)."""
