"""WSL models: the WS-ResNet and VGG backbones, the MIL and OICR layers,
the DAN, the WSDDN, OICR, PCL and JTSM ROI heads, the WSL mask head, the
stuff heads, ``GeneralizedRCNNWSL`` and ``GeneralizedMCNNWSL`` (JAX
package ``wsl/modeling/``)."""
