"""Models of the port: attention, the Vision Transformer, the ResNets and
their layers."""
