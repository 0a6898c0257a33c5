"""Model layers, the decoder stack and the top-level LM, and the ResNets."""
