"""Model configurations of the ported architectures."""
