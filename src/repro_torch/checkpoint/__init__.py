"""Checkpoints in the JAX package's format: the msgpack codec and the tensor store."""
