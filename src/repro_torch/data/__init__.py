"""Deterministic synthetic data: the same numpy batches as the JAX package."""
