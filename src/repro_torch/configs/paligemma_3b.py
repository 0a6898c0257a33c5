"""paligemma-3b [vlm] — the SigLIP frontend stubbed (precomputed patch
embeddings), the gemma backbone (arXiv:2407.07726)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    act="gelu",
    n_patches=256,
)
