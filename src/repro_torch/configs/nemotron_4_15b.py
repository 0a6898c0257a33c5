"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP (arXiv:2402.16819)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    n_layers=32,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=24576,
    vocab=256000,
    head_dim=128,
    act="relu2",
    gated_mlp=False,
)
