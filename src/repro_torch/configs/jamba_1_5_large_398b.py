"""jamba-1.5-large-398b [hybrid] — Mamba+attn 1:7, MoE 16e top-2 every
other layer (arXiv:2403.19887)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    n_experts=16,
    moe_topk=2,
    moe_every=2,
    moe_offset=1,
    attn_every=8,
    ssm_state=128,
    ssm_headdim=64,
)
