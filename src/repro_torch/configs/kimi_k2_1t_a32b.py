"""kimi-k2-1t-a32b [moe] — trillion-param MoE, 384e top-8 + 1 shared
expert, expert d_ff=2048 (arXiv:2501.kimi2)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    n_experts=384,
    moe_topk=8,
    n_shared_experts=1,
)
