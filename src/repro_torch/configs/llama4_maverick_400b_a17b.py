"""llama4-maverick-400b-a17b [moe] — MoE 128e top-1 + shared expert,
early fusion (hf:meta-llama/Llama-4)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    head_dim=128,
    n_experts=128,
    moe_topk=1,
    n_shared_experts=1,
    moe_every=2,   # Maverick interleaves dense / MoE layers
    moe_offset=1,
)
