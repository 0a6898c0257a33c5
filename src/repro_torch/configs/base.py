"""Model configuration: the port's own copy of ``repro.configs.base``.

:class:`ModelConfig` holds the fields of the JAX package's dataclass
that the ported families read, with the same names, defaults and
derived values (``head_dim``, ``padded_vocab``, ``reduced()``), so a
config here and the one of the same arch there describe the same model.
Only the dense family runs in the port so far; the fields of the other
families come with them.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description."""

    name: str
    family: str  # dense (the only family ported so far)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"
    gated_mlp: bool = True
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    attn_q_chunk: int = 1024  # full-sequence attention's query chunk (memory lever)

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.n_heads, 1))

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256; logits of the padded
        ids are masked at the unembedding."""
        return -(-self.vocab // 256) * 256

    def reduced(self, **overrides) -> ModelConfig:
        """A tiny same-family variant for CPU tests (the JAX package's
        cut for the dense family: 2 layers, d 128, fp32)."""
        small = dict(
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab=512,
            dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)
