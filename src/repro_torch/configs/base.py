"""Model configuration: the port's own copy of ``repro.configs.base``.

:class:`ModelConfig` holds the fields of the JAX package's dataclass
that the ported families read, with the same names, defaults and
derived values (``head_dim``, ``padded_vocab``, ``is_moe``, ``is_ssm``,
``d_inner``, ``n_ssm_heads``, ``param_count()``,
``active_param_count()``, ``reduced()``), so a config here and the one
of the same arch there describe the same model. Every family of the JAX
package is ported: dense, moe, ssm, hybrid, the encoder-decoder (the
encoder's depth and fixed length) and the VLM (its patch prefix).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description."""

    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: int = 0  # 0 -> d_model // n_heads
    qkv_bias: bool = False
    act: str = "silu"  # silu | gelu | relu2
    gated_mlp: bool = True  # False: the 2-matrix MLP (nemotron's relu2, whisper)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5

    # MoE
    n_experts: int = 0
    moe_topk: int = 0
    n_shared_experts: int = 0
    moe_every: int = 1  # MoE on layers where layer % moe_every == moe_offset
    moe_offset: int = 0
    capacity_factor: float = 1.25
    moe_dp_groups: int = 0  # >0: DP-local dispatch (meshes; not ported yet)

    # SSM / hybrid
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 256
    attn_every: int = 0  # hybrid: one attention layer per this many (jamba 8)

    # encoder-decoder
    n_enc_layers: int = 0
    enc_seq: int = 0  # fixed encoder length (whisper: 1500 frames)

    # VLM
    n_patches: int = 0  # prefix length of the stub patch embeddings

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

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def n_ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks), for 6ND; the
        JAX package's formula."""
        d, v = self.d_model, self.vocab
        emb = 2 * v * d  # tok + unembed
        per_attn = (
            2 * self.n_heads * self.head_dim * d  # q, o
            + 2 * self.n_kv_heads * self.head_dim * d  # k, v
        )
        per_mlp = (3 if self.gated_mlp else 2) * d * self.d_ff
        per_moe = (self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff + d * self.n_experts
        per_ssm = (
            d * (2 * self.d_inner + 2 * self.ssm_state + self.n_ssm_heads)
            + self.d_inner * d
        )
        total = emb
        for i in range(self.n_layers):
            if self.family == "ssm":
                total += per_ssm
                continue
            is_attn = (self.attn_every == 0) or (i % self.attn_every == 0)
            if self.family == "hybrid":
                total += per_attn if is_attn else per_ssm
            else:
                total += per_attn
            if self.is_moe and (i % self.moe_every == self.moe_offset):
                total += per_moe
            else:
                total += per_mlp
        total += self.n_enc_layers * (per_attn + per_mlp)
        return int(total)

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top-k + shared)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        full_moe = (self.n_experts + self.n_shared_experts) * 3 * d * self.d_ff + d * self.n_experts
        act_moe = (self.moe_topk + self.n_shared_experts) * 3 * d * self.d_ff + d * self.n_experts
        n_moe_layers = sum(
            1 for i in range(self.n_layers) if i % self.moe_every == self.moe_offset
        )
        return self.param_count() - n_moe_layers * (full_moe - act_moe)

    def reduced(self, **overrides) -> ModelConfig:
        """A tiny same-family variant for CPU tests, the JAX package's cut:
        d 128, 2 layers (4 with ``attn_every=2`` for hybrids), at most 4
        experts of which top-2, state 16, head dim 32, chunk 16, at most 2
        encoder layers of 32 frames and 8 patches, fp32."""
        small = dict(
            n_layers=min(self.n_layers, 4 if self.attn_every else 2),
            d_model=128,
            n_heads=4,
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            moe_topk=min(self.moe_topk, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=32 if self.ssm_state else self.ssm_headdim,
            ssm_chunk=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=min(self.enc_seq, 32) if self.enc_seq else 0,
            n_patches=min(self.n_patches, 8) if self.n_patches else 0,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            dtype="float32",
        )
        if self.attn_every:
            small["n_layers"] = self.attn_every * 2 if self.attn_every <= 2 else 4
            small["attn_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)
