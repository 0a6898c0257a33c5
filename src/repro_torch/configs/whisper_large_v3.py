"""whisper-large-v3 [audio] — the encoder-decoder backbone; the conv/audio
frontend is a stub (the encoder takes frame embeddings) (arXiv:2212.04356).
32 encoder + 32 decoder layers; the encoder length is Whisper's native
1500 frames."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3",
    family="encdec",
    n_layers=32,
    n_enc_layers=32,
    enc_seq=1500,
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    head_dim=64,
    act="gelu",
    gated_mlp=False,
)
