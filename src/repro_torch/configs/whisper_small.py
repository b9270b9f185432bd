"""whisper-small [audio] — 12L d_model=768 12H (kv=12) d_ff=3072
vocab=51865 — enc-dec, conv frontend (stub).  [arXiv:2212.04356;
unverified]

The conv1d+log-mel frontend is a stub: :func:`repro_torch.configs.shapes.
input_specs` provides precomputed frame embeddings (B, 1500, d).  The
assigned decode shapes (32k) exceed Whisper's published 448 decoder
positions — the learned position table is sized to the assignment
(synthetic), as in the JAX package.
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="whisper-small",
    family="encdec",
    n_layers=12,
    encoder_layers=12,
    encoder_seq=1500,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=51865,
    pos_emb="learned",
    norm_kind="layernorm",
    mlp_kind="gelu",
    attn_bias=True,
    max_seq=32_768,
    tie_embeddings=True,
))
