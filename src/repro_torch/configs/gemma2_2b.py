"""gemma2-2b [dense] — 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating, logit softcap.
[arXiv:2408.00118; hf]"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="gemma2-2b",
    family="dense",
    n_layers=26,
    d_model=2304,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=9216,
    vocab_size=256000,
    layer_pattern="LG",          # local (4k sliding window) / global
    window=4096,
    attn_softcap=50.0,
    logit_softcap=30.0,
    post_norm=True,              # sandwich norms, (1+w) rmsnorm
    emb_scale=True,
    mlp_kind="gated_gelu",
    rope_theta=10_000.0,
    max_seq=8192,
    tie_embeddings=True,
))
