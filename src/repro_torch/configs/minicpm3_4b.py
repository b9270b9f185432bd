"""minicpm3-4b [dense] — 62L d_model=2560 40H (GQA kv=40) d_ff=6400
vocab=73448 — MLA.  [hf:openbmb/MiniCPM3-4B; hf]

MLA dims from the published config: q_lora 768, kv_lora 256, qk_nope 64,
qk_rope 32, v_head 64.  The compressed cache stores (latent 256 + rope 32)
per token; decode uses the weight-absorption identity (layers.mla_attend).
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,
    d_ff=6400,
    vocab_size=73448,
    attn_kind="mla",
    q_lora_rank=768,
    kv_lora_rank=256,
    qk_nope_dim=64,
    qk_rope_dim=32,
    v_head_dim=64,
    mlp_kind="gated_silu",
    rope_theta=10_000.0,
    max_seq=32_768,
    tie_embeddings=True,
))
