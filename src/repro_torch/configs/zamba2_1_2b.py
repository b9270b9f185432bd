"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192,
ssm_state=64 — Mamba2 trunk + shared attention blocks.
[arXiv:2411.15242; hf]

The single shared transformer block (attention + MLP over
concat([hidden, embeddings]), 2*d wide) is invoked every 6 mamba layers
with a per-site LoRA (rank 128) on the query projection; its weights are
reused 7x per step, which the HeteGen module scheduler exploits
(gain g scales with calls).
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    shared_attn_period=6,
    shared_lora_rank=128,
    mlp_kind="gated_silu",
    rope_theta=10_000.0,
    max_seq=524_288,
    tie_embeddings=True,
))
