"""llama4-scout-17b-a16e [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Every layer is MoE (16 routed experts, top-1) plus a shared expert —
~109B total / ~17B active, matching the published Scout totals.
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=16,
    top_k=1,
    shared_expert=True,
    moe_layer_period=1,
    qk_norm=True,
    rope_theta=500_000.0,
    max_seq=131_072,
    mlp_kind="gated_silu",
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
))
