"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 vocab=202048, MoE 128e top-1, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Interpretation notes: experts alternate with dense FFN
layers (moe_layer_period=2) so the assigned totals reconcile with ~400B
total / ~17B active; a shared (always-on) expert accompanies the routed
top-1 expert, per the Llama-4 family design.  Text-only inputs (the "early
fusion" frontend is outside the assigned backbone).
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    n_experts=128,
    top_k=1,
    shared_expert=True,
    moe_layer_period=2,
    qk_norm=True,
    rope_theta=500_000.0,
    max_seq=131_072,
    mlp_kind="gated_silu",
    tie_embeddings=False,
    optimizer="adafactor",
    fsdp=True,
))
