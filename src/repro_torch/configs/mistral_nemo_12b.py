"""mistral-nemo-12b [dense] — 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072 — 128k ctx.  [hf:mistralai/Mistral-Nemo-Base-2407; hf]"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    mlp_kind="gated_silu",
    rope_theta=1_000_000.0,
    max_seq=131_072,
    tie_embeddings=False,
))
