"""llava-next-mistral-7b [vlm] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — anyres tiling.  [hf:llava-hf/llava-v1.6-mistral-7b-hf;
unverified]

The assigned entry specifies the transformer BACKBONE only; the anyres
vision frontend is a stub — :func:`repro_torch.configs.shapes.input_specs`
provides precomputed patch embeddings (B, S, d_model) for train/prefill;
decode consumes tokens.
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    embeds_input=True,
    mlp_kind="gated_silu",
    rope_theta=1_000_000.0,
    max_seq=32_768,
    tie_embeddings=False,
))
