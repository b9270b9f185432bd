"""Tiny configs for tests/examples (fast on one CPU core)."""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig

TINY = register(ModelConfig(
    name="tiny",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    max_seq=512,
    dtype="float32",
    remat=False,
))

TINY_MOE = register(ModelConfig(
    name="tiny-moe",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    n_experts=4,
    shared_expert=True,
    moe_group_size=64,
    max_seq=512,
    dtype="float32",
    remat=False,
))
