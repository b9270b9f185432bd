"""OPT family (Zhang et al., 2022) — the paper's evaluation models.

Used by the paper-reproduction benchmarks (Fig. 8, Tables 2-3): HeteGen
offloads OPT-6.7B/13B/30B on the A10+Xeon hardware model.  opt-125m /
opt-1.3b serve as runnable CPU-scale models for the end-to-end examples.
"""
from repro_torch.configs import register
from repro_torch.models.config import ModelConfig


def _opt(name, layers, d, heads, ffn):
    return register(ModelConfig(
        name=name,
        family="dense",
        n_layers=layers,
        d_model=d,
        n_heads=heads,
        n_kv_heads=heads,
        d_ff=ffn,
        vocab_size=50272,
        pos_emb="learned",
        norm_kind="layernorm",
        mlp_kind="relu",
        attn_bias=True,
        max_seq=2048,
        tie_embeddings=True,
        dtype="float32",
    ))


OPT_125M = _opt("opt-125m", 12, 768, 12, 3072)
OPT_1_3B = _opt("opt-1.3b", 24, 2048, 32, 8192)
OPT_6_7B = _opt("opt-6.7b", 32, 4096, 32, 16384)
OPT_13B = _opt("opt-13b", 40, 5120, 40, 20480)
OPT_30B = _opt("opt-30b", 48, 7168, 56, 28672)
