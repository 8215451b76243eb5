"""qwen2-1.5b — dense GQA with QKV bias [arXiv:2407.10671].

28L d_model=1536 12H (GQA kv=2) d_ff=8960 vocab=151936, bias on QKV proj.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    arch_type="dense",
    n_layers=28,
    d_model=1536,
    n_heads=12,
    n_kv_heads=2,
    d_ff=8960,
    vocab=151936,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1_000_000.0,
)
