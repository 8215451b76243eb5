"""yi-34b — dense llama-arch GQA [arXiv:2403.04652].

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000.
long_500k served via the sliding-window decode variant (window 8192).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    arch_type="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=20480,
    vocab=64000,
    head_dim=128,
)
