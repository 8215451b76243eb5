"""kimi-k2-1t-a32b — trillion-parameter MoE [arXiv:2501.kimi2].

61L d_model=7168 64H (GQA kv=8) d_ff=2048 (per-expert) vocab=163840,
MoE 384 experts top-8. Expert-parallel over the "model" mesh axis
(24 experts/chip on a 16-way axis).
"""
from repro_torch.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    arch_type="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab=163840,
    head_dim=112,
    moe=MoEConfig(num_experts=384, top_k=8, d_expert=2048),
)
