"""jamba-1.5-large-398b — hybrid Mamba+attention 1:7, MoE [arXiv:2403.19887].

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16 experts top-2.
One attention layer per 8 layers (rest Mamba2 blocks); MoE every other layer.
Native sub-quadratic ⇒ runs long_500k.
"""
from repro_torch.config import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    arch_type="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    head_dim=128,
    hybrid_attn_period=8,
    moe=MoEConfig(num_experts=16, top_k=2, d_expert=24576),
    moe_period=2,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
