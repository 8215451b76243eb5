"""mamba2-370m — attention-free SSM, SSD (state-space duality) [arXiv:2405.21060].

48L d_model=1024, ssm_state=128, vocab=50280. d_ff=0 (no MLP; the Mamba2
block's gated expansion x2 plays that role).
"""
from repro_torch.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=32,        # SSD heads = expand*d_model / head_dim
    n_kv_heads=32,
    d_ff=0,
    vocab=50280,
    head_dim=64,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk=256),
)
