"""hubert-xlarge — encoder-only audio transformer [arXiv:2106.07447].

48L d_model=1280 16H (GQA kv=16 ⇒ MHA) d_ff=5120 vocab=504 (codebook targets).
The conv/mel frontend is stubbed: ``input_specs`` provides precomputed frame
embeddings. Encoder-only ⇒ no decode shapes (see DESIGN.md §Arch-applicability).
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    arch_type="audio",
    n_layers=48,
    d_model=1280,
    n_heads=16,
    n_kv_heads=16,
    d_ff=5120,
    vocab=504,
    head_dim=80,
    causal=False,
    encoder_only=True,
    frontend="audio",
    rope_theta=10_000.0,
)
