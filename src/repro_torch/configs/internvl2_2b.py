"""internvl2-2b — VLM: InternViT + InternLM2 backbone [arXiv:2404.16821].

24L d_model=2048 16H (GQA kv=8) d_ff=8192 vocab=92553. The InternViT vision
encoder + projector is stubbed: ``input_specs`` provides precomputed patch
embeddings interleaved with text embeddings; we implement the LM backbone.
"""
from repro_torch.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    arch_type="vlm",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=8192,
    vocab=92553,
    head_dim=128,
    frontend="vision",
)
