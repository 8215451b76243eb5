"""Architecture config registry.

Every assigned architecture is a selectable config (``--arch <id>``); each
cites its source in its module docstring. ``get_config`` returns the full
(production) config; ``get_config(id).reduced()`` is the smoke-test variant.
"""
from __future__ import annotations

from repro_torch.config import ModelConfig

from repro_torch.configs.hubert_xlarge import CONFIG as _hubert
from repro_torch.configs.jamba_1_5_large_398b import CONFIG as _jamba
from repro_torch.configs.yi_34b import CONFIG as _yi34
from repro_torch.configs.phi3_5_moe_42b_a6_6b import CONFIG as _phi
from repro_torch.configs.internvl2_2b import CONFIG as _internvl
from repro_torch.configs.kimi_k2_1t_a32b import CONFIG as _kimi
from repro_torch.configs.yi_6b import CONFIG as _yi6
from repro_torch.configs.qwen3_8b import CONFIG as _qwen3
from repro_torch.configs.mamba2_370m import CONFIG as _mamba2
from repro_torch.configs.qwen2_1_5b import CONFIG as _qwen2

REGISTRY: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        _hubert, _jamba, _yi34, _phi, _internvl,
        _kimi, _yi6, _qwen3, _mamba2, _qwen2,
    ]
}


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def list_archs() -> list[str]:
    return sorted(REGISTRY)
