"""Configuration dataclasses for FedRoute (the PyTorch port's own copy of
``repro.config``, so the port imports nothing of the JAX package).

Three config families:
  * ModelConfig  — one member of the routed LLM pool (the serving substrate).
  * RouterConfig — the paper's MLP / K-means router hyperparameters.
  * FedConfig    — federated simulation protocol (Section 6 of the paper).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model pool configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    # d_ff of each expert (may differ from the dense d_ff field).
    d_expert: int = 0
    # Load-balance auxiliary loss coefficient.
    aux_coef: float = 0.01


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block hyperparameters."""

    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256  # SSD chunk length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    # --- attention options ---
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    # Sliding window used for the long-context decode variant (and, when
    # `sliding_window_always` is set, for every attention layer).
    sliding_window: int = 8192
    sliding_window_always: bool = False
    causal: bool = True  # False for encoder-only (hubert)
    # --- MoE / SSM / hybrid ---
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid: period P means 1 attention layer per P layers (rest mamba).
    hybrid_attn_period: int = 0
    # MoE interleave: 1 = every layer is MoE; 2 = every other layer, etc.
    moe_period: int = 1
    # --- modality frontend (stubbed: inputs arrive as embeddings) ---
    frontend: Optional[str] = None  # None | "audio" | "vision"
    encoder_only: bool = False
    # --- misc ---
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.arch_type == "ssm"

    @property
    def supports_decode(self) -> bool:
        return not self.encoder_only

    @property
    def sub_quadratic(self) -> bool:
        """Whether long_500k is runnable: native (ssm/hybrid) or via the
        sliding-window variant (implemented for all attention archs)."""
        return self.supports_decode

    def reduced(self) -> "ModelConfig":
        """Smoke-test variant: ≤2 layers, d_model ≤ 512, ≤4 experts."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        n_kv = max(1, min(self.n_kv_heads, n_heads))
        # keep q_per_kv ratio >= 1
        n_kv = min(n_kv, n_heads)
        moe = None
        if self.moe is not None:
            moe = dataclasses.replace(
                self.moe, num_experts=min(4, self.moe.num_experts),
                top_k=min(2, self.moe.top_k), d_expert=128)
        ssm = None
        if self.ssm is not None:
            ssm = dataclasses.replace(self.ssm, d_state=16, head_dim=32,
                                      chunk=64)
        n_layers = 2
        if self.hybrid_attn_period:
            n_layers = self.hybrid_attn_period  # one full hybrid group
        return dataclasses.replace(
            self, n_layers=n_layers, d_model=d_model, n_heads=n_heads,
            n_kv_heads=n_kv, d_ff=min(self.d_ff, 512) or 0,
            vocab=min(self.vocab, 512), head_dim=64, moe=moe, ssm=ssm,
            sliding_window=128, dtype="float32")


# ---------------------------------------------------------------------------
# Router / federated configs (paper Section 6 + Appendix C defaults)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    d_emb: int = 768               # all-mpnet-base-v2 dimension
    num_models: int = 11           # RouterBench-Data pool size
    hidden: Tuple[int, ...] = (512, 512)
    dropout: float = 0.1
    # K-means router
    k_local: int = 15
    k_global: int = 20
    n_init: int = 3
    kmeans_iters: int = 30
    c_max: float = 1.0             # costs normalized to [0, c_max]
    # Matrix-factorization router (query-embedding × model-id factors)
    mf_rank: int = 32
    # Elo/ranking router (similarity-weighted one-shot ratings)
    elo_tau: float = 0.15          # kernel bandwidth, units of sqrt(d_emb)
    elo_prior: float = 4.0         # pseudo-count shrinkage to global mean


@dataclasses.dataclass(frozen=True)
class FedConfig:
    num_clients: int = 10
    participation: float = 0.6
    rounds: int = 30
    local_epochs: int = 1
    batch_size: int = 128
    lr: float = 1e-3
    weight_decay: float = 3e-4
    clip_norm: float = 1.0
    dirichlet_alpha: float = 0.6     # query heterogeneity over tasks
    model_alpha: float = 0.45        # per-client model-logging heterogeneity
    train_frac: float = 0.75
    seed: int = 0


# ---------------------------------------------------------------------------
# Input shapes (assigned)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}
