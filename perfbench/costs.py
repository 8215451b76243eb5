"""The benchmark's own operation and byte counts, from a cell's shapes,
and the chip's peaks. The same work is counted whatever implements it:

* a prefill counts the real prompt tokens, not the pow2 bucket's padding,
  and unembeds one position (the engine's ``last_pos``);
* a decode pass counts one token, its attention at the row's valid
  context, and the unembedding;
* a mixture-of-experts layer counts its top-k experts per token and the
  router, not every expert (the dense dispatch computes all of them);
* one paged decode-attention launch reads each valid K and V position
  once, q once, writes the output once, and reads n_valid and the page
  table entries the valid positions need (``chip_smoke._attn_cost``'s
  rule: only valid positions are read).

Peaks: NVIDIA's H100 SXM data sheet, dense bf16 989 TFLOP/s, HBM3
3.35 TB/s, at the full 700 W power limit (the result line records the
card's limit beside them).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def matmul_flops_per_token(m: dict) -> int:
    """FLOPs of one token through every layer's projections and FFN (the
    active experts and the router for a mixture), without attention's
    context-dependent part and without the unembedding."""
    d, hq, hkv, hd = (m["hidden_size"], m["num_attention_heads"],
                      m["num_key_value_heads"], m["head_dim"])
    f = m["intermediate_size"]
    attn = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    E = int(m.get("num_local_experts", 0))
    if E:
        ffn = m["num_experts_per_tok"] * 3 * 2 * d * f + 2 * d * E
    else:
        ffn = 3 * 2 * d * f
    return m["num_hidden_layers"] * (attn + ffn)


def attn_flops(m: dict, n_keys: int) -> int:
    """q·k and p·v of one query over ``n_keys`` positions, every layer."""
    return (4 * n_keys * m["num_attention_heads"] * m["head_dim"]
            * m["num_hidden_layers"])


def unembed_flops(m: dict) -> int:
    return 2 * m["hidden_size"] * m["vocab_size"]


def prefill_flops(m: dict, P: int) -> int:
    """A causal prefill of P real tokens, unembedding the last."""
    keys = P * (P + 1) // 2
    return (P * matmul_flops_per_token(m) + attn_flops(m, 1) * keys
            + unembed_flops(m))


def decode_passes_flops(m: dict, pos0: int, k: int) -> int:
    """k decode passes at positions pos0 .. pos0 + k - 1."""
    keys = k * (pos0 + 1) + k * (k - 1) // 2
    return (k * (matmul_flops_per_token(m) + unembed_flops(m))
            + attn_flops(m, 1) * keys)


def paged_decode_cost(m: dict, n_valid, page_size: int) -> tuple:
    """(FLOPs, bytes) of one ``paged_decode_attention`` launch (one layer)
    over rows with valid lengths ``n_valid`` (an iterable of ints), bf16
    q, cache and output."""
    hq, hkv, hd = (m["num_attention_heads"], m["num_key_value_heads"],
                   m["head_dim"])
    nv = [int(v) for v in n_valid]
    pos = sum(nv)
    pages = sum(-(-v // page_size) for v in nv)
    B = len(nv)
    flops = 4 * pos * hq * hd
    nbytes = (2 * B * hq * hd * 2 + 2 * pos * hkv * hd * 2 + 4 * B
              + 4 * pages)
    return flops, nbytes


def least_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of the compute and
    the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)
