"""The benchmark's operation and byte counts against hand counts at a
small shape."""
import pytest

from perfbench import costs

DENSE = {"num_hidden_layers": 2, "hidden_size": 8, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 2, "intermediate_size": 12,
         "vocab_size": 10, "torch_dtype": "bfloat16", "qkv_bias": True}
MOE = dict(DENSE, num_local_experts=4, num_experts_per_tok=2)


def test_matmul_flops_by_hand():
    # q 8→8, k 8→4, v 8→4, o 8→8: 2·(64 + 32 + 32 + 64) = 384 a layer;
    # SwiGLU 3 · 2 · 8 · 12 = 576 a layer
    assert costs.matmul_flops_per_token(DENSE) == 2 * (384 + 576)
    # top-2 of 4 experts: 2 · 576, and the router 2 · 8 · 4 = 64
    assert costs.matmul_flops_per_token(MOE) == 2 * (384 + 1152 + 64)
    assert costs.unembed_flops(DENSE) == 160
    # q·k and p·v over 5 keys: 4 · 5 · 4 heads · 2 dims · 2 layers
    assert costs.attn_flops(DENSE, 5) == 320


def test_prefill_and_decode_by_hand():
    mm = costs.matmul_flops_per_token(DENSE)
    a1 = costs.attn_flops(DENSE, 1)
    # 3 real tokens attend to 1, 2, 3 keys; one position unembedded
    assert costs.prefill_flops(DENSE, 3) == 3 * mm + 6 * a1 + 160
    # a token written at position 3 attends 4 keys and is unembedded
    assert costs.decode_passes_flops(DENSE, 3, 1) == mm + 4 * a1 + 160
    assert costs.decode_passes_flops(DENSE, 3, 3) == sum(
        costs.decode_passes_flops(DENSE, p, 1) for p in (3, 4, 5))


def test_paged_decode_cost_by_hand():
    # rows with 5, 1 and 16 valid positions, pages of 4
    f, b = costs.paged_decode_cost(DENSE, [5, 1, 16], 4)
    pos = 22
    assert f == 4 * pos * 4 * 2
    q_out = 2 * 3 * 4 * 2 * 2          # q read and out written, bf16
    kv = 2 * pos * 2 * 2 * 2           # K and V, 2 KV heads, hd 2, bf16
    assert b == q_out + kv + 4 * 3 + 4 * (2 + 1 + 4)
    assert costs.least_seconds(f, b) == pytest.approx(
        b / costs.PEAK_HBM_BYTES)
    assert costs.least_seconds(1e15, 1.0) == pytest.approx(
        1e15 / costs.PEAK_BF16_FLOPS)
