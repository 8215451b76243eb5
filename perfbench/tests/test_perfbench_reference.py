"""The frozen reference against the port's CPU path at reduced sizes, and
the benchmark's weights in the port's parameter tree."""
import numpy as np
import pytest
import torch

from perfbench import bench, weights
from perfbench.reference import model as ref


def _model(moe: bool, dtype: str = "float32", **kw) -> dict:
    m = {"name": "tiny-moe" if moe else "tiny", "cost_per_token": 0.1,
         "torch_dtype": dtype, "num_hidden_layers": 3, "hidden_size": 64,
         "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
         "intermediate_size": 96, "vocab_size": 257, "rope_theta": 1e4,
         "rms_norm_eps": 1e-5, "qkv_bias": not moe}
    if moe:
        m.update(num_local_experts=4, num_experts_per_tok=2)
    m.update(kw)
    return m


def _tree(t):
    if isinstance(t, dict):
        return {k: _tree(v) for k, v in t.items()}
    return (tuple(t.shape), t.dtype)


@pytest.mark.parametrize("moe", [False, True])
def test_weights_have_the_ports_tree(moe):
    from repro_torch.models import model as mdl
    m = _model(moe, "bfloat16")
    ours = weights.make_params(m, 5, 0, "cpu")
    port = mdl.init_params(0, bench.port_config(m), device="meta")
    assert _tree(ours) == _tree(port)
    again = weights.make_params(m, 5, 0, "cpu")
    other = weights.make_params(m, 6, 0, "cpu")
    for a, b, c in zip(_leaves(ours), _leaves(again), _leaves(other)):
        assert torch.equal(a, b)
        assert not torch.equal(a, c)


def _leaves(t):
    if isinstance(t, dict):
        for v in t.values():
            yield from _leaves(v)
    else:
        yield t


@pytest.mark.parametrize("moe", [False, True])
def test_reference_logits_match_the_ports_forward(moe):
    from repro_torch.models import model as mdl
    m = _model(moe)
    params = weights.make_params(m, 11, 1, "cpu")
    gen = torch.Generator().manual_seed(3)
    seqs = [torch.randint(1, 257, (n,), generator=gen) for n in (9, 17)]
    got = ref.logits(m, params, seqs, [0, 4])
    for s, lg in zip(seqs, got):
        full, _ = mdl.forward(params, bench.port_config(m), tokens=s[None],
                              q_chunk=4)
        torch.testing.assert_close(lg, full[0, -len(lg):].float(),
                                   rtol=2e-4, atol=2e-4)


def test_fp8_control_is_a_lower_precision_reading():
    m = _model(False)
    params = weights.make_params(m, 2, 0, "cpu")
    s = [torch.arange(1, 30)]
    f32 = ref.logits(m, params, s, [0])[0]
    fp8 = ref.logits(m, params, s, [0], precision="fp8")[0]
    err = (fp8 - f32).abs().max().item()
    assert 1e-3 < err < 1.0
    x = torch.randn(5, 7)
    r = ref.fp8_round(x, -1)
    assert torch.all((r - x).abs() <= x.abs().amax(-1, keepdim=True) / 16)


def test_reference_router_matches_the_ports_router():
    from repro_torch import routers
    from repro_torch.config import RouterConfig
    r = {"family": "mlp", "d_emb": 32, "hidden": [16, 16], "seed": 4}
    state = weights.router_state(r, [0.05, 0.4, 0.2], "cpu")
    port = routers.make("mlp", RouterConfig(d_emb=32, num_models=3,
                                            hidden=(16, 16)), state=state)
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(1))
    for lam in (0.0, 0.3, 2.0):
        U = ref.router_utility(state, x, torch.full((64,), lam))
        A, C = port.predict(x)
        torch.testing.assert_close(U, A - lam * C, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(port.route(x, lam).numpy(),
                                      U.argmax(1).numpy())
