"""A whole run of the harness at a tiny size on the CPU (past the look
for a card): sound, ``correct`` is true; with the timed path broken
underneath, ``correct`` comes out false, once per fault a serving cell
can have; and the fp8 control reads well above the port. Plus the part
that needs the card, which skips here."""
import copy

import numpy as np
import pytest
import torch

from perfbench import bench, calibrate
from perfbench import run as R


def _model(name, V=512, cost=0.1):
    m = {"name": name, "cost_per_token": cost, "torch_dtype": "bfloat16",
         "num_hidden_layers": 2, "hidden_size": 64, "num_attention_heads": 4,
         "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 96,
         "vocab_size": V, "rope_theta": 1e4, "rms_norm_eps": 1e-5,
         "qkv_bias": V > 400}
    return m


def tiny_parts(workload="dense-chat") -> dict:
    """A cell of the real spec with a tiny pool of two dense models (as
    the cells' pool) and its mix cut to the CPU's size; limits as the
    cell's own."""
    parts = copy.deepcopy(R.load(workload))
    parts["config"] = {
        "name": "tiny",
        "models": [_model("small", cost=0.05), _model("large", V=300,
                                                      cost=0.4)],
        "router": {"family": "mlp", "d_emb": 32, "hidden": [16, 16],
                   "seed": 3},
        "engine": {"slots": 4, "page_size": 4, "chunk": 4,
                   "reserve": "lifetime"}}
    mix = parts["mix"]
    small = {"prompt": {"median": 12, "sigma": 0.5, "min": 3, "max": 24},
             "output": {"median": 10, "sigma": 0.5, "min": 4, "max": 16},
             "max_seq": 48, "check_requests": 1000, "check_tokens": 40,
             "trace_s": 0.3,
             "lam": {"min": 0.0, "max": 0.6}}
    if mix["loop"] == "open":
        small.update(rate_per_s=60, warm_s=0.5)
    else:
        small.update(backlog=12, ramp_per_step=4, block=16, warm_steps=8)
    mix.update(small)
    return parts


def _run(parts, seed=2 ** 31 + 5, traced=False):
    return R.run_cell(parts, seed, 3.0, traced, "cpu")


@pytest.mark.parametrize("workload", ["dense-chat", "dense-docs"])
def test_sound_run_is_correct(workload):
    got = _run(tiny_parts(workload))
    res = got["result"]
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert got["info"]["sampled_tokens"] >= 40
    # both models served
    assert {int(m) for m in got["record"]["req"]["model"]} == {0, 1}
    names = {m["name"] for m in bench.metrics_for(
        bench.load_spec(), workload, False)}
    assert set(res["metrics"]) == names


def test_traced_run_reads_the_per_layer_metrics():
    got = _run(tiny_parts(), traced=True)
    res = got["result"]
    assert res["correct"]
    # the CPU run has no device trace: the device readers find nothing
    assert {"gateway.submit_ms", "engine.step_ms.chat",
            "mfu.chat"} <= set(res["metrics"])
    assert "device.idle_share.chat" not in res["metrics"]
    assert "busy_s" in res["device"] and "breakdown" in res


def _alter_tokens(monkeypatch):
    from repro_torch.serve import gateway
    real = gateway.RoutedServer.step

    def step(self):
        out = real(self)
        for _, p in out:
            if isinstance(p, np.ndarray) and len(p) > 2:
                p[2] = (p[2] + 1) % 300
        return out
    monkeypatch.setattr(gateway.RoutedServer, "step", step)


def _skip_state(monkeypatch):
    from repro_torch.serve import engine
    monkeypatch.setattr(engine, "write_prefill_pages", lambda *a, **k: None)


def _half_batch(monkeypatch):
    from repro_torch.models import model as mdl
    real = mdl.decode_step_paged

    def half(params, cache, cfg, *, tokens, page_table, pos, **kw):
        h = tokens.shape[0] // 2
        logits, c = real(params, cache, cfg, tokens=tokens[:h],
                         page_table=page_table[:h], pos=pos[:h], **kw)
        rest = torch.zeros((tokens.shape[0] - h,) + logits.shape[1:],
                           dtype=logits.dtype)
        return torch.cat([logits, rest]), c
    monkeypatch.setattr(mdl, "decode_step_paged", half)


def _wrong_route(monkeypatch):
    from repro_torch.routers import mlp
    real = mlp.MLPRouter.route
    monkeypatch.setattr(mlp.MLPRouter, "route",
                        lambda self, x, lam: 1 - real(self, x, lam))


@pytest.mark.parametrize("fault", [_alter_tokens, _skip_state, _half_batch,
                                   _wrong_route],
                         ids=lambda f: f.__name__.strip("_"))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    got = _run(tiny_parts())
    assert got["info"]["sampled_requests"] > 0    # judged, not vacuous
    assert not got["result"]["correct"], got["result"]["checks"]


def test_fp8_control_reads_far_above_the_port():
    """The control on the tiny cell, three seeds: the fp8 reference's
    choices lie further below the best logit than the port's served
    tokens do (the chip's readings at the cells' sizes are in PERF.md)."""
    parts = tiny_parts()
    for seed in (7, 8, 9):
        row = calibrate.read_seed(parts, seed, 1.5, torch.device("cpu"))
        assert row["route_mismatch"] == 0
        assert row["control_gap"] > 3 * row["served_gap"], row


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the chip")
    return torch.device("cuda", 0)


def test_paged_decode_launches_match_the_timeline_on_the_card(cuda):
    """On the card, a traced tiny run's paged decode launches are the
    timeline's passes × layers, so the roofline reads, and no share
    passes 100%."""
    got = R.run_cell(tiny_parts(), 11, 3.0, True, cuda)
    res = got["result"]
    assert res["correct"], res["checks"]
    m = res["metrics"]
    assert "paged_decode_attention_roofline.chat" in m
    for name, v in m.items():
        if v["unit"] == "%":
            assert 0 < v["value"] <= 100, name
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
