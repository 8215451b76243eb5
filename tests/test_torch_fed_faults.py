"""The port's fault injection against the JAX package on the CPU.

  * Every ``FaultPlan`` predicate and identity set equals the reference's
    bit for bit over a grid of seeds and arguments (a crc32 of the tags
    and numpy's ``default_rng``; no tolerance), and so do the plan's
    fields and defaults.
  * ``CorruptUpdates`` ``sign_flip``: the stack the inner strategy
    receives and the aggregate equal the reference's to f32 rounding,
    |Δ| ≤ 1e-6·|ref| + 1e-6·max|ref| (XLA may contract the arithmetic into
    fused multiply-adds).
  * ``scaled_noise``: clean rows pass through bit for bit; the corrupted
    rows' noise, (row − update)/scale, has mean within 0.05 of 0 and
    standard deviation within 0.05 of 1 over 8,192 draws (about 4.5 and
    6.4 standard errors); the same generator seed gives the same draws.
  * The refusals by their exact messages.
  * After a cohort gather and the round's compaction to its active
    clients, the corrupted clients are the reference's: the same cohort
    permutation is given to both packages and each client's identity is
    read off its dataset size.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import FedConfig as JFedConfig
from repro.config import RouterConfig as JRouterConfig
from repro.core import federated as JF
from repro.core import mlp_router as JR
from repro.fed import aggregators as jagg
from repro.fed import faults as jfaults
from repro_torch import convert
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import federated as TF
from repro_torch.fed import aggregators as tagg
from repro_torch.fed import faults as tfaults

PLAN = dict(dropout=0.3, delay_frac=0.4, max_staleness=3, corrupt_frac=0.25,
            label_flip=0.5, lose_outcomes=0.2, backend_fail=0.35,
            fail_models=(2,), burst_rate=0.3, burst_max=5, storm_rate=0.4,
            storm_len=3, storm_deadline=2, cancel_rate=0.3, spike_rate=0.25,
            spike_scale=3)


def _draws(plan):
    """Every predicate of ``plan`` over a grid of arguments."""
    r = range
    return {
        "client_drops": [plan.client_drops(c, t) for c in r(10)
                         for t in r(6)],
        "corrupted_clients": [plan.corrupted_clients(n) for n in r(1, 21)],
        "straggler_clients": [plan.straggler_clients(n) for n in r(1, 21)],
        "staleness": [plan.staleness(n, s) for n in (5, 12) for s in r(5)],
        "flip_label": [plan.flip_label(c, e) for c in r(6) for e in r(8)],
        "lose_outcome": [plan.lose_outcome(i) for i in r(50)],
        "backend_fails": [plan.backend_fails(m, s, a) for m in r(4)
                          for s in r(10) for a in r(3)],
        "burst_size": [plan.burst_size(t) for t in r(40)],
        "deadline_storm": [plan.deadline_storm(t) for t in r(40)],
        "cancels_request": [plan.cancels_request(i) for i in r(50)],
        "cancel_after": [plan.cancel_after(i, h) for i in r(30)
                         for h in (0, 1, 7)],
        "page_spike": [plan.page_spike(t) for t in r(40)],
    }


@pytest.mark.parametrize("seed", [0, 3, 17, 123456])
def test_fault_plan_draws_equal_reference(seed):
    want = _draws(jfaults.FaultPlan(seed=seed, **PLAN))
    got = _draws(tfaults.FaultPlan(seed=seed, **PLAN))
    assert sorted(got) == sorted(want)
    for k in want:
        for g, w in zip(got[k], want[k]):
            if isinstance(w, np.ndarray):
                assert g.dtype == w.dtype, k
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:
                assert type(g) is type(w) and g == w, k
    # a plan that draws something: some of each predicate fires
    assert any(got["client_drops"]) and not all(got["client_drops"])
    assert sum(got["burst_size"]) > 0 and any(got["deadline_storm"])


def test_fault_plan_fields_equal_reference():
    def spec(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert spec(tfaults.FaultPlan) == spec(jfaults.FaultPlan)
    assert [f.name for f in dataclasses.fields(tfaults.CorruptUpdates)] == \
        [f.name for f in dataclasses.fields(jfaults.CorruptUpdates)]
    for n in (4, 10, 13):
        want = jfaults.FaultPlan(seed=5, corrupt_frac=0.3).corrupt_updates(n)
        got = tfaults.FaultPlan(seed=5, corrupt_frac=0.3).corrupt_updates(n)
        assert got.mask == want.mask and got.mode == want.mode
        assert got.scale == want.scale
        assert type(got.inner).__name__ == type(want.inner).__name__


class _Spy:
    """An inner strategy that records the stack it receives and returns
    its first row."""

    def __init__(self):
        self.seen = []

    def __call__(self, client_params, wts, key):
        self.seen.append((client_params, wts))
        return jax.tree.map(lambda s: s[0], client_params)


def _slab(seed, n=5):
    rng = np.random.default_rng(seed)
    prev = {"trunk": [{"w": rng.standard_normal((7, 6)).astype(np.float32),
                       "b": rng.standard_normal(6).astype(np.float32)}],
            "heads": {"acc_w": rng.standard_normal((6, 3)).astype(
                np.float32)}}
    stack = jax.tree.map(lambda p: (p[None] + rng.standard_normal(
        (n,) + p.shape).astype(np.float32)).astype(np.float32), prev)
    return stack, prev


def _t(tree):
    return convert.router_state_from_numpy(tree, device="cpu")


def _np(tree):
    if isinstance(tree, torch.Tensor):
        return tree.numpy()
    return jax.tree.map(np.asarray, tree)


def _close(got, want):
    def one(w, g):
        np.testing.assert_allclose(g, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))
    jax.tree.map(one, _np(want), convert.state_to_numpy(got))


@pytest.mark.parametrize("scale", [1.0, 10.0])
@pytest.mark.parametrize("inner", ["spy", "FedAvgAggregator",
                                   "MedianAggregator"])
def test_sign_flip_matches_reference(scale, inner):
    stack, prev = _slab(0)
    mask = (True, False, False, True, False)
    wts = np.array([3, 5, 0, 2, 4], np.float32)
    if inner == "spy":
        ji, ti = _Spy(), _Spy()
    else:
        ji, ti = getattr(jagg, inner)(), getattr(tagg, inner)()
    want = jfaults.CorruptUpdates(mask=mask, inner=ji, scale=scale)(
        jax.tree.map(jnp.asarray, stack), jnp.asarray(wts),
        jax.random.PRNGKey(0), prev=jax.tree.map(jnp.asarray, prev))
    got = tfaults.CorruptUpdates(mask=mask, inner=ti, scale=scale)(
        _t(stack), torch.from_numpy(wts), torch.Generator().manual_seed(0),
        prev=_t(prev))
    _close(got, want)
    if inner == "spy":
        _close(ti.seen[0][0], ji.seen[0][0])
        # the clean rows are the updates themselves
        for g, s in zip(convert.state_to_numpy(ti.seen[0][0])["trunk"][0]
                        .values(), stack["trunk"][0].values()):
            np.testing.assert_array_equal(g[[1, 2, 4]], s[[1, 2, 4]])


def test_scaled_noise_keeps_clean_rows_and_draws_stated_noise():
    rng = np.random.default_rng(1)
    s = rng.standard_normal((4, 64, 64)).astype(np.float32)
    prev = np.zeros((64, 64), np.float32)
    mask = (False, True, False, True)
    outs = []
    for seed in (2, 2, 3):
        spy = _Spy()
        tfaults.CorruptUpdates(mask=mask, inner=spy, mode="scaled_noise",
                               scale=3.0)(
            {"w": torch.from_numpy(s)}, torch.ones(4),
            torch.Generator().manual_seed(seed),
            prev={"w": torch.from_numpy(prev)})
        outs.append(spy.seen[0][0]["w"].numpy())
    out = outs[0]
    np.testing.assert_array_equal(out[[0, 2]], s[[0, 2]])
    noise = (out[[1, 3]] - s[[1, 3]]) / 3.0
    assert abs(float(noise.mean())) < 0.05
    assert abs(float(noise.std()) - 1.0) < 0.05
    np.testing.assert_array_equal(outs[1], out)           # same seed
    assert not np.array_equal(outs[2][[1, 3]], out[[1, 3]])


@pytest.mark.parametrize("case", ["length", "mode"])
def test_corrupt_updates_refusals_match_reference(case):
    kw = ({"mask": (True, False)} if case == "length"
          else {"mask": (True,) * 4, "mode": "gremlins"})

    def msg(mod, stack, wts, gen, prev):
        with pytest.raises(ValueError) as e:
            mod.CorruptUpdates(**kw)(stack, wts, gen, prev=prev)
        return str(e.value)

    want = msg(jfaults, {"w": jnp.zeros((4, 3))}, jnp.ones(4),
               jax.random.PRNGKey(0), {"w": jnp.zeros(3)})
    got = msg(tfaults, {"w": torch.zeros((4, 3))}, torch.ones(4), None,
              {"w": torch.zeros(3)})
    assert got == want
    if case == "length":       # the round checks the stack before compaction
        with pytest.raises(ValueError) as e:
            tfaults.CorruptUpdates(**kw).select_clients(torch.arange(2), 4)
        assert str(e.value) == want


N, D, COHORT = 6, 10, 4
RK = dict(d_emb=8, num_models=3, hidden=(8,), dropout=0.0)


def _round_data():
    """6 clients with 5..10 valid rows: a client's dataset size is its
    identity."""
    rng = np.random.default_rng(4)
    data = {"x": rng.standard_normal((N, D, 8)).astype(np.float32),
            "m": rng.integers(0, 3, (N, D)).astype(np.int32),
            "acc": (rng.uniform(size=(N, D)) > 0.5).astype(np.float32),
            "cost": rng.uniform(size=(N, D)).astype(np.float32),
            "w": (np.arange(D)[None] < 5 + np.arange(N)[:, None]).astype(
                np.float32)}
    return data


def _corrupted_by_client(spy, prev):
    """{client: corrupted?} for the clients of positive weight in the
    recorded stack: sign_flip at scale 0 uploads prev itself."""
    stack, wts = spy.seen[-1]
    w = _np(stack["heads"]["acc_w"])
    out = {}
    for row, size in enumerate(_np(wts)):
        if size > 0:
            out[int(size) - 5] = bool(np.array_equal(w[row], prev))
    return out


def test_mask_lands_on_the_reference_clients_after_cohort_and_compaction(
        monkeypatch):
    data = _round_data()
    jcfg, tcfg = JRouterConfig(**RK), RouterConfig(**RK)
    jf = JFedConfig(num_clients=N, participation=1.0, lr=1e-2)
    tf = FedConfig(num_clients=N, participation=0.5, lr=1e-2)
    params = JR.init_mlp_router(jax.random.PRNGKey(0), jcfg)
    prev_w = np.asarray(params["heads"]["acc_w"])
    mask = (True, False, True, False)
    seen = {True: 0, False: 0}
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        # the reference's round: the whole cohort stays in the stack
        jspy = _Spy()
        JF.fedavg_round(params, jax.tree.map(jnp.asarray, data), key, jcfg,
                        jf, JF._make_opt(jf, "adamw"), 1, full_batch=True,
                        aggregator=jfaults.CorruptUpdates(
                            mask=mask, inner=jspy, scale=0.0),
                        cohort=COHORT)
        want = _corrupted_by_client(jspy, prev_w)
        assert len(want) == COHORT
        # the port's round, with the reference's cohort and half of it
        # active: the stack is compacted to 2 clients
        _, k_coh = jax.random.split(key)
        perm = np.array(jax.random.permutation(k_coh, N)[:COHORT])
        monkeypatch.setattr(TF, "_draw_cohort", lambda gen, n, c:
                            torch.tensor(perm, dtype=torch.long))
        tspy = _Spy()
        TF.fedavg_round(convert.router_state_from_numpy(
            jax.tree.map(np.asarray, params), device="cpu"),
            {k: torch.from_numpy(v) for k, v in data.items()},
            torch.Generator().manual_seed(seed), tcfg, tf,
            TF._make_opt(tf, "adamw"), 1, full_batch=True,
            aggregator=tfaults.CorruptUpdates(mask=mask, inner=tspy,
                                              scale=0.0),
            cohort=COHORT)
        got = _corrupted_by_client(tspy, prev_w)
        assert len(got) == 2 and set(got) <= set(want)
        assert got == {c: want[c] for c in got}
        for v in got.values():
            seen[v] += 1
    assert seen[True] > 0 and seen[False] > 0
