"""The port's server-side aggregation strategies against the JAX package's
on the CPU: the trimmed mean, the median, norm clipping, buffered-async
aggregation, Gaussian DP over each, and the declared-extras flags.

Every case stacks the same seeded numpy slab (a tree of dicts and lists
like a router's params) for both packages. Tolerances:
  * each strategy against the reference: leaf by leaf, |Δ| ≤ 1e-5·|ref|
    + 1e-6·max|ref| (f32 sums in another order; sorts and order
    statistics are exact);
  * ``GaussianDPAggregator(sigma=0)`` over a strategy: equal to the bare
    strategy bit for bit in the port, and to the reference as above;
  * the median of an even number of active clients: the mean of the two
    middle values of a numpy sort, to 1e-6;
  * the ``needs_prev`` / ``needs_staleness`` flags: equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import aggregators as jagg
from repro.fed import faults as jfaults
from repro_torch import convert
from repro_torch.fed import aggregators as tagg
from repro_torch.fed import faults as tfaults

N = 6
STALENESS = np.array([0, 1, 3, 0, 2, 5], np.float32)
#: per-client aggregation weights: all active, some inactive (4 active,
#: even), 5 active (odd), one active
WEIGHTS = {
    "all": np.array([12, 30, 7, 19, 25, 9], np.float32),
    "even": np.array([12, 0, 7, 19, 0, 9], np.float32),
    "odd": np.array([12, 30, 0, 19, 25, 9], np.float32),
    "one": np.array([0, 0, 7, 0, 0, 0], np.float32),
}


def _slab(seed=0):
    rng = np.random.default_rng(seed)
    prev = {"trunk": [{"w": rng.standard_normal((5, 4)).astype(np.float32),
                       "b": rng.standard_normal(4).astype(np.float32)}],
            "heads": {"acc_w": rng.standard_normal((4, 3)).astype(
                np.float32)}}
    stack = jax.tree.map(
        lambda p: (p[None] + rng.standard_normal((N,) + p.shape).astype(
            np.float32) * rng.uniform(0.1, 3.0, (N,) + (1,) * p.ndim)
        ).astype(np.float32), prev)
    return stack, prev


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return convert.router_state_from_numpy(tree, device="cpu")


def _close(got, want):
    def one(w, g):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(w).max()))
    jax.tree.map(one, jax.tree.map(np.asarray, want),
                 convert.state_to_numpy(got))


STRATEGIES = {
    "trimmed_mean": (jagg.TrimmedMeanAggregator(),
                     tagg.TrimmedMeanAggregator()),
    "trimmed_mean_0.4": (jagg.TrimmedMeanAggregator(trim_frac=0.4),
                         tagg.TrimmedMeanAggregator(trim_frac=0.4)),
    "median": (jagg.MedianAggregator(), tagg.MedianAggregator()),
    "norm_clip": (jagg.NormClipAggregator(clip=0.8),
                  tagg.NormClipAggregator(clip=0.8)),
    "buffered_async": (jagg.BufferedAsyncAggregator(server_lr=0.7),
                       tagg.BufferedAsyncAggregator(server_lr=0.7)),
    "buffered_async_clip": (
        jagg.BufferedAsyncAggregator(staleness_alpha=1.0, clip=0.5),
        tagg.BufferedAsyncAggregator(staleness_alpha=1.0, clip=0.5)),
}


def _call(agg, stack, wts, key, prev, staleness):
    extras = {}
    if getattr(agg, "needs_prev", False):
        extras["prev"] = prev
    if getattr(agg, "needs_staleness", False):
        extras["staleness"] = staleness
    return agg(stack, wts, key, **extras)


def _both(jstrat, tstrat, case):
    stack, prev = _slab()
    wts = WEIGHTS[case]
    want = _call(jstrat, _j(stack), jnp.asarray(wts), jax.random.PRNGKey(0),
                 _j(prev), jnp.asarray(STALENESS))
    got = _call(tstrat, _t(stack), torch.from_numpy(wts),
                torch.Generator().manual_seed(0), _t(prev),
                torch.from_numpy(STALENESS))
    return got, want


@pytest.mark.parametrize("case", sorted(WEIGHTS))
@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_strategy_matches_reference(name, case):
    got, want = _both(*STRATEGIES[name], case)
    _close(got, want)


@pytest.mark.parametrize("name", sorted(STRATEGIES))
def test_dp_sigma0_over_strategy(name):
    jstrat, tstrat = STRATEGIES[name]
    jdp = jagg.GaussianDPAggregator(sigma=0.0, inner=jstrat)
    tdp = tagg.GaussianDPAggregator(sigma=0.0, inner=tstrat)
    assert (tdp.needs_prev, tdp.needs_staleness) == (jdp.needs_prev,
                                                     jdp.needs_staleness)
    got, want = _both(jdp, tdp, "even")
    _close(got, want)
    bare, _ = _both(jstrat, tstrat, "even")
    jax.tree.map(np.testing.assert_array_equal, convert.state_to_numpy(got),
                 convert.state_to_numpy(bare))


def test_dp_noise_over_a_strategy_forwards_its_extras():
    stack, prev = _slab(3)
    inner = tagg.NormClipAggregator(clip=0.8)
    dp = tagg.GaussianDPAggregator(sigma=0.05, inner=inner)
    wts = torch.from_numpy(WEIGHTS["all"])
    bare = inner(_t(stack), wts, None, prev=_t(prev))
    noisy = dp(_t(stack), wts, torch.Generator().manual_seed(1),
               prev=_t(prev))
    dev = (noisy["heads"]["acc_w"] - bare["heads"]["acc_w"]).abs()
    assert 0.0 < float(dev.max()) < 0.5


def test_median_of_even_count_is_the_mean_of_the_middle_pair():
    stack, _ = _slab(4)
    wts = WEIGHTS["even"]
    got = tagg.MedianAggregator()(_t(stack), torch.from_numpy(wts), None)
    act = stack["heads"]["acc_w"][wts > 0]
    srt = np.sort(act, axis=0)
    want = 0.5 * (srt[1] + srt[2])
    np.testing.assert_allclose(got["heads"]["acc_w"].numpy(), want,
                               rtol=1e-6)
    lower = torch.median(torch.from_numpy(act), dim=0).values.numpy()
    assert not np.allclose(lower, want)     # torch.median is the lower one


def test_declared_extras_match_reference():
    pairs = list(STRATEGIES.values()) + [
        (jagg.FedAvgAggregator(), tagg.FedAvgAggregator()),
        (jagg.SecureAggAggregator(), tagg.SecureAggAggregator()),
        (jfaults.CorruptUpdates(mask=(True,)),
         tfaults.CorruptUpdates(mask=(True,))),
        (jfaults.CorruptUpdates(mask=(True,),
                                inner=jagg.BufferedAsyncAggregator()),
         tfaults.CorruptUpdates(mask=(True,),
                                inner=tagg.BufferedAsyncAggregator()))]
    for jstrat, tstrat in pairs:
        for j, t in ((jstrat, tstrat),
                     (jagg.GaussianDPAggregator(inner=jstrat),
                      tagg.GaussianDPAggregator(inner=tstrat))):
            for flag in ("needs_prev", "needs_staleness"):
                assert getattr(t, flag, False) == getattr(j, flag, False), (
                    type(t).__name__, flag)
