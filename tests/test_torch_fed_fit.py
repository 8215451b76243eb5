"""The port's federated fit with the robust and buffered-async strategies,
per-round cohorts, staleness and Byzantine clients, against the JAX
package on the CPU.

Every fit starts from the reference's init (carried by ``convert``), runs
3 rounds with ``participation=1.0``, ``full_batch=True`` and dropout 0, so
it is a pure function of its inputs, and goes through
``routers.fit_federated`` in both packages. With ``cohort=`` the port is
handed the reference's cohort permutations (drawn from the reference's
own key splits and injected through ``core.federated._draw_cohort``).

Tolerances: params leaf by leaf |Δ| ≤ 1e-5·|ref| + 1e-5·max|ref| and the
per-round loss to 1e-5 relative (f32 sums in another order, through 3
AdamW steps of 3 rounds); the refusals by their exact messages; the
cohort's stack size exactly.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro import routers as jrouters
from repro.config import FedConfig as JFedConfig
from repro.config import RouterConfig as JRouterConfig
from repro.data.partition import federated_split as jfederated_split
from repro.data.synthetic import make_eval_corpus as jmake_eval_corpus
from repro.fed import aggregators as jagg
from repro.fed import faults as jfaults
from repro_torch import convert, routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import federated as TF
from repro_torch.fed import aggregators as tagg
from repro_torch.fed import faults as tfaults

torch.set_num_threads(1)

N_CLIENTS = 6
ROUNDS = 3
RK = dict(d_emb=16, num_models=6, hidden=(16, 16), dropout=0.0)
FK = dict(num_clients=N_CLIENTS, participation=1.0, lr=3e-3)


@pytest.fixture(scope="module")
def setup():
    corpus = jmake_eval_corpus(jax.random.PRNGKey(0), n_queries=900,
                               n_tasks=5, n_models=6, d_emb=16)
    split = jfederated_split(jax.random.PRNGKey(1), corpus,
                             JFedConfig(**FK))
    jr = jrouters.make("mlp", JRouterConfig(**RK)).init(
        jax.random.PRNGKey(2))
    tr = routers.make("mlp", RouterConfig(**RK), state=convert.
                      router_state_from_numpy(jax.tree.map(np.asarray,
                                                           jr.state),
                                              device="cpu"))
    train = {k: np.array(v) for k, v in split["train"].items()}
    return split["train"], train, jr, tr


def _jax_cohorts(key, n, cohort, rounds):
    """The reference's cohort of each round: ``fedavg`` splits off the init
    key, the scan splits a round key per round, and the round splits its
    cohort key first."""
    key, _ = jax.random.split(key)
    out = []
    for _ in range(rounds):
        key, k_r = jax.random.split(key)
        _, k_coh = jax.random.split(k_r)
        out.append(np.asarray(jax.random.permutation(k_coh, n)[:cohort]))
    return out


def _fit_both(setup, monkeypatch, jkw, tkw, cohort=None, key=7):
    jtrain, train, jr, tr = setup
    kw = {} if cohort is None else {"cohort": cohort}
    jfit, jh = jrouters.fit_federated(jr, jtrain, JFedConfig(**FK),
                                      key=jax.random.PRNGKey(key),
                                      rounds=ROUNDS, full_batch=True,
                                      **kw, **jkw)
    if cohort is not None:
        draws = iter(_jax_cohorts(jax.random.PRNGKey(key), N_CLIENTS,
                                  cohort, ROUNDS))
        monkeypatch.setattr(TF, "_draw_cohort", lambda gen, n, c:
                            torch.tensor(next(draws), dtype=torch.long))
    tfit, th = routers.fit_federated(tr, train, FedConfig(**FK), gen=key,
                                     device="cpu", rounds=ROUNDS,
                                     full_batch=True, **kw, **tkw)
    return tfit, th, jfit, jh


def _close(tfit, th, jfit, jh):
    def one(w, g):
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * float(np.abs(w).max()))
    jax.tree.map(one, jax.tree.map(np.asarray, jfit.state),
                 convert.state_to_numpy(tfit.state))
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=1e-5)


def _corrupt(pkg_faults, pkg_agg, n, inner):
    plan = pkg_faults.FaultPlan(seed=3, corrupt_frac=0.34)
    return plan.corrupt_updates(n, inner=getattr(pkg_agg, inner)(),
                                scale=2.0)


AGGREGATORS = {
    "trimmed_mean": lambda pkg: pkg.TrimmedMeanAggregator(trim_frac=0.2),
    "median": lambda pkg: pkg.MedianAggregator(),
    "norm_clip": lambda pkg: pkg.NormClipAggregator(clip=0.05),
    "buffered_async_clip": lambda pkg: pkg.BufferedAsyncAggregator(
        server_lr=0.8, clip=0.05),
}


@pytest.mark.parametrize("name", sorted(AGGREGATORS))
def test_robust_fit_matches_reference(setup, monkeypatch, name):
    make = AGGREGATORS[name]
    _close(*_fit_both(setup, monkeypatch, {"aggregator": make(jagg)},
                      {"aggregator": make(tagg)}))


def test_buffered_async_fit_with_staleness_matches_reference(setup,
                                                             monkeypatch):
    st = np.array([0, 2, 1, 0, 4, 3], np.float32)
    _close(*_fit_both(
        setup, monkeypatch,
        {"aggregator": jagg.BufferedAsyncAggregator(staleness_alpha=0.7),
         "staleness": st},
        {"aggregator": tagg.BufferedAsyncAggregator(staleness_alpha=0.7),
         "staleness": st}))


@pytest.mark.parametrize("inner", ["FedAvgAggregator",
                                   "TrimmedMeanAggregator"])
def test_corrupted_fit_matches_reference(setup, monkeypatch, inner):
    _close(*_fit_both(
        setup, monkeypatch,
        {"aggregator": _corrupt(jfaults, jagg, N_CLIENTS, inner)},
        {"aggregator": _corrupt(tfaults, tagg, N_CLIENTS, inner)}))


@pytest.mark.parametrize("cohort,kind", [(3, "fedavg"), (4, "corrupt"),
                                         (4, "async")])
def test_cohort_fit_matches_reference_with_its_permutation(setup,
                                                           monkeypatch,
                                                           cohort, kind):
    """The mask of ``CorruptUpdates`` and the staleness vector are indexed
    by the stacked axis: the cohort's positions after the gather."""
    st = np.arange(N_CLIENTS, dtype=np.float32)
    kw = {"fedavg": lambda pkg, f: {},
          "corrupt": lambda pkg, f: {"aggregator": _corrupt(
              f, pkg, cohort, "MedianAggregator")},
          "async": lambda pkg, f: {
              "aggregator": pkg.BufferedAsyncAggregator(), "staleness": st},
          }[kind]
    _close(*_fit_both(setup, monkeypatch, kw(jagg, jfaults),
                      kw(tagg, tfaults), cohort=cohort))


class _StackSizes(tagg.FedAvgAggregator):
    """FedAvg that records the size of each stack it aggregates."""

    def __call__(self, client_params, wts, gen):
        self.__dict__.setdefault("sizes", []).append(int(wts.shape[0]))
        return super().__call__(client_params, wts, gen)


def test_cohort_trains_only_its_clients_and_full_cohort_is_plain(setup):
    _, train, _, tr = setup
    fcfg = FedConfig(**FK)
    spy = _StackSizes()
    routers.fit_federated(tr, train, fcfg, gen=1, device="cpu", rounds=4,
                          cohort=2, aggregator=spy)
    assert spy.sizes == [2] * 4
    half = dataclasses.replace(fcfg, participation=0.5)
    spy = _StackSizes()
    routers.fit_federated(tr, train, half, gen=1, device="cpu", rounds=2,
                          cohort=4, aggregator=spy)
    assert spy.sizes == [2] * 2       # participation applies in the cohort
    full, _ = routers.fit_federated(tr, train, fcfg, gen=1, device="cpu",
                                    rounds=2, cohort=N_CLIENTS)
    plain, _ = routers.fit_federated(tr, train, fcfg, gen=1, device="cpu",
                                     rounds=2)
    jax.tree.map(np.testing.assert_array_equal,
                 convert.state_to_numpy(full.state),
                 convert.state_to_numpy(plain.state))


def _message(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("case", ["cohort0", "cohort_mask", "stale_fedavg",
                                  "stale_median", "stale_shape",
                                  "kmeans_cohort", "elo_staleness",
                                  "corrupt_length"])
def test_fit_refusals_match_reference(setup, case):
    jtrain, train, jr, tr = setup
    jf, tf = JFedConfig(**FK), FedConfig(**FK)
    mask = np.ones(N_CLIENTS, np.float32)
    st = np.zeros(N_CLIENTS, np.float32)
    kw = {"cohort0": lambda a, f: {"cohort": 0},
          "cohort_mask": lambda a, f: {"cohort": 2, "client_mask": mask},
          "stale_fedavg": lambda a, f: {"staleness": st},
          "stale_median": lambda a, f: {
              "staleness": st, "aggregator": a.MedianAggregator()},
          "stale_shape": lambda a, f: {
              "staleness": st[:4], "aggregator": a.BufferedAsyncAggregator()},
          "kmeans_cohort": lambda a, f: {"cohort": 2},
          "elo_staleness": lambda a, f: {"staleness": st},
          "corrupt_length": lambda a, f: {
              "aggregator": f.FaultPlan(corrupt_frac=0.5).corrupt_updates(4)},
          }[case]
    family = {"kmeans_cohort": "kmeans", "elo_staleness": "elo"}.get(case)
    if family is not None:
        jr = jrouters.make(family, JRouterConfig(**RK))
        tr = routers.make(family, RouterConfig(**RK))
    want = _message(lambda: jrouters.fit_federated(
        jr, jtrain, jf, key=jax.random.PRNGKey(0), rounds=1,
        **kw(jagg, jfaults)))
    got = _message(lambda: routers.fit_federated(
        tr, train, tf, gen=0, device="cpu", rounds=1, **kw(tagg, tfaults)))
    assert got == want
