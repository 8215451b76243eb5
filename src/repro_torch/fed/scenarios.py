"""Scenario layer: traffic simulators driving the online federation runtime
(PyTorch counterpart of ``repro/fed/scenarios.py``).

A ``TrafficScenario`` owns a synthetic evaluation corpus (the RouterBench
anatomy from ``data/synthetic.py``) and generates deterministic arrival
schedules over heterogeneous clients:

  * **query heterogeneity** — per-client Dirichlet mixtures over the
    corpus task clusters (the paper's §6 partition, but arriving live);
  * **distribution drift** — client mixtures re-drawn (interpolated by
    ``drift``) at every phase boundary, so a frozen router's world moves
    from under it;
  * **stragglers / partial participation** — a fraction of clients submits
    only a fraction of its turns, so its buffers stay thin and its
    federated weight small;
  * **mid-run model onboarding** — a reserved corpus model column joins
    the pool mid-run (§6.3) through ``FedLoop.onboard_model``;
  * **embedding-perturbation drift** — with ``embed_sigma > 0`` every
    phase after the first re-draws a Gaussian perturbation of the corpus
    embeddings: routing and harvesting see the perturbed vectors while
    outcomes keep following the *true* per-query tables.

Every draw but the corpus, the pool weights and the routers' own is numpy
``default_rng``, seeded as in the reference — arrivals, outcomes,
mixtures, stragglers, test sets and the engine-chaos schedule — so they
are bit-equal to the JAX package's for one seed. The corpus is drawn from
a CPU ``torch.Generator`` seeded ``cfg.seed`` (its numbers differ from the
reference's); the pool weights and the router inits from generators on
the serving device. Nothing consults the wall clock, so
``run_online_vs_frozen`` returns the same metrics on every run.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import routers
from repro_torch.config import FedConfig, ModelConfig, RouterConfig
from repro_torch.core import policy
from repro_torch.data.synthetic import make_eval_corpus
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.fed.harvest import HarvestStore
from repro_torch.fed.loop import FedLoop, FedLoopConfig
from repro_torch.models import init_params

_WORDS = ("route the query to a model that answers well and cheaply "
          "summarize prove draft review plan code data chart essay").split()

#: tiny attention arch shared by every simulated pool entry — one set of
#: weights serves the whole pool (names/costs differ per PoolModel).
SIM_MODEL = ModelConfig(name="sim-tiny", arch_type="dense", n_layers=2,
                        d_model=32, n_heads=2, n_kv_heads=1, d_ff=64,
                        vocab=101, head_dim=16, dtype="float32")


@dataclasses.dataclass(frozen=True)
class ScenarioConfig:
    n_clients: int = 6
    n_tasks: int = 6
    n_models: int = 3          #: pool size at t=0
    d_emb: int = 32
    n_queries: int = 1500      #: corpus size the traffic samples from
    queries_per_phase: int = 96
    phases: int = 2
    dirichlet_alpha: float = 0.35  #: client task concentration (lower =
    #: more heterogeneous)
    drift: float = 1.0         #: 0 = static mixtures, 1 = fully re-drawn
    straggler_frac: float = 0.34   #: fraction of clients that straggle
    straggler_rate: float = 0.25   #: a straggler submits this share of turns
    lam_choices: Tuple[float, ...] = (0.2, 0.5, 2.0)
    max_new: int = 4
    test_queries: int = 64     #: per (client, phase) evaluation draw
    embed_sigma: float = 0.0   #: phase ≥ 1 embedding perturbation scale
    seed: int = 0


class TrafficScenario:
    """Deterministic heterogeneous traffic over a synthetic eval corpus."""

    def __init__(self, cfg: ScenarioConfig, *, n_reserved_models: int = 0):
        self.cfg = cfg
        self.n_reserved = int(n_reserved_models)
        m_total = cfg.n_models + self.n_reserved
        corpus = make_eval_corpus(
            torch.Generator().manual_seed(cfg.seed), n_queries=cfg.n_queries,
            n_tasks=cfg.n_tasks, n_models=m_total, d_emb=cfg.d_emb)
        # the host copy every draw below reads
        self.corpus = {k: v if isinstance(v, int) else np.asarray(v)
                       for k, v in corpus.items()}
        task = self.corpus["task"]
        self._task_idx = [np.where(task == t)[0] for t in range(cfg.n_tasks)]
        rng = np.random.default_rng(cfg.seed)
        mix = rng.dirichlet(np.full(cfg.n_tasks, cfg.dirichlet_alpha),
                            size=cfg.n_clients)
        self.mixtures = [mix]
        for _ in range(1, cfg.phases):
            fresh = rng.dirichlet(np.full(cfg.n_tasks, cfg.dirichlet_alpha),
                                  size=cfg.n_clients)
            mix = (1.0 - cfg.drift) * mix + cfg.drift * fresh
            mix = mix / mix.sum(axis=1, keepdims=True)
            self.mixtures.append(mix)
        n_strag = int(round(cfg.straggler_frac * cfg.n_clients))
        self.stragglers = set(
            rng.choice(cfg.n_clients, size=n_strag, replace=False).tolist())
        self._outcome_rng = np.random.default_rng(cfg.seed + 7919)
        # per-phase (possibly perturbed) embedding views: phase 0 is the
        # clean corpus; later phases add a fresh seed-deterministic
        # Gaussian perturbation when embed_sigma > 0. Outcomes still key on
        # the query index, so only the *representation* moves.
        x0 = np.asarray(self.corpus["x"], np.float32)
        self._x_phase = [x0]
        for p in range(1, cfg.phases):
            if cfg.embed_sigma > 0.0:
                prng = np.random.default_rng(cfg.seed * 7717 + p)
                noise = prng.standard_normal(x0.shape).astype(np.float32)
                self._x_phase.append(x0 + cfg.embed_sigma * noise)
            else:
                self._x_phase.append(x0)

    # ------------------------------------------------------------- traffic
    def events(self, phase: int) -> List[Tuple[int, int, float]]:
        """Deterministic arrival list for one phase: (client, query idx,
        λ). Stragglers skip most of their turns."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 1000 + 13 * phase + 1)
        out = []
        for _ in range(cfg.queries_per_phase):
            c = int(rng.integers(cfg.n_clients))
            if c in self.stragglers and rng.random() > cfg.straggler_rate:
                continue
            t = int(rng.choice(cfg.n_tasks, p=self.mixtures[phase][c]))
            q = int(rng.choice(self._task_idx[t]))
            lam = float(rng.choice(np.asarray(cfg.lam_choices)))
            out.append((c, q, lam))
        return out

    def x(self, q: int, phase: int = 0) -> np.ndarray:
        """The query embedding as phase ``phase`` observes it."""
        return self._x_phase[phase][q]

    def prompt(self, q: int) -> str:
        """Deterministic filler text (the routing decision rides the
        embedding passed via submit(x=...); the prompt only feeds the stub
        tokenizer)."""
        return " ".join(_WORDS[(q + i) % len(_WORDS)]
                        for i in range(3 + q % 5))

    def observe(self, q: int, m: int) -> Tuple[float, float]:
        """The (acc, cost) the client logs for its routed model — a
        Bernoulli draw of the latent success probability plus the true
        cost, sequential on the host (deterministic given the arrival
        order)."""
        p = float(self.corpus["acc_table"][q, m])
        acc = float(self._outcome_rng.random() < p)
        return acc, float(self.corpus["cost_table"][q, m])

    # ----------------------------------------------------------- pool/eval
    def make_pool(self, n_models: Optional[int] = None, *,
                  device: DeviceLike = None) -> list:
        """PoolModels for the first ``n_models`` corpus columns — one
        shared tiny arch and one set of weights (drawn from a generator
        seeded ``cfg.seed + 1``), per-model costs from the corpus
        economics. On the CUDA device unless ``device`` names another."""
        from repro_torch.serve.gateway import PoolModel
        dev = resolve_device(device)
        n = self.cfg.n_models if n_models is None else n_models
        params = init_params(self.cfg.seed + 1, SIM_MODEL, device=dev)
        return [PoolModel(f"sim-m{i}", SIM_MODEL, params,
                          float(self.corpus["model_cost"][i]))
                for i in range(n)]

    def pool_model(self, m_idx: int, *, device: DeviceLike = None):
        """One more PoolModel (a reserved corpus column) for onboarding."""
        return self.make_pool(n_models=m_idx + 1, device=device)[m_idx]

    def calib_for_model(self, m_idx: int,
                        n: int = 128) -> Dict[str, np.ndarray]:
        """Calibration evals for onboarding model ``m_idx``: n corpus
        queries scored against that model — flat {"x","m","acc","cost","w"}
        with m == m_idx (the expanded pool's new column)."""
        rng = np.random.default_rng(self.cfg.seed * 31 + m_idx)
        qs = rng.integers(0, self.cfg.n_queries, size=n)
        acc = (rng.random(n) < self.corpus["acc_table"][qs, m_idx])
        return {"x": self.corpus["x"][qs].astype(np.float32),
                "m": np.full((n,), m_idx, np.int32),
                "acc": acc.astype(np.float32),
                "cost": self.corpus["cost_table"][qs, m_idx]
                .astype(np.float32),
                "w": np.ones((n,), np.float32)}

    def test_set(self, phase: int, client: int) -> Dict[str, np.ndarray]:
        """Held-out queries drawn from the client's CURRENT (phase)
        mixture, with the true acc/cost tables for frontier scoring."""
        cfg = self.cfg
        rng = np.random.default_rng(cfg.seed * 4931 + 97 * phase + client)
        tasks = rng.choice(cfg.n_tasks, size=cfg.test_queries,
                           p=self.mixtures[phase][client])
        qs = np.array([rng.choice(self._task_idx[t]) for t in tasks])
        return {"x": self._x_phase[phase][qs],
                "acc_table": self.corpus["acc_table"][qs],
                "cost_table": self.corpus["cost_table"][qs]}


class PowerLawScenario:
    """Population-scale arrival generator: 1k+ clients, Zipf traffic, churn.

      * **power-law popularity** — client ranks carry Zipf(``zipf_a``)
        weight, so a handful of head clients dominate arrivals while the
        long tail appears rarely or never;
      * **churn** — every phase re-deals a ``churn`` fraction of the ranks
        among their holders, so yesterday's hot clients go cold;
      * **O(cohort) harvest** — pair the arrivals with a
        ``HarvestStore(max_clients=...)`` and memory stays proportional to
        the warm set, not the population.

    Arrivals are client ids only. ``coverage_clients`` reports how many
    warm clients carry a target traffic share: the natural
    ``max_clients``/``cohort`` choice.
    """

    def __init__(self, n_clients: int = 1200, *, zipf_a: float = 1.1,
                 churn: float = 0.15, queries_per_phase: int = 512,
                 phases: int = 3, seed: int = 0):
        if n_clients < 2:
            raise ValueError("PowerLawScenario needs n_clients >= 2")
        if zipf_a <= 0:
            raise ValueError("zipf_a must be > 0")
        if not 0.0 <= churn <= 1.0:
            raise ValueError("churn must be in [0, 1]")
        self.n_clients = int(n_clients)
        self.zipf_a = float(zipf_a)
        self.churn = float(churn)
        self.queries_per_phase = int(queries_per_phase)
        self.phases = int(phases)
        self.seed = int(seed)
        rng = np.random.default_rng(seed * 611953 + 29)
        # rank r -> client id holding it; rank 0 is the traffic head
        holders = rng.permutation(self.n_clients)
        self._holders = [holders.copy()]
        n_churn = int(round(self.churn * self.n_clients))
        for _ in range(1, self.phases):
            holders = holders.copy()
            if n_churn >= 2:
                ranks = rng.choice(self.n_clients, size=n_churn,
                                   replace=False)
                holders[ranks] = holders[np.roll(ranks, 1)]
            self._holders.append(holders.copy())
        w = (1.0 + np.arange(self.n_clients)) ** (-self.zipf_a)
        self._rank_p = w / w.sum()

    def popularity(self, phase: int) -> np.ndarray:
        """(n_clients,) arrival probability per client id at ``phase``."""
        p = np.zeros(self.n_clients)
        p[self._holders[phase]] = self._rank_p
        return p

    def events(self, phase: int) -> np.ndarray:
        """Deterministic client-id arrival stream for one phase."""
        rng = np.random.default_rng(self.seed * 1000 + 13 * phase + 5)
        return rng.choice(self.n_clients, size=self.queries_per_phase,
                          p=self.popularity(phase))

    def coverage_clients(self, coverage: float = 0.9) -> int:
        """Smallest warm-client count carrying ``coverage`` of the traffic
        (phase-independent: churn moves which clients are warm, not how
        concentrated the traffic is)."""
        if not 0.0 < coverage <= 1.0:
            raise ValueError("coverage must be in (0, 1]")
        return int(np.searchsorted(np.cumsum(self._rank_p), coverage) + 1)


def engine_chaos_schedule(plan, *, ticks: int = 64,
                          arrivals_per_tick: int = 1,
                          prompt_lens: Tuple[int, int] = (3, 9),
                          max_new: int = 4, vocab: int = 97,
                          default_deadline: Optional[int] = None,
                          cancel_horizon: int = 12) -> List[dict]:
    """Deterministic engine-chaos schedule from a ``FaultPlan``: one
    arrival stream for the chaos tests and replays, so a failure
    reproduces from (plan, kwargs) alone.

    Each tick carries ``arrivals_per_tick`` baseline arrivals plus the
    plan's burst (``burst_size``); arrivals in a deadline-storm window get
    ``plan.storm_deadline`` (others ``default_deadline``); page-pressure
    spike ticks scale ``max_new`` by ``plan.spike_scale``; cancel-fated
    arrivals (``cancels_request`` keyed on the submission ordinal) carry
    the step offset at which the driver should land their cancel. Every
    event dict: ``tick``, ``toks`` (int32 prompt), ``max_new``,
    ``deadline`` (engine steps from submit, or None), ``cancel_after``
    (engine steps from submit, or None)."""
    events: List[dict] = []
    ordinal = 0
    lo, hi = prompt_lens
    for t in range(int(ticks)):
        n = int(arrivals_per_tick) + plan.burst_size(t)
        storm = plan.deadline_storm(t)
        scale = plan.page_spike(t)
        for i in range(n):
            rng = np.random.default_rng(
                plan.seed * 9_176_941 + 131 * t + i)
            S = int(rng.integers(lo, hi + 1))
            toks = rng.integers(1, vocab, size=S).astype(np.int32)
            deadline = (plan.storm_deadline if storm else default_deadline)
            cancel_after = (plan.cancel_after(ordinal, cancel_horizon)
                            if plan.cancels_request(ordinal) else None)
            events.append({"tick": t, "toks": toks,
                           "max_new": int(max_new) * scale,
                           "deadline": deadline,
                           "cancel_after": cancel_after})
            ordinal += 1
    return events


def _frontier_auc(predict_fn, test: Dict[str, np.ndarray], n_models: int,
                  device: torch.device) -> float:
    """Frontier AUC of a router on one test draw, scored on the true
    tables restricted to the models that router can actually route to
    (a frozen pre-onboarding router never uses a later-joined model)."""
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=device)
    *_, auc = policy.eval_router(predict_fn, t(test["x"]),
                                 t(test["acc_table"][:, :n_models]),
                                 t(test["cost_table"][:, :n_models]))
    return float(auc)


def run_online_vs_frozen(cfg: ScenarioConfig = ScenarioConfig(), *,
                         fcfg: Optional[FedConfig] = None,
                         lcfg: Optional[FedLoopConfig] = None,
                         engine_cfg=None, rcfg: Optional[RouterConfig] = None,
                         aggregator=None, onboard_phase: Optional[int] = None,
                         family: str = "mlp", local_steps: int = 200,
                         capacity: int = 256, seed: int = 0,
                         device: DeviceLike = None) -> dict:
    """The headline experiment behind ``BENCH_fedloop.json``: live traffic
    through the serving engine, evaluations harvested per client, and two
    deployments compared under drift —

      * **online**: one global router maintained by the ``FedLoop``
        (federated syncs over the harvested buffers, hot-swapped under
        traffic);
      * **frozen client-local**: each client fits its own router on its
        phase-0 harvest and never updates it (the no-federation baseline).

    Both are scored at every phase end as the mean frontier AUC over the
    clients' current (drifted) query mixtures. Returns the per-phase AUC
    curves plus loop/serving accounting. Runs on the CUDA device unless
    ``device`` names another; fully deterministic in its seeds: the router
    init draws from a generator seeded ``seed + 11``, the loop's stream is
    seeded ``seed + 13``, onboarding ``seed + 17`` and client ``c``'s
    frozen fit ``seed + 100 + c``.

    ``family`` picks the router family from the zoo; it must cold-start —
    ``init`` has to produce a servable state (parametric families and
    "elo"; "kmeans" cannot, its init is a no-op).
    """
    from repro_torch.serve.engine import EngineConfig
    from repro_torch.serve.gateway import RoutedServer

    dev = resolve_device(device)
    scenario = TrafficScenario(
        cfg, n_reserved_models=1 if onboard_phase is not None else 0)
    fcfg = fcfg or FedConfig(num_clients=cfg.n_clients, participation=0.75,
                             batch_size=32, lr=3e-3)
    lcfg = lcfg or FedLoopConfig(sync_every=16, rounds_per_sync=4,
                                 min_samples=24)
    rcfg = rcfg or RouterConfig(d_emb=cfg.d_emb, num_models=cfg.n_models,
                                hidden=(32, 32), dropout=0.0)
    engine_cfg = engine_cfg or EngineConfig(slots=8, max_seq=32, chunk=4,
                                            page_size=8)

    pool = scenario.make_pool(device=dev)
    router0 = routers.make(family, rcfg).init(seed + 11, device=dev)
    if router0.state is None:
        raise ValueError(
            f"router family {family!r} cannot cold-start a live service: "
            "init() produced no state (one-shot families other than 'elo' "
            "need a pre-fitted router)")
    harvest = HarvestStore(cfg.d_emb, capacity=capacity,
                           clients=range(cfg.n_clients), device=dev)
    srv = RoutedServer(pool, router0, engine_cfg=engine_cfg,
                       harvest=harvest, device=dev)
    loop = FedLoop(srv, fcfg, gen=seed + 13, aggregator=aggregator,
                   cfg=lcfg)

    frozen: List = []
    auc_online: List[float] = []
    auc_frozen: List[float] = []
    served = 0
    for phase in range(cfg.phases):
        if onboard_phase is not None and phase == onboard_phase:
            new_idx = cfg.n_models  # the reserved corpus column joins
            loop.onboard_model(scenario.pool_model(new_idx, device=dev),
                               scenario.calib_for_model(new_idx),
                               gen=seed + 17, steps=150)
        for (c, q, lam) in scenario.events(phase):
            rid = srv.submit(scenario.prompt(q), lam=lam,
                             max_new_tokens=cfg.max_new, client_id=c,
                             x=scenario.x(q, phase))
            m = srv.routed_model(rid)
            srv.report_outcome(rid, *scenario.observe(q, m))
            loop.step()
            served += 1
        loop.drain()
        loop.maybe_sync()  # absorb the phase tail before scoring
        if phase == 0:
            # the no-federation deployment: client-local fits on exactly
            # what each client harvested in phase 0, frozen forever after.
            # A straggler with (almost) no data keeps the cold-start
            # router, so both AUC means average the SAME client population.
            for c in range(cfg.n_clients):
                data_c = harvest.buffer(c).as_client_data()
                if float(data_c["w"].sum()) < 2:
                    frozen.append(router0)
                    continue
                local_kw = ({"steps": local_steps}
                            if routers.get(family).parametric else {})
                r, _ = routers.fit_local(
                    routers.make(family, rcfg), data_c, fcfg,
                    gen=seed + 100 + c, device=dev, **local_kw)
                frozen.append(r)
        on, fr = [], []
        for c in range(cfg.n_clients):
            test = scenario.test_set(phase, c)
            on.append(_frontier_auc(srv.router.predict, test,
                                    srv.router.num_models, dev))
            fr.append(_frontier_auc(frozen[c].predict, test,
                                    frozen[c].num_models, dev))
        auc_online.append(float(np.mean(on)))
        auc_frozen.append(float(np.mean(fr)))

    return {
        "auc_online": auc_online,
        "auc_frozen_local": auc_frozen,
        "auc_online_final": auc_online[-1],
        "auc_frozen_local_final": auc_frozen[-1],
        "auc_gap_final": auc_online[-1] - auc_frozen[-1],
        "syncs": len(loop.history),
        "router_version": srv.router_version,
        "requests_served": served,
        "harvested_samples": len(harvest),
        "harvest_bytes": harvest.nbytes,
        "num_models_final": srv.router.num_models,
    }
