"""The RouterBench-style harness: every family, federated vs client-local,
clean vs perturbed — offline over splits or online through the FedLoop
(PyTorch counterpart of ``repro/evalbench/harness.py``).

Offline (``offline_routerbench``): one many-model corpus, one federated
split; per router family, one federated fit over all clients and one fit
per client on its own slice, both scored on the global test draw under
each robustness scenario. Online (``online_routerbench``):
``fed.scenarios.run_online_vs_frozen`` with embedding drift switched on.

Both run on the CUDA device unless ``device`` names another, and both are
deterministic in their seeds. Where the reference splits and folds
threefry keys, the offline harness draws 63-bit seeds from a CPU
``torch.Generator``: four for the corpus, the split, the paraphrase noise
and the fits, then two per family (federated, local) from a stream seeded
with the fit seed plus the family name's crc32, and client c's local fit
takes the local seed plus c. The numbers therefore differ from the
reference's for one seed; the protocol is the same.
"""
from __future__ import annotations

import zlib
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch import routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.data.partition import client_slice, federated_split
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.evalbench.metrics import reference_points, sweep
from repro_torch.evalbench.perturb import (adversarial_queries,
                                           paraphrase_drift)
from repro_torch.evalbench.pools import make_pool_corpus, pool_table

SCENARIOS = ("clean", "paraphrase", "adversarial")

#: seeds are drawn from [0, 2**63 - 1)
_SEED_HI = 2 ** 63 - 1


def _seed(stream: torch.Generator) -> int:
    return int(torch.randint(_SEED_HI, (1,), generator=stream))


def eval_scenarios(router, test: dict, gen_or_noise, *, sigma: float = 0.25,
                   adv_budget: float = 0.35, adv_lam: float = 0.5,
                   lams=None) -> dict:
    """Score one fitted router on one test draw under every scenario.

    Routing runs on the scenario's view of the embeddings; scoring uses
    the clean queries' true tables. ``gen_or_noise`` is the paraphrase
    draw's generator, seed or noise tensor (``paraphrase_drift``).
    Returns {scenario: {"aiq", ...}} with the frontier curves."""
    out = {"clean": sweep(router.predict, test, lams=lams)}
    xp = paraphrase_drift(gen_or_noise, test["x"], sigma)
    out["paraphrase"] = sweep(router.predict, test, x=xp, lams=lams)
    x_adv, info = adversarial_queries(router, test["x"], adv_lam,
                                      budget=adv_budget)
    out["adversarial"] = {**sweep(router.predict, test, x=x_adv, lams=lams),
                          **info}
    return out


def _aiq_only(res: dict) -> dict:
    """Strip the frontier curves down to JSON-friendly scalars."""
    keep = ("aiq", "flip_rate", "mean_rel_norm")
    return {sc: {k: v for k, v in d.items() if k in keep}
            for sc, d in res.items()}


def offline_routerbench(gen, *, rcfg: RouterConfig, fcfg: FedConfig,
                        families: Optional[Sequence[str]] = None,
                        corpus: Optional[dict] = None,
                        sigma: float = 0.25, adv_budget: float = 0.35,
                        adv_lam: float = 0.5, local_steps: int = 400,
                        lams=None, device: DeviceLike = None) -> dict:
    """The offline benchmark: {family: {"federated": {scenario: {"aiq"}},
    "client_local": {scenario: {"aiq"}}, "clients_fit"}} plus pool and
    reference context. ``gen`` is an int seed or a CPU generator.

    ``client_local`` AIQs are means over the per-client fits, each scored
    on the same global test draw; a client with fewer than 2 rows of
    weight is skipped. The paraphrase noise is drawn once per benchmark
    (the same drifted embeddings for every router); the adversarial
    scenario attacks each router at its own decision boundary."""
    dev = resolve_device(device)
    stream = (gen if isinstance(gen, torch.Generator)
              else torch.Generator().manual_seed(gen))
    s_corpus, s_split, s_pert, s_fit = (_seed(stream) for _ in range(4))
    if corpus is None:
        corpus = make_pool_corpus(s_corpus, n_models=rcfg.num_models,
                                  d_emb=rcfg.d_emb, device=dev)
    else:   # arrays (the port's tensors or numpy) onto the device
        corpus = {k: (torch.as_tensor(v, device=dev)
                      if isinstance(v, (torch.Tensor, np.ndarray)) else v)
                  for k, v in corpus.items()}
    split = federated_split(torch.Generator(device=dev).manual_seed(s_split),
                            corpus, fcfg)
    test = split["test_global"]
    noise = torch.randn(test["x"].shape, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(
                            s_pert))
    results = {
        "n_models": int(corpus["n_models"]),
        "n_clients": int(fcfg.num_clients),
        "pool": pool_table(corpus),
        "reference": reference_points(test, lams=lams),
        "families": {},
    }
    kw = dict(sigma=sigma, adv_budget=adv_budget, adv_lam=adv_lam, lams=lams)
    for name in (families if families is not None else routers.available()):
        # crc32, not hash(): str hashing is salted per process
        fam = torch.Generator().manual_seed(
            (s_fit + zlib.crc32(name.encode())) % _SEED_HI)
        s_fed, s_loc = _seed(fam), _seed(fam)
        fed, _ = routers.fit_federated(routers.make(name, rcfg),
                                       split["train"], fcfg, gen=s_fed,
                                       device=dev)
        fed_res = eval_scenarios(fed, test, noise, **kw)
        local_kw = ({"steps": local_steps}
                    if routers.get(name).parametric else {})
        per_client = []
        for c in range(fcfg.num_clients):
            data_c = client_slice(split["train"], c)
            if float(data_c["w"].sum()) < 2:
                continue  # a starved client has nothing to fit on
            loc, _ = routers.fit_local(routers.make(name, rcfg), data_c,
                                       fcfg, gen=(s_loc + c) % _SEED_HI,
                                       device=dev, **local_kw)
            per_client.append(eval_scenarios(loc, test, noise, **kw))
        local_mean = {sc: {"aiq": float(np.mean([r[sc]["aiq"]
                                                 for r in per_client]))}
                      for sc in SCENARIOS}
        results["families"][name] = {
            "federated": _aiq_only(fed_res),
            "client_local": local_mean,
            "clients_fit": len(per_client),
        }
    return results


def online_routerbench(*, family: str = "mf", embed_sigma: float = 0.5,
                       cfg=None, seed: int = 0, device: DeviceLike = None,
                       **kw) -> dict:
    """The online benchmark: live traffic with embedding-perturbation
    drift (phases ≥ 1 route on a moved representation), a FedLoop-
    maintained router vs frozen client-local fits. A front end over
    ``fed.scenarios.run_online_vs_frozen``; its AUC is the AIQ here."""
    from repro_torch.fed.scenarios import (ScenarioConfig,
                                           run_online_vs_frozen)
    if cfg is None:
        cfg = ScenarioConfig(embed_sigma=embed_sigma)
    res = run_online_vs_frozen(cfg, family=family, seed=seed, device=device,
                               **kw)
    return {"family": family, "embed_sigma": float(cfg.embed_sigma), **res}
