"""Quickstart of the PyTorch port: federated LLM-router training end to end.

The torch twin of ``examples/quickstart.py``: builds a synthetic
RouterBench-like corpus, partitions it across 10 heterogeneous clients
(Dirichlet α=0.6, one logged model per query), fits the federated
MLP-Router (Alg. 1, FedAvg) and the federated K-Means-Router (Alg. 2,
one-shot) through ``repro_torch.routers``, fits client-local MLP baselines
on 3 clients, and prints the four global-test frontier AUCs (federated MLP,
federated K-means, client-local mean, oracle).

    PYTHONPATH=src python -m repro_torch.quickstart           # on the GPU
    PYTHONPATH=src python -m repro_torch.quickstart --device cpu
    PYTHONPATH=src python -m repro_torch.quickstart --full    # 768-d, 36k

The default sizes are the reference quickstart's (d_emb 48, 4,000 queries,
20 rounds), so the two can be compared; ``--full`` runs the paper's
router width: d_emb 768 (all-mpnet-base-v2), 36,000 queries × 8 tasks ×
11 models (the size of RouterBench's grid) and ``FedConfig()`` (30 rounds).
The corpus is drawn from a torch generator, so its numbers differ from the
reference's for one seed.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import policy
from repro_torch.data.partition import client_slice, federated_split
from repro_torch.data.synthetic import make_eval_corpus
from repro_torch.device import resolve_device


def run(*, full: bool = False, device=None, seed: int = 0,
        log=print) -> dict:
    """The quickstart's fits; returns their frontier AUCs and seconds."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if full:
        rcfg, fcfg, n_queries = RouterConfig(), FedConfig(), 36_000
    else:
        rcfg, fcfg, n_queries = RouterConfig(d_emb=48), FedConfig(rounds=20), 4000
    log(f"== corpus: {n_queries} queries × 8 tasks × {rcfg.num_models} "
        f"models, d_emb {rcfg.d_emb}, on {dev} ==")
    corpus = make_eval_corpus(gen, n_queries=n_queries, n_tasks=8,
                              n_models=rcfg.num_models, d_emb=rcfg.d_emb)
    split = federated_split(gen, corpus, fcfg)
    tg = split["test_global"]

    def auc(router):
        *_, a = policy.eval_router(router.predict, tg["x"], tg["acc_table"],
                                   tg["cost_table"])
        return a

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    out = {}
    log(f"== federated MLP-Router (Algorithm 1, {fcfg.rounds} rounds) ==")
    (fed_mlp, hist), out["mlp_seconds"] = timed(lambda: routers.fit_federated(
        routers.make("mlp", rcfg), split["train"], fcfg, gen=gen, device=dev))
    log(f"   round loss {hist['loss'][0]:.3f} → {hist['loss'][-1]:.3f}")
    log("== federated K-Means-Router (Algorithm 2, one-shot) ==")
    (fed_km, _), out["kmeans_seconds"] = timed(
        lambda: routers.fit_federated(routers.make("kmeans", rcfg),
                                      split["train"], fcfg, gen=gen,
                                      device=dev))
    log("== client-local baselines (3 representative clients) ==")
    loc = []
    for i in range(3):
        r, _ = routers.fit_local(routers.make("mlp", rcfg),
                                 client_slice(split["train"], i), fcfg,
                                 gen=gen, device=dev, steps=300)
        loc.append(auc(r))

    class _Oracle:
        predict = staticmethod(lambda x: (tg["acc_table"], tg["cost_table"]))

    out.update(fed_mlp=auc(fed_mlp), fed_kmeans=auc(fed_km),
               local_mean=float(np.mean(loc)), oracle=auc(_Oracle))
    log("\nglobal-test frontier AUC:")
    log(f"  federated MLP-Router     {out['fed_mlp']:.3f}")
    log(f"  federated K-Means-Router {out['fed_kmeans']:.3f}")
    log(f"  client-local mean        {out['local_mean']:.3f}")
    log(f"  oracle                   {out['oracle']:.3f}")
    log("\n== routing a few queries at different λ ==")
    for lam in (0.0, 1.0, 100.0):
        log(f"  λ={lam:<6}→ MLP {fed_mlp.route(tg['x'][:5], lam).tolist()}"
            f"  K-means {fed_km.route(tg['x'][:5], lam).tolist()}")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="the paper's router width: d_emb 768, 36,000 "
                         "queries, FedConfig() defaults")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    run(full=args.full, device=args.device, seed=args.seed)


if __name__ == "__main__":
    main()
