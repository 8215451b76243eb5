"""Federated-router training driver (PyTorch counterpart of
``repro/launch/fed_train.py``).

Builds the synthetic corpus (d_emb 64, 11 models) and its federated split
over ``--clients`` clients, fits the MLP router by FedAvg (Alg. 1) for
``--rounds`` rounds through ``routers.fit_federated`` in process, and
prints the per-round loss trajectory and the global-test frontier AUC.

  PYTHONPATH=src python -m repro_torch.launch.fed_train --clients 16 --rounds 10
  PYTHONPATH=src python -m repro_torch.launch.fed_train --device cpu

Runs on the CUDA device unless ``--device`` names another. Not ported yet
(ROADMAP.md, queue 1 item 4, multi-device): the reference shards the
clients over a device mesh (``shard_map`` and a weighted ``psum``); here
every client trains in one batched pass on one device.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--queries", type=int, default=4000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import routers
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import policy
    from repro_torch.data.partition import federated_split
    from repro_torch.data.synthetic import make_eval_corpus
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    corpus = make_eval_corpus(torch.Generator(device=dev).manual_seed(0),
                              n_queries=args.queries, d_emb=64)
    rcfg = RouterConfig(d_emb=64, num_models=11)
    fcfg = FedConfig(num_clients=args.clients)
    split = federated_split(torch.Generator(device=dev).manual_seed(1),
                            corpus, fcfg)
    print(f"device: {dev}, clients: {args.clients}")
    router, hist = routers.fit_federated(routers.make("mlp", rcfg),
                                         split["train"], fcfg, gen=2,
                                         rounds=args.rounds, device=dev)
    losses = hist["loss"]
    tg = split["test_global"]
    *_, auc = policy.eval_router(router.predict, tg["x"], tg["acc_table"],
                                 tg["cost_table"])
    print("loss: " + " ".join(f"{v:.4f}" for v in losses))
    print(f"loss: {losses[0]:.4f} → {losses[-1]:.4f}; global-test AUC "
          f"{auc:.3f}")
    return {"loss": losses, "auc": auc}


if __name__ == "__main__":
    main()
