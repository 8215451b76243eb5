"""Federated-router training driver over the clients mesh (PyTorch
counterpart of ``repro/launch/fed_train.py``).

Builds the synthetic corpus (d_emb 64, 11 models) and its federated split
over ``--clients`` clients, places the client slab on a ``"clients"``
mesh (``sharding.shard_clients``: each process holds its block of
clients), fits the MLP router by FedAvg (Alg. 1) for ``--rounds`` rounds
through ``routers.fit_federated(..., mesh=)`` — each process trains its
clients, the aggregation runs replicated — and prints, from rank 0 only,
the per-round loss trajectory and the global-test frontier AUC.

One process per device, under ``torch.distributed.run``:

  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 2 -m repro_torch.launch.fed_train --device cpu
  PYTHONPATH=src python -m torch.distributed.run --standalone \\
      --nproc-per-node 1 -m repro_torch.launch.fed_train

Run alone it forms a one-process group. The backend is nccl on CUDA
(each process on the card of its local rank) and gloo with
``--device cpu``. ``--clients`` must divide the number of processes'
clients axis. Runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse
import os
import socket


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--queries", type=int, default=4000)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    import torch
    import torch.distributed as dist

    from repro_torch import routers, sharding as shd
    from repro_torch.config import FedConfig, RouterConfig
    from repro_torch.core import policy
    from repro_torch.data.partition import federated_split
    from repro_torch.data.synthetic import make_eval_corpus
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    own = not dist.is_initialized()
    if own:
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "RANK" in os.environ:              # under torch.distributed.run
            dist.init_process_group(backend)
        else:
            dist.init_process_group(
                backend, init_method=f"tcp://localhost:{_free_port()}",
                world_size=1, rank=0)
    try:
        world, rank = dist.get_world_size(), dist.get_rank()
        if args.clients % world:
            raise SystemExit(f"--clients {args.clients} must divide the "
                             f"{world} processes of the clients mesh")
        corpus = make_eval_corpus(torch.Generator(device=dev).manual_seed(0),
                                  n_queries=args.queries, d_emb=64)
        rcfg = RouterConfig(d_emb=64, num_models=11)
        fcfg = FedConfig(num_clients=args.clients)
        split = federated_split(torch.Generator(device=dev).manual_seed(1),
                                corpus, fcfg)
        mesh = shd.client_mesh()
        # the slab stays distributed: each process holds its own clients
        train = shd.shard_clients(split["train"], mesh)
        router, hist = routers.fit_federated(
            routers.make("mlp", rcfg), train, fcfg, gen=2,
            rounds=args.rounds, mesh=mesh, device=dev)
        losses = hist["loss"]
        tg = split["test_global"]
        *_, auc = policy.eval_router(router.predict, tg["x"],
                                     tg["acc_table"], tg["cost_table"])
        if rank == 0:
            print(f"device: {dev}, processes: {world}, clients: "
                  f"{args.clients}")
            print("loss: " + " ".join(f"{v:.4f}" for v in losses))
            print(f"loss: {losses[0]:.4f} → {losses[-1]:.4f}; global-test "
                  f"AUC {auc:.3f}", flush=True)
        return {"loss": losses, "auc": auc, "world": world}
    finally:
        if own:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
