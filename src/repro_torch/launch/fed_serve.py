"""Online federation runtime driver: serve → harvest → federate → swap
(PyTorch counterpart of ``repro/launch/fed_serve.py``).

Drives live heterogeneous traffic through the continuous-batching engine
while the ``FedLoop`` harvests per-client evaluations, refits the router
federatedly over the harvested buffers, and hot-swaps the new state under
traffic — then reports the online router's frontier AUC against
per-client routers frozen after the first phase (the no-federation
deployment).

  PYTHONPATH=src python -m repro_torch.launch.fed_serve --clients 6 --phases 2
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --secure-agg --dp 0.01
  PYTHONPATH=src python -m repro_torch.launch.fed_serve --device cpu

Runs on the CUDA device unless ``--device`` names another.
"""
from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--clients", type=int, default=6)
    ap.add_argument("--phases", type=int, default=2)
    ap.add_argument("--queries-per-phase", type=int, default=96)
    ap.add_argument("--drift", type=float, default=1.0)
    ap.add_argument("--onboard-phase", type=int, default=None,
                    help="phase at which a reserved model joins the pool")
    ap.add_argument("--secure-agg", action="store_true",
                    help="aggregate syncs with pairwise secure-agg masking")
    ap.add_argument("--dp", type=float, default=0.0,
                    help="central-DP noise sigma on the aggregate")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    from repro_torch.fed.aggregators import (FedAvgAggregator,
                                             GaussianDPAggregator,
                                             SecureAggAggregator)
    from repro_torch.fed.scenarios import (ScenarioConfig,
                                           run_online_vs_frozen)

    agg = SecureAggAggregator() if args.secure_agg else None
    if args.dp > 0.0:
        agg = GaussianDPAggregator(sigma=args.dp,
                                   inner=agg or FedAvgAggregator())

    cfg = ScenarioConfig(n_clients=args.clients, phases=args.phases,
                         queries_per_phase=args.queries_per_phase,
                         drift=args.drift)
    m = run_online_vs_frozen(cfg, aggregator=agg,
                             onboard_phase=args.onboard_phase,
                             device=args.device)
    print(f"served {m['requests_served']} requests, harvested "
          f"{m['harvested_samples']} evaluations "
          f"({m['harvest_bytes'] / 2 ** 10:.0f} KiB, bounded), "
          f"{m['syncs']} federated syncs → router v{m['router_version']}")
    for p, (on, fr) in enumerate(zip(m["auc_online"],
                                     m["auc_frozen_local"])):
        tag = " (drifted)" if p > 0 else ""
        print(f"phase {p}{tag}: frontier AUC online {on:.3f} vs "
              f"frozen client-local {fr:.3f}")
    print(f"final gap: {m['auc_gap_final']:+.3f} "
          f"({m['num_models_final']} pool models)")
    return m


if __name__ == "__main__":
    main()
