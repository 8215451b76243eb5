"""Read the comparison's numbers over many seeds, with the control beside
them, to set a cell's limits (``limits/<cell>.json``).

    python3 -m perfbench.calibrate --workload dense-chat \\
        --seeds 101,102,103 --seconds 30

For each seed, in one process: the cell is built from that seed, runs its
warm traffic and a window of ``--seconds`` at the cell's own load (long
enough to finish the mix's longest requests), and is freed; then the
reference reads, on the run's sample, ``served_gap`` and ``served_gap_mean`` (the
port's served tokens), ``control_gap`` and ``control_gap_mean`` (the
tokens the fp8 reference puts first), and ``route_mismatch``. One JSON
line per seed. The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import sys

from perfbench import run as R  # sets the cache directories and sys.path


def read_seed(parts: dict, seed: int, seconds: float, device,
              precisions=("f32", "fp8")) -> dict:
    from perfbench import bench, check
    from perfbench.traffic import gen
    config, mix = parts["config"], parts["mix"]
    d_emb = int(config["router"]["d_emb"])
    vocab = min(m["vocab_size"] for m in config["models"])
    stream = gen.stream(mix, seed, seconds, d_emb, vocab)
    server = bench.Server(config, mix, seed, device)
    server.prewarm(stream)
    rec = bench.drive(server, stream, seconds)
    server.close()
    picked = check.sample(rec, seed, mix)
    gaps = check.served_gaps(rec, stream, config, seed, picked, device,
                             precisions)
    return {"workload": parts["cell"]["name"], "seed": seed,
            "served_gap": gaps["f32"]["max"],
            "control_gap": gaps["fp8"]["max"] if "fp8" in gaps else None,
            "served_gap_mean": gaps["f32"]["model_mean"],
            "control_gap_mean": (gaps["fp8"]["model_mean"] if "fp8" in gaps
                                 else None),
            "gap_stats": gaps,
            "route_mismatch": check.route_mismatch(rec, stream, config,
                                                   device),
            "sampled_requests": len(picked),
            "sampled_tokens": int(sum(rec["req"]["O"][i] for i in picked))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--control-seeds", type=int, default=3,
                    help="how many of the seeds (the first) also read the "
                         "control")
    a = ap.parse_args(argv)
    import torch
    parts = R.load(a.workload)
    dev = torch.device("cuda", 0)
    for i, s in enumerate(int(v) for v in a.seeds.split(",")):
        prec = ("f32", "fp8") if i < a.control_seeds else ("f32",)
        row = read_seed(parts, s, a.seconds, dev, prec)
        row["device"] = torch.cuda.get_device_name(dev)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
