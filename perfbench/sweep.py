"""Find a chat cell's knee: the highest offered rate at which the backlog
does not grow over the window; or, for a closed loop, read its tokens/s
at several backlogs.

    python3 -m perfbench.sweep --workload dense-chat --rates 2,3,4 \\
        --seconds 40 --warm 40 --seed 11
    python3 -m perfbench.sweep --workload dense-docs --backlogs 16,32 \\
        --seconds 40 --seed 12

One process builds the cell once and runs its mix at each rate (or
backlog) in turn: warm traffic, the window, then every request still in
flight is cancelled (``RoutedServer.cancel``). Each rate prints
one JSON line: requests due and completed in the window, output tokens/s,
the queue (requests due and not yet admitted) read at every step's end —
its mean, its last reading and its slope in requests/s —, TTFT and TPOT
at p50 and p90, the mean step and the mean rows a step decoded. A backlog
that grows shows as a positive slope and a last reading well above the
mean. The cell's rate is then 0.8 × the knee, written into its traffic
file.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from perfbench import run as R  # sets the cache directories and sys.path


def queue_stats(rec) -> dict:
    r = rec["req"]
    due = np.asarray(r["due"], np.float64)
    first = np.asarray(r["t_first"], np.float64)
    first = np.where(np.isnan(first), np.inf, first)
    t_end = np.asarray(rec["steps"]["t_end"])
    t_end = t_end[(t_end >= rec["t0"]) & (t_end <= rec["t1"])]
    q = np.array([np.sum((due <= t) & (first > t)) for t in t_end])
    slope = (float(np.polyfit(t_end - rec["t0"], q, 1)[0])
             if len(q) > 2 else float("nan"))
    return {"queue_mean": float(q.mean()) if len(q) else 0.0,
            "queue_last": int(q[-1]) if len(q) else 0,
            "queue_slope_per_s": slope}


def args_of(a, mix) -> list:
    """[(traffic key, value)] to sweep: rates of an open loop, backlogs of
    a closed one."""
    if mix["loop"] == "open":
        return [("rate_per_s", float(v)) for v in a.rates.split(",") if v]
    return [("backlog", int(v)) for v in a.backlogs.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", default="",
                    help="offered rates in requests/s, comma-separated")
    ap.add_argument("--backlogs", default="",
                    help="closed loop: outstanding requests, comma-separated")
    ap.add_argument("--warm", type=float, default=None,
                    help="warm traffic: seconds (open loop) or steps "
                    "(closed loop); default: the mix's")
    ap.add_argument("--seconds", type=float, default=40.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    import torch

    from perfbench import bench, reduce
    from perfbench.traffic import gen
    parts = R.load(a.workload)
    config, mix = parts["config"], parts["mix"]
    if args_of(a, mix) == []:
        raise SystemExit("give --rates for an open loop, --backlogs for a "
                         "closed one")
    dev = torch.device("cuda", 0)
    d_emb = int(config["router"]["d_emb"])
    vocab = min(m["vocab_size"] for m in config["models"])
    server = bench.Server(config, mix, a.seed, dev)
    server.prewarm(gen.stream(mix, a.seed, a.seconds, d_emb, vocab))
    for key, val in args_of(a, mix):
        m = dict(mix, **{key: val})
        if a.warm is not None and mix["loop"] == "open":
            m["warm_s"] = a.warm
        elif a.warm is not None:
            m["warm_steps"] = int(a.warm)
        stream = gen.stream(m, a.seed, a.seconds, d_emb, vocab)
        rec = bench.drive(server, stream, a.seconds)
        r = rec["req"]
        done = np.asarray(r["t_done"], np.float64)
        comp = int(np.sum((done > rec["t0"]) & (done <= rec["t1"])))
        ttft, tpot = reduce.ttft_ms(rec), reduce.tpot_ms(rec)
        row = {"workload": a.workload, key: val,
               "window_s": rec["t1"] - rec["t0"],
               "due_in_window": int(len(ttft)), "completed": comp,
               "completed_per_s": comp / (rec["t1"] - rec["t0"]),
               "output_tok_s": reduce.output_tok_s(rec),
               **queue_stats(rec),
               "ttft_p50_ms": float(np.median(ttft)) if len(ttft) else None,
               "ttft_p90_ms": reduce.p90(ttft),
               "tpot_p50_ms": float(np.median(tpot)) if len(tpot) else None,
               "tpot_p90_ms": reduce.p90(tpot),
               "step_ms": reduce.mean_step_ms(rec),
               "rows": reduce.mean_rows(rec),
               "device": torch.cuda.get_device_name(dev),
               "power": R.power_limit()}
        print(json.dumps(row), flush=True)
        for i in np.nonzero(np.asarray(r["step_done"]) < 0)[0]:
            server.srv.cancel(int(r["rid"][i]))
        server.srv.drain()
    return 0


if __name__ == "__main__":
    sys.exit(main())
