"""Run one cell of ``BENCHMARK.json`` and print its result line.

    python3 -m perfbench.run --workload dense-chat --seed 7 --seconds 51 \\
        --trace 0

Run from the root of a checkout. Exits non-zero without a result when
there is no CUDA device or fewer than the cell asks for, when the port
cannot be imported, or when JAX or the JAX package was loaded by the time
the window closed. Every build and kernel cache lives under
``.perfbench_cache/`` in the checkout.

Standard error ends with the numbers the comparison held against their
limits; the last line of standard output is the JSON result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` (with ``--trace 1``
also ``busy_s`` and ``window_s``), ``breakdown`` (``--trace 1``) and, last,
``checks``.
"""
import os
import time


def _process_age() -> float:
    """Seconds since this process started (from /proc)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".perfbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton"),
                 ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                 ("CUDA_CACHE_PATH", "nv")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
os.environ["USE_JAX"] = "0"
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def finite(v: float) -> float:
    return v if math.isfinite(v) else 1e30


def load(workload: str, root: Path = ROOT) -> dict:
    """The cell's entry and every file it names, by name."""
    from perfbench import bench
    from perfbench.traffic import gen
    spec = bench.load_spec(root)
    cell = bench.cell_of(spec, workload)
    return {"spec": spec, "cell": cell,
            "config": bench.load_json("configs", cell["config"]),
            "mix": gen.load(cell["traffic"]),
            "limits": bench.load_json("limits", workload)}


def run(workload: str, seed: int, seconds: float, traced: bool) -> dict:
    """One run of a cell on the CUDA device (which it requires), in a
    process of one CPU thread for torch, refused if JAX or the JAX package
    was loaded by the time the window closed."""
    import torch
    parts = load(workload)
    chips = int(parts["cell"]["chips"])
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the port "
                         "on the GPU")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"{workload} needs {chips} CUDA devices, "
                         f"{torch.cuda.device_count()} seen")
    torch.set_num_threads(1)
    got = run_cell(parts, seed, seconds, traced, torch.device("cuda", 0))
    from perfbench import bench
    found = bench.banned_modules()
    if found:       # checked after the window, before any result
        raise SystemExit("JAX or the JAX package was loaded: "
                         + ", ".join(found))
    return got


def run_cell(parts: dict, seed: int, seconds: float, traced: bool,
             device) -> dict:
    """Set-up, warm traffic, the window and the checks of one cell, its
    files given (``load``) and its device chosen."""
    import torch

    from perfbench import bench, check, reduce
    from perfbench.traffic import gen

    t_begin = time.perf_counter()
    spec, cell, config, mix, limits = (parts[k] for k in (
        "spec", "cell", "config", "mix", "limits"))
    workload = cell["name"]
    device = torch.device(device)
    d_emb = int(config["router"]["d_emb"])
    vocab = min(m["vocab_size"] for m in config["models"])
    stream = gen.stream(mix, seed, seconds, d_emb, vocab)

    t_build = time.perf_counter()
    server = bench.Server(config, mix, seed, device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_prewarm = time.perf_counter()
    server.prewarm(stream)
    t_warm = time.perf_counter()
    gc.collect()
    gc.freeze()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rec = bench.drive(server, stream, seconds, trace=traced)
    gc.unfreeze()
    rec["setup_s"] = rec["t0"] - T_START
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    server.close()

    # the comparison, with the port's state freed
    picked = check.sample(rec, seed, mix)
    gaps = (check.served_gaps(rec, stream, config, seed, picked,
                              device)["f32"] if picked else {})
    numbers = {"route_mismatch": check.route_mismatch(rec, stream, config,
                                                       device),
               "served_gap": gaps.get("max", float("inf")),
               "served_gap_mean": gaps.get("model_mean", float("inf"))}
    checks = {k: {"value": finite(numbers[k]), "limit": v["limit"]}
              for k, v in limits.items()}
    correct = bool(picked) and all(c["value"] <= c["limit"]
                                   for c in checks.values())

    metrics = {}
    for m in bench.metrics_for(spec, workload, traced):
        v = bench.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    win = check.window_requests(rec)
    status = rec["req"]["status"][win]
    failed = int(sum(1 for s in status if s and s not in bench.SUCCESS))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak),
           "power": power_limit() if device.type == "cuda" else "cpu"}
    out = {"correct": correct, "attempted": int(len(win)),
           "failed": failed, "metrics": metrics, "device": dev}
    if traced:
        from perfbench import trace
        summ = trace.device_summary(rec["trace"])
        if summ:
            dev["busy_s"], dev["window_s"] = summ["busy_s"], summ["window_s"]
            out["breakdown"] = {"device_ops": summ["device_ops"],
                                "idle_gaps": summ["idle_gaps"]}
    out["checks"] = checks
    # TPOT is kept for the record only: its run-to-run spread follows the
    # host's speed and is too wide for a bound (PERF.md)
    info = {"numbers": numbers,
            "tpot_p90_ms": reduce.p90(reduce.tpot_ms(rec)),
            "setup_parts_s": {
                "start_and_imports": t_begin - T_START,
                "traffic": t_build - t_begin,
                "weights_and_server": t_prewarm - t_build,
                "prewarm": t_warm - t_prewarm,
                "warm_traffic": rec["t0"] - t_warm},
            "sampled_requests": len(picked),
            "sampled_tokens": int(sum(rec["req"]["O"][i] for i in picked)),
            "shares": {config["models"][mi]["name"]:
                       float((rec["req"]["model"][win] == mi).mean())
                       for mi in range(len(config["models"]))}
            if len(win) else {}}
    return {"result": out, "info": info, "record": rec}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    got = run(a.workload, a.seed, a.seconds, bool(a.trace))
    res, info = got["result"], got["info"]
    log("info " + json.dumps(info))
    for name, c in res["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
