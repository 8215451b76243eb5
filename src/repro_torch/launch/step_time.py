"""Time engine decode steps of the served pair at full width: qwen2-1.5b
and yi-6b (random weights from a seed) behind a ``RoutedServer``, each
lane holding 8 requests, one step decoding one chunk per lane, as in
``chip_smoke.py``'s ``profile`` phase. Each repeat admits a fresh set
of requests, decodes a first chunk untimed, times the next step (host
and device, between two synchronizations) and drains.

    python -m repro_torch.launch.step_time [--repeats 20] [--entry]

Runs on the card. Prints one JSON line: the card's name, the median and
every step's milliseconds. ``--entry`` instead times the host cost of the
paged decode kernel's entry point (``kernels.ops.paged_decode_attention``)
against the CUDA wrapper it calls, at yi-6b's served shape: microseconds
per call over 2,000 calls in 5 rounds, the two interleaved, and the
host cost of an accounting region (``kernels.costs.kernel``) with
nothing counting. With another checkout's ``src`` first on
``PYTHONPATH``, run as ``python src/repro_torch/launch/step_time.py``,
it times that checkout's package (it uses only the serving entry
points), so two versions can be compared on one card in one run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from typing import Optional

PROMPTS = ["translate this sentence to french please",
           "prove that the sum of two even numbers is even",
           "write a haiku about the ocean at night",
           "explain how a hash map handles collisions",
           "what is the capital of australia and why",
           "summarize the plot of hamlet in two lines",
           "give three uses of a paperclip",
           "how do vaccines train the immune system"]


def entry_cost(torch, dev, calls: int = 2000, rounds: int = 5) -> dict:
    """Host µs per call of the entry point and of the bare CUDA wrapper,
    each call queued without a synchronization (the kernel takes less
    time than the host work of a call, so the host loop sets the time)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(0)
    B, Hkv, grp, hd, ps, npg, P = 8, 4, 8, 128, 16, 16, 129
    q = torch.randn((B, Hkv, grp, hd), generator=g, device=dev,
                    dtype=torch.bfloat16)
    kp, vp = (torch.randn((P, Hkv, ps, hd), generator=g, device=dev,
                          dtype=torch.bfloat16) for _ in range(2))
    table = (torch.arange(B * npg, device=dev, dtype=torch.int32)
             .reshape(B, npg) % (P - 1) + 1)
    nv = torch.full((B,), npg * ps - 3, device=dev, dtype=torch.int32)
    fns = {"entry": lambda: ops.paged_decode_attention(q, kp, vp, table, nv),
           "cuda_wrapper": lambda: da.paged_decode_attention_cuda(
               q, kp, vp, table, nv)}
    out = {k: [] for k in fns}
    for fn in fns.values():                     # builds and warms up
        fn()
    for _ in range(rounds):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            out[name].append((time.perf_counter() - t0) / calls * 1e6)
            torch.cuda.synchronize()
    res = {k: {"median_us": statistics.median(v), "us": v}
           for k, v in out.items()}
    res["region"] = region_cost()
    return res


def region_cost(calls: int = 200_000, rounds: int = 5) -> Optional[dict]:
    """Host µs per ``with kernel(...)`` region entered and left with no
    ``OpCosts`` counting (what every kernel entry pays), beside the same
    loop with an empty body; None where the package has no such region."""
    try:
        from repro_torch.kernels.costs import kernel
    except ImportError:
        try:
            from repro_torch.launch.op_analysis import kernel
        except ImportError:
            return None
    work = (lambda: (0, 0))

    def with_region():
        for _ in range(calls):
            with kernel("k", work):
                pass

    def bare():
        for _ in range(calls):
            pass

    out = {"region": [], "loop": []}
    for _ in range(rounds):
        for name, fn in (("region", with_region), ("loop", bare)):
            t0 = time.perf_counter()
            fn()
            out[name].append((time.perf_counter() - t0) / calls * 1e6)
    return {k: {"median_us": statistics.median(v), "us": v}
            for k, v in out.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=20)
    ap.add_argument("--entry", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from repro_torch import routers
    from repro_torch.config import RouterConfig
    from repro_torch.configs import get_config
    from repro_torch.serve.gateway import RoutedServer, make_pool_model
    if not torch.cuda.is_available():
        raise SystemExit("step_time runs on the card: no CUDA device")
    dev = torch.device("cuda", 0)
    if args.entry:
        row = {"script": "step_time", "device": torch.cuda.get_device_name(0),
               **entry_cost(torch, dev)}
        print(json.dumps(row), flush=True)
        return row
    gen = torch.Generator(device=dev).manual_seed(0)
    pool = [make_pool_model(a, get_config(a), c, gen=gen, device=dev)
            for a, c in (("qwen2-1.5b", 0.05), ("yi-6b", 0.4))]
    router = routers.make("mlp", RouterConfig(num_models=2)).init(
        gen, device=dev)
    srv = RoutedServer(pool, router, device=dev)
    eng = srv.engine
    times = []
    for i in range(args.repeats + 1):
        for m, pm in enumerate(pool):
            for p in PROMPTS:
                eng.submit(m, srv._tokenize([p], pm.cfg, None)[0], 32)
        eng.step()                              # admission + first chunk
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        if i:                                   # the first is a warm-up
            times.append((time.perf_counter() - t0) * 1e3)
        eng.drain()
    row = {"script": "step_time", "device": torch.cuda.get_device_name(0),
           "chunk": eng.ecfg.chunk, "median_ms": statistics.median(times),
           "ms": times}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
