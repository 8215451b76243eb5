"""Routed serving end to end (the PyTorch twin of
``examples/routed_serving.py``).

Builds a pool of two reduced models of the assigned architectures
(qwen2-1.5b and yi-6b, random weights from seeded generators), fits a
federated MLP router on synthetic evaluations of that pool through
``repro_torch.routers``, then serves a batch of prompts through
``RoutedServer``: per-request model selection through the fused
``router_utility`` kernel on the GPU, prefill and paged decode, λ chosen
at request time. λ 0 should send every prompt to the big model, λ 2 most
of them to the cheap one.

  PYTHONPATH=src python -m repro_torch.routed_serving              # GPU
  PYTHONPATH=src python -m repro_torch.routed_serving --device cpu
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import routers
from repro_torch.config import FedConfig, RouterConfig
from repro_torch.configs import get_config
from repro_torch.data.encoder import encode
from repro_torch.device import resolve_device
from repro_torch.serve.gateway import RoutedServer, make_pool_model

PROMPTS = [
    "translate this sentence to french please",
    "prove that the sum of two even numbers is even",
    "write a short poem about autumn leaves",
    "derive the gradient of the softmax cross entropy loss",
    "summarize the plot of the odyssey in two lines",
    "solve the recurrence t(n) = 2 t(n/2) + n",
]


def synth_evals(pool, d_emb: int, N: int = 4, D: int = 200,
                seed: int = 0) -> dict:
    """Per-client evaluations of the pool: easy prompts (short words) are
    fine on the cheap model, hard ones only on the big one."""
    rng = np.random.default_rng(seed)
    words_easy = ["summarize", "translate", "poem", "short", "lines"]
    words_hard = ["prove", "derive", "solve", "gradient", "recurrence"]
    data = {k: np.zeros((N, D) + s, np.float32) for k, s in
            [("x", (d_emb,)), ("m", ()), ("acc", ()), ("cost", ()), ("w", ())]}
    for i in range(N):
        for j in range(D):
            hard = rng.random() < 0.5
            vocab = words_hard if hard else words_easy
            text = " ".join(rng.choice(vocab, size=5))
            data["x"][i, j] = encode([text], d_emb)[0]
            m = int(rng.integers(0, len(pool)))
            p_correct = (0.9 if m == 1 else (0.25 if hard else 0.85))
            data["m"][i, j] = m
            data["acc"][i, j] = float(rng.random() < p_correct)
            data["cost"][i, j] = pool[m].cost_per_token
            data["w"][i, j] = 1.0
    data["m"] = data["m"].astype(np.int32)
    return data


def run(*, device=None, log=print) -> dict:
    """Build, fit and serve; returns {λ: generate's output}."""
    dev = resolve_device(device)
    d_emb = 64
    log("== building model pool (reduced assigned architectures) ==")
    pool = []
    for i, (arch, cost) in enumerate([("qwen2-1.5b", 0.05),
                                      ("yi-6b", 0.4)]):
        pool.append(make_pool_model(arch, get_config(arch).reduced(), cost,
                                    gen=i, device=dev))
        log(f"   {arch}: cost/token {cost}")

    log("== synthesizing per-client evaluations of the pool ==")
    N = 4
    data = synth_evals(pool, d_emb, N=N)
    rcfg = RouterConfig(d_emb=d_emb, num_models=len(pool), hidden=(64, 64))
    fcfg = FedConfig(num_clients=N, rounds=15, batch_size=32)

    log("== federated router training over the pool evaluations ==")
    router, hist = routers.fit_federated(routers.make("mlp", rcfg), data,
                                         fcfg, gen=2, device=dev)
    log(f"   loss {hist['loss'][0]:.3f} → {hist['loss'][-1]:.3f}")

    srv = RoutedServer(pool, router, device=dev)
    out = {}
    for lam in (0.0, 2.0):
        out[lam] = srv.generate(PROMPTS, lam=lam, max_new_tokens=4)
        log(f"\n== λ={lam}: total cost {out[lam]['total_cost']:.2f} ==")
        for p, r in zip(PROMPTS, out[lam]["results"]):
            log(f"   [{r['model']:<12}] {p[:48]}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    return run(device=ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
