"""The comparison that decides ``correct``: what the timed path served,
held against the plain reference (``reference/model.py``), once the
window has closed and the port's state is freed.

The numbers (``NUMBERS``); a cell compares those that its
``limits/<cell>.json`` gives a limit, and prints the others:

* ``route_mismatch`` — of every request due (open loop) or submitted
  (closed loop) in the window, those the gateway sent to another model
  than the reference router's argmax of A − λ·C, where the reference's
  utilities of the two models differ by more than ``TIE`` (f32 rounding
  in the trunk and the kernel moves a utility by about 1e-6, so only a
  tie closer than that may go either way). An exact comparison: limit 0.
* ``served_gap`` — over a sample of the requests finished in the window,
  drawn from the seed, with each model's longest in it, at least the
  mix's ``check_requests`` requests (so that rows all over the decode
  batch are sampled) and ``check_tokens`` served tokens: the widest gap
  by which a served (greedy) token's logit lies below the reference's
  best logit at that position, the reference run once over prompt +
  served tokens of each.
* ``served_gap_mean`` — on the same sample, each model's mean gap over
  its served positions, the largest of the models'. Where a mixture of
  experts routes near-ties differently in bf16 than in f32, single
  positions swing by whole logits and only this number separates the
  port from the control.

The reference works from the weights made again from the seed
(``weights.make_params``) and the benchmark's own inputs; it reads the
port's output only to judge it. ``precision="fp8"`` gives the control's
reading on the same sample: the gap of the token that the fp8 reference
puts first at each position.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

from perfbench import weights
from perfbench.reference import model as ref

TIE = 1e-4


def window_requests(rec) -> np.ndarray:
    r = rec["req"]
    if rec["loop"] == "open":
        due = np.asarray(r["due"], np.float64)
        inw = (due >= rec["t0"]) & (due < rec["t0"] + rec["seconds"])
    else:
        t = np.asarray(r["t_submit"], np.float64)
        inw = (t >= rec["t0"]) & (t < rec["t1"])
    return np.nonzero(inw)[0]


def route_mismatch(rec, stream, config: dict, device) -> int:
    idx = window_requests(rec)
    if len(idx) == 0:
        return 0
    items = [stream.item(int(rec["req"]["k"][i])) for i in idx]
    x = torch.as_tensor(np.stack([it[2] for it in items]), device=device)
    lam = torch.as_tensor([it[3] for it in items], dtype=torch.float32,
                          device=device)
    state = weights.router_state(
        config["router"], [m["cost_per_token"] for m in config["models"]],
        device)
    U = ref.router_utility(state, x, lam).cpu().numpy()
    served = np.asarray(rec["req"]["model"])[idx]
    gap = U.max(axis=1) - U[np.arange(len(idx)), served]
    return int(np.sum(gap > TIE))


def sample(rec, seed: int, mix: dict) -> List[int]:
    """Requests finished in the window: each model's longest, then others
    in an order drawn from the seed until there are ``check_requests`` of
    them and ``check_tokens`` served tokens."""
    r = rec["req"]
    done = np.asarray(r["t_done"], np.float64)
    fin = np.nonzero((done > rec["t0"]) & (done <= rec["t1"]))[0]
    if len(fin) == 0:
        return []
    O = np.asarray(r["O"])
    model = np.asarray(r["model"])
    picked: List[int] = []
    for mi in sorted(set(model[fin].tolist())):
        own = fin[model[fin] == mi]
        picked.append(int(own[np.argmax(O[own])]))
    rest = [int(i) for i in np.random.default_rng([int(seed), 11]).permutation(fin)
            if int(i) not in picked]
    while rest and (len(picked) < int(mix["check_requests"])
                    or int(O[picked].sum()) < int(mix["check_tokens"])):
        picked.append(rest.pop(0))
    return picked


def served_gaps(rec, stream, config: dict, seed: int, picked: Sequence[int],
                device, precisions=("f32",)) -> Dict[str, Dict[str, float]]:
    """{precision: {"max": widest gap, "model_mean": the largest of the
    models' mean gaps over their positions, "p99", "mean", "frac": share
    of positions with a gap}} over the picked requests: "f32" the served
    tokens', "fp8" the fp8 reference's first choices'."""
    r = rec["req"]
    gaps: Dict[str, list] = {p: [] for p in precisions}
    means: Dict[str, list] = {p: [] for p in precisions}
    bad = set()
    models = config["models"]
    for mi in sorted({int(r["model"][i]) for i in picked}):
        mine = [i for i in picked if int(r["model"][i]) == mi]
        m = models[mi]
        params = weights.make_params(m, seed, mi, device)
        seqs, starts, served = [], [], []
        for i in mine:
            toks = torch.as_tensor(stream.tokens(int(r["k"][i])),
                                   device=device).long()
            got = torch.as_tensor(rec["tokens"][i], device=device).long()
            V = m["vocab_size"]
            seqs.append(torch.cat([toks, got[:-1].clamp(0, V - 1)]))
            starts.append(len(toks) - 1)
            served.append(got)
        best = ref.logits(m, params, seqs, starts, "f32")
        for p in precisions:
            n0 = len(gaps[p])
            if p == "f32":
                picks = served
            else:
                picks = [lg.argmax(-1) for lg in
                         ref.logits(m, params, seqs, starts, p)]
            for lg, pk in zip(best, picks):
                if len(pk) != len(lg) or int(pk.min()) < 0 or int(
                        pk.max()) >= lg.shape[1]:
                    bad.add(p)      # a token this model cannot emit
                    continue
                g = lg.max(-1).values - lg.gather(1, pk[:, None])[:, 0]
                gaps[p].append(g.cpu())
            if len(gaps[p]) > n0:
                means[p].append(float(torch.cat(gaps[p][n0:]).mean()))
        del params, best
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    out = {}
    for p, gs in gaps.items():
        g = torch.cat(gs) if gs else torch.zeros(1)
        out[p] = {"max": float("inf") if p in bad else float(g.max()),
                  "model_mean": (float("inf") if p in bad
                                 else max(means[p], default=0.0)),
                  "p99": float(torch.quantile(g, 0.99)),
                  "mean": float(g.mean()), "frac": float((g > 0).float().mean())}
    return out
