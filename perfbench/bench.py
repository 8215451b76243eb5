"""Build a cell's system under test and drive its measured window.

``Server`` makes the pool's weights and the router's state (``weights``)
and hands them to ``repro_torch.serve.gateway.RoutedServer`` with a paged
``EngineConfig``; a ``HarvestStore`` is attached only so that
``routed_model(rid)`` names the model a request was sent to (no outcome
is ever reported, so nothing is recorded in it). ``drive`` runs the
mix's loop through the public calls — ``submit(prompt, lam=,
max_new_tokens=, x=, tokenize=)`` and ``step()``, with ``status(rid)`` and
``engine.n_active()`` read between steps — and returns the run's record
(``reduce.py`` lists its fields).

Open loop: each request is submitted at the first step boundary at or
after its due time; while the engine is idle the loop sleeps until the
next one is due. Closed loop: the backlog is topped up before each step
(ramped over the first steps, so admission never takes the whole pool at
once) and each completion frees room for the next request; the window
starts at the end of step ``warm_steps``, so every run's window starts at
the same point of the schedule, whatever the host's speed.

With ``trace=True`` the window's last steps are traced (``trace.Tracer``):
from the first step boundary within ``trace_s`` seconds (or the longest
step so far, if longer) of the window's end, so that at least one whole
step is traced and the trace is read after the window closes.
"""
from __future__ import annotations

import collections
import gc
import importlib.util
import json
import math
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from perfbench import trace as tr
from perfbench import weights

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: top-level module names that no process of the benchmark may hold
BANNED = ("jax", "jaxlib", "flax", "repro")
SUCCESS = ("DONE", "PREEMPTED-resumed")


# ---------------------------------------------------------------- the spec
def load_spec(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def cell_of(spec: dict, name: str) -> dict:
    for c in spec["workloads"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                   f"(have {[c['name'] for c in spec['workloads']]})")


def load_json(kind: str, name: str) -> dict:
    """``perfbench/<kind>/<name>.json`` (configs, traffic, limits)."""
    return json.loads((HERE / kind / f"{name}.json").read_text())


def metrics_for(spec: dict, cell: str, traced: bool) -> List[dict]:
    """The cell's end-to-end metrics (trace 0) or per-layer metrics
    (trace 1): those whose ``workloads`` name it, or that have none."""
    key = "per_layer" if traced else "end_to_end"
    return [m for m in spec[key] if cell in m.get("workloads", [cell])]


def reader(name: str) -> Callable:
    """The ``read(record)`` of ``perfbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"perfbench_metric_{name}",
                                                path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod.read


def banned_modules() -> List[str]:
    """Modules loaded in this process whose top-level name, taken whole,
    is JAX's or the JAX package's."""
    import sys
    return sorted({m for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


# --------------------------------------------------------------- the system
def port_config(m: dict):
    """The port's ``ModelConfig`` of a configuration file's model entry."""
    from repro_torch.config import ModelConfig, MoEConfig
    moe = None
    if weights.is_moe(m):
        moe = MoEConfig(num_experts=m["num_local_experts"],
                        top_k=m["num_experts_per_tok"],
                        d_expert=m["intermediate_size"])
    return ModelConfig(
        name=m["name"], arch_type="moe" if moe else "dense",
        n_layers=m["num_hidden_layers"], d_model=m["hidden_size"],
        n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab=m["vocab_size"], head_dim=m["head_dim"],
        qkv_bias=bool(m.get("qkv_bias", False)),
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        dtype=m["torch_dtype"], moe=moe)


class Server:
    """The routed pool of one configuration, weights from ``seed``."""

    def __init__(self, config: dict, mix: dict, seed: int, device):
        from repro_torch import routers
        from repro_torch.config import RouterConfig
        from repro_torch.fed.harvest import HarvestStore
        from repro_torch.serve.engine import EngineConfig
        from repro_torch.serve.gateway import PoolModel, RoutedServer
        self.config, self.mix, self.device = config, mix, device
        models = config["models"]
        pool = [PoolModel(m["name"], port_config(m),
                          weights.make_params(m, seed, i, device),
                          float(m["cost_per_token"]))
                for i, m in enumerate(models)]
        r = config["router"]
        rcfg = RouterConfig(d_emb=int(r["d_emb"]), num_models=len(pool),
                            hidden=tuple(int(h) for h in r["hidden"]))
        router = routers.make(r["family"], rcfg, state=weights.router_state(
            r, [pm.cost_per_token for pm in pool], device))
        e = config["engine"]
        self.ecfg = EngineConfig(slots=int(e["slots"]),
                                 max_seq=int(mix["max_seq"]),
                                 chunk=int(e["chunk"]),
                                 page_size=int(e["page_size"]),
                                 reserve=e["reserve"])
        self.srv = RoutedServer(pool, router, engine_cfg=self.ecfg,
                                harvest=HarvestStore(int(r["d_emb"]),
                                                     device=device),
                                device=device)

    def prewarm(self, stream) -> None:
        """Before the warm traffic: one request per lane through the
        engine and one through the gateway, drained, so the kernels are
        built and loaded and each lane's pool exists."""
        srv = self.srv
        toks = stream.tokens(0)
        for i in range(len(self.config["models"])):
            srv.engine.submit(i, toks, self.ecfg.chunk)
        _, _, x, lam = stream.item(0)
        srv.submit("", lam=lam, max_new_tokens=self.ecfg.chunk, x=x,
                   tokenize=lambda _p: toks[None], client_id=0)
        srv.drain()

    def close(self) -> None:
        del self.srv
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


# ------------------------------------------------------------- the window
class _Run:
    """The record being written: requests and steps, on the host clock."""

    FIELDS = ("k", "rid", "due", "t_submit", "submit_s", "submit_profiled",
              "t_first", "t_done", "step_admit", "step_done", "model", "P",
              "O", "status")

    def __init__(self, server: Server, stream, clock):
        self.srv, self.stream, self.clock = server.srv, stream, clock
        self.req: Dict[str, list] = {f: [] for f in self.FIELDS}
        self.tokens: Dict[int, np.ndarray] = {}
        self.of_rid: Dict[int, int] = {}
        self.pending = collections.defaultdict(collections.deque)
        self.steps: Dict[str, list] = {"t_start": [], "t_end": [],
                                       "rows": [], "profiled": []}
        self.tracer: Optional[tr.Tracer] = None
        self.trace = None
        self.finished = 0

    def submit(self, k: int, due: float) -> None:
        P, O, x, lam = self.stream.item(k)
        toks = self.stream.tokens(k)
        t0 = self.clock()
        with tr.maybe_span(self.tracer, tr.SUBMIT):
            rid = self.srv.submit("", lam=lam, max_new_tokens=O, x=x,
                                  tokenize=lambda _p: toks[None],
                                  client_id=0)
        t1 = self.clock()
        m = self.srv.routed_model(rid)
        i = len(self.req["k"])
        for f, v in (("k", k), ("rid", rid), ("due", due), ("t_submit", t0),
                     ("submit_s", t1 - t0),
                     ("submit_profiled", self.tracer is not None),
                     ("t_first", math.nan), ("t_done", math.nan),
                     ("step_admit", -1), ("step_done", -1), ("model", m),
                     ("P", P), ("O", O), ("status", "")):
            self.req[f].append(v)
        self.of_rid[rid] = i
        self.pending[m].append(i)

    @property
    def max_wall(self) -> float:
        """The longest step so far (0 before the first)."""
        s = self.steps
        return max((b - a for a, b in zip(s["t_start"], s["t_end"])),
                   default=0.0)

    @property
    def outstanding(self) -> int:
        return len(self.req["k"]) - self.finished

    def step(self) -> float:
        n = len(self.steps["t_start"])
        t0 = self.clock()
        with tr.maybe_span(self.tracer, tr.STEP):
            fin = self.srv.step()
        t1 = self.clock()
        req = self.req
        for rid, payload in fin:
            i = self.of_rid.get(rid)
            if i is None:           # the pre-warm's
                continue
            req["step_done"][i] = n
            self.finished += 1
            if isinstance(payload, np.ndarray):
                req["t_done"][i] = t1
                req["status"][i] = self.srv.status(rid)
                self.tokens[i] = payload
            else:
                req["status"][i] = payload.status
        for dq in self.pending.values():
            while dq:
                i = dq[0]
                if (req["step_done"][i] < 0 and
                        self.srv.status(req["rid"][i]) == "QUEUED"):
                    break
                req["t_first"][i] = t1
                req["step_admit"][i] = n
                dq.popleft()
        s = self.steps
        s["t_start"].append(t0)
        s["t_end"].append(t1)
        s["rows"].append(self.srv.engine.n_active() + len(fin))
        s["profiled"].append(self.tracer is not None)
        if self.tracer is not None:
            self.tracer.step_ids.append(n)
        return t1

    def open_tracer(self) -> None:
        self.tracer = tr.Tracer()

    def close_tracer(self) -> None:
        if self.tracer is not None:
            self.trace = self.tracer.close()
            self.tracer = None


def drive(server: Server, stream, seconds: float, *, trace: bool = False,
          clock=time.perf_counter) -> dict:
    """Warm traffic, then the window; returns the record."""
    run = _Run(server, stream, clock)
    mix = stream.mix
    trace_s = float(mix.get("trace_s", 1.5))
    if mix["loop"] == "open":
        t0, t1 = _open(run, stream, seconds, trace, trace_s, clock)
    else:
        t0, t1 = _closed(run, mix, seconds, trace, trace_s, clock)
    run.close_tracer()
    e = server.ecfg
    return {"loop": mix["loop"], "t0": t0, "t1": t1,
            "seconds": float(seconds),
            "req": {f: np.asarray(v) for f, v in run.req.items()},
            "tokens": run.tokens, "steps": run.steps, "trace": run.trace,
            "models": server.config["models"], "chunk": e.chunk,
            "slots": e.slots, "page_size": e.page_size}


def _open(run: _Run, stream, seconds, trace, trace_s, clock):
    due, n, k = stream.due, stream.n, 0
    t0 = clock() - float(due[0])
    end = t0 + seconds
    while True:
        now = clock()
        while k < n and t0 + due[k] <= now:
            run.submit(k, t0 + float(due[k]))
            k += 1
        if trace and run.tracer is None and run.trace is None and \
                now >= end - max(trace_s, run.max_wall):
            run.open_tracer()
        if not run.srv.engine.busy:
            if now >= end:
                return t0, now
            nxt = t0 + float(due[k]) if k < n else end
            time.sleep(max(0.0, min(nxt, end) - now))
            continue
        if run.step() >= end:
            return t0, run.steps["t_end"][-1]


def _closed(run: _Run, mix, seconds, trace, trace_s, clock):
    backlog, ramp = int(mix["backlog"]), int(mix["ramp_per_step"])
    warm_steps = int(mix["warm_steps"])
    t0, k, nstep = None, 0, 0
    while True:
        target = min(backlog, ramp * (nstep + 1))
        while run.outstanding < target:
            run.submit(k, math.nan)
            k += 1
        if trace and t0 is not None and run.tracer is None and \
                run.trace is None and \
                clock() >= t0 + seconds - max(trace_s, run.max_wall):
            run.open_tracer()
        t = run.step()
        nstep += 1
        if t0 is None:
            if nstep >= warm_steps:
                t0 = t
        elif t >= t0 + seconds:
            return t0, t
