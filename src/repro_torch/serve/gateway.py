"""RoutedServer: the paper's router in front of an actual model pool
(PyTorch counterpart of ``repro/serve/gateway.py``).

A request is (i) embedded by the encoder stub, (ii) routed by one
``repro_torch.routers.Router`` — the MLP family decides through the fused
``router_utility`` kernel — and (iii) served by the chosen model through
the continuous-batching engine (``repro_torch.serve.engine``): one paged
KV pool per model, same-bucket admissions coalesced into one prefill, and
every in-flight request decoded together in chunks. ``generate(
engine=False)`` keeps the per-call path: each model's prompts padded into
one (B, S) batch and decoded against a contiguous cache (the
``decode_attention`` kernel on CUDA). SSM and hybrid models always take
the per-call path, their prompts unpadded in S: their state integrates
every position, so they cannot share the engine's padded buckets.

Batch sizes and prompt lengths are bucketed to powers of two, as in the
reference, so the same requests see the same shapes on both paths.

On a speculative engine (``EngineConfig.spec_k > 0``) ``submit`` pairs
each request with a drafter from the pool: the model the router itself
ranks highest under A − λ·C among those strictly cheaper than the target
that share its vocabulary (``_pick_draft``), else the target. Requests may
carry a ``deadline``, may be cancelled and may be shed; ``step`` and
``drain`` return a typed ``Outcome`` for those, and an expiry counts as a
backend failure (``backend_failures``, ``expiry_failures``).

The online loop's hooks: with a ``HarvestStore`` attached (``harvest=``),
a request submitted with ``client_id=`` is registered until its client
calls ``report_outcome``, which appends (x, served model, score, cost) to
that client's buffer; an expiry records a zero score. A ``FaultPlan``
(``fault_plan=``) makes ``submit`` retry failing backends and fail over
down the router's own ranking. ``swap_router_state`` hot-swaps refitted
state of the same structure, and ``add_model`` onboards a pool model with
its expanded router; both bump ``router_version``.

``mesh=`` (a ``DeviceMesh`` with a ``"data"`` and/or ``"heads"``
dimension, from ``sharding``) hands the mesh to the engine: its KV pools
split over the mesh's processes (``serve/engine.py``). Every process runs
the gateway with the same calls — routing, harvest, failover and hot-swap
are host work and run the same in each — and returns the same tokens. The
per-call path (``engine=False``, SSM and hybrid models) stays unsharded,
as in the reference.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import zlib
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.encoder import encode
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as mdl
from repro_torch.routers import Router
from repro_torch.serve.engine import (CANCELLED, EXPIRED, SHED,
                                      EngineConfig, Outcome, ServeEngine,
                                      next_pow2)
from repro_torch.serve.kv_cache import extend_cache

#: un-reported harvest entries kept per server (submit → report_outcome);
#: the oldest are evicted beyond this, so traffic without feedback cannot
#: grow memory.
PENDING_EVAL_CAP = 8192


@dataclasses.dataclass
class PoolModel:
    name: str
    cfg: ModelConfig
    params: dict
    cost_per_token: float


def make_pool_model(name: str, cfg: ModelConfig, cost_per_token: float, *,
                    gen: Union[torch.Generator, int] = 0,
                    device: DeviceLike = None) -> PoolModel:
    """A pool model with random weights drawn from ``gen`` (a generator on
    the target device, or an int seed), on the CUDA device unless
    ``device`` names another."""
    return PoolModel(name, cfg, mdl.init_params(gen, cfg, device=device),
                     cost_per_token)


def _state_spec(tree):
    """(structure, [(shape, dtype) per leaf], {devices}) of a router state
    tree of dicts (keys in sorted order, as a JAX tree), lists and
    tensors."""
    if isinstance(tree, dict):
        parts = [(k, _state_spec(v)) for k, v in sorted(tree.items())]
        return (("dict", tuple((k, p[0]) for k, p in parts)),
                [l for _, p in parts for l in p[1]],
                set().union(*(p[2] for _, p in parts)))
    if isinstance(tree, (list, tuple)):
        parts = [_state_spec(v) for v in tree]
        return (("list", tuple(p[0] for p in parts)),
                [l for p in parts for l in p[1]],
                set().union(*(p[2] for p in parts)))
    return "leaf", [(tuple(tree.shape), tree.dtype)], {tree.device}


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits → (B, 1) int32 greedy tokens (first max on ties)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


class RoutedServer:
    """λ is a per-request knob — no router retraining needed (§3).

    Takes ONE fitted ``Router``; its model dimension M must match the
    pool. Runs on the CUDA device unless ``device`` names another; the
    router's state and every pool model's params must live there.
    ``harvest`` (a ``fed.harvest.HarvestStore``) collects the outcomes
    clients report; ``fault_plan`` (a ``fed.faults.FaultPlan``) injects
    backend failures, retried ``max_retries`` times with exponential
    backoff from ``retry_backoff`` seconds before failing over.
    """

    def __init__(self, pool: List[PoolModel], router: Router,
                 d_emb: Optional[int] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 harvest=None, fault_plan=None, max_retries: int = 2,
                 retry_backoff: float = 0.0, mesh=None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        if not isinstance(router, Router):
            raise TypeError("RoutedServer takes a repro_torch.routers.Router "
                            "— build one with routers.make(...).init(...)")
        if not router.initialized:
            raise ValueError("router has no fitted state — init it before "
                             "serving")
        if router.num_models != len(pool):
            raise ValueError(
                f"router predicts over M={router.num_models} models but the "
                f"pool has {len(pool)}")
        if d_emb is not None and d_emb != router.rcfg.d_emb:
            raise ValueError(
                f"d_emb={d_emb} does not match the router's embedding "
                f"dimension {router.rcfg.d_emb} — drop d_emb= to use the "
                "router's own")
        if router.device != self.device:
            raise ValueError(f"router state lives on {router.device}, the "
                             f"server on {self.device}")
        self.pool = pool
        self.router = router
        self.d_emb = router.rcfg.d_emb
        #: the engine's cross-silo mesh (None: solo); the per-call path
        #: stays unsharded
        self.mesh = mesh
        self.engine = ServeEngine(pool, engine_cfg, mesh=mesh,
                                  device=self.device)
        # the harvest: rid → (client, x, model, cost estimate) until the
        # client reports; bounded tombstones say why a rid is unknown
        self.harvest = harvest
        self._pending_evals: Dict[int, tuple] = {}
        self._evicted_rids = collections.deque(maxlen=4096)
        self._reported_rids = collections.deque(maxlen=4096)
        #: bumped by every swap_router_state / add_model
        self.router_version = 0
        self.fault_plan = fault_plan
        self.max_retries = int(max_retries)
        self.retry_backoff = float(retry_backoff)
        self._submit_seq = 0
        #: failed backend attempts (expiries included), retries of the same
        #: backend, and re-routes to another one
        self.backend_failures = 0
        self.retries = 0
        self.failovers = 0
        #: expiries count as backend failures: the router should learn an
        #: overloaded backend as it learns a failed one
        self.expiry_failures = 0
        self._failed_rids = collections.deque(maxlen=4096)
        self._terminated_rids = collections.deque(maxlen=4096)

    def _route_x(self, x: np.ndarray, lam: float) -> np.ndarray:
        """Route pre-encoded query embeddings x: (B, d_emb) → (B,) model
        indices. The batch is padded to a pow2 bucket, as in the
        reference."""
        B = x.shape[0]
        B_b = next_pow2(B)
        if B_b != B:
            x = np.concatenate([x, np.zeros((B_b - B, x.shape[1]), x.dtype)])
        xt = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        choice = self.router.route(xt, float(lam))
        return choice.cpu().numpy()[:B]

    def route(self, prompts: List[str], lam: float) -> np.ndarray:
        return self._route_x(encode(prompts, self.d_emb), lam)

    # ----------------------------------------------------- router lifecycle
    def swap_router_state(self, state) -> None:
        """Hot-swap fitted router state under live traffic: the same
        family, tree structure, leaf shapes and dtypes, on the server's
        device. Requests in flight keep the models they were routed to.
        Bumps ``router_version``."""
        old_s, old_l, _ = _state_spec(self.router.state)
        new_s, new_l, devs = _state_spec(state)
        if old_s != new_s or old_l != new_l:
            raise ValueError(
                "swap_router_state got a different state structure or "
                "buffer shapes — a structural change (new family, expanded "
                "pool) is an add_model/replacement, not a hot swap")
        if devs != {self.device}:
            raise ValueError(
                f"swap_router_state got state on {sorted(map(str, devs))}, "
                f"the server runs on {self.device}")
        self.router = self.router.with_state(state)
        self.router_version += 1

    def add_model(self, pm: PoolModel, router: Router) -> None:
        """Onboard a pool model mid-run (§6.3): append it to the pool (the
        engine shares the list; its lane is built on first traffic) and
        install the router expanded to it. Bumps ``router_version``."""
        if router.num_models != len(self.pool) + 1:
            raise ValueError(
                f"add_model expects a router expanded to M={len(self.pool) + 1}"
                f" (got M={router.num_models}) — onboard the router first "
                "(router.onboard_model)")
        if router.device != self.device:
            raise ValueError(f"router state lives on {router.device}, the "
                             f"server on {self.device}")
        self.pool.append(pm)
        self.router = router
        self.router_version += 1

    # -------------------------------------------------- engine streaming API
    def submit(self, prompt: str, *, lam: float = 0.5,
               max_new_tokens: int = 16,
               tokenize: Optional[Callable] = None,
               client_id: Optional[int] = None,
               x: Optional[np.ndarray] = None,
               deadline: Optional[int] = None,
               draft_model: Optional[int] = None) -> int:
        """Route one prompt and enqueue it on the continuous-batching
        engine; returns a request id. ``x`` supplies a pre-computed query
        embedding instead of the stub ``encode``. ``deadline`` bounds the
        request's life in engine steps (``ServeEngine.submit``). On a
        speculative engine the request drafts with ``draft_model`` (a pool
        index) or else with ``_pick_draft``'s choice. Call ``step()`` to
        advance decoding or ``drain()`` to run to completion.

        With a ``harvest`` store attached and ``client_id`` given, the
        request is registered: ``routed_model(rid)`` gives the model that
        serves it and ``report_outcome(rid, score)`` records the
        observation in that client's buffer. A submit SHED by a full lane
        queue still returns its rid but is never registered. With a
        ``fault_plan`` the backend is resolved by
        ``_submit_with_failover``, and the harvest records the model that
        actually served the request."""
        x_arr = (encode([prompt], self.d_emb)[0] if x is None
                 else np.asarray(x, np.float32).reshape(self.d_emb))
        m_idx = int(self._route_x(x_arr[None], lam)[0])
        if self.fault_plan is not None:
            m_idx = self._submit_with_failover(m_idx, x_arr, lam)
        toks = self._tokenize([prompt], self.pool[m_idx].cfg, tokenize)[0]
        if self.engine.ecfg.spec_k:
            draft = (int(draft_model) if draft_model is not None
                     else self._pick_draft(m_idx, x_arr, lam))
        elif draft_model is not None:
            raise ValueError("submit(draft_model=...) needs a speculative "
                             "engine — set EngineConfig.spec_k > 0")
        else:
            draft = None
        rid = self.engine.submit(m_idx, toks, max_new_tokens,
                                 deadline=deadline, draft=draft)
        if self.engine._status.get(rid) == SHED:
            self._terminated_rids.append(rid)
            return rid
        if self.harvest is not None and client_id is not None:
            cost_est = self.pool[m_idx].cost_per_token * max_new_tokens
            self._pending_evals[rid] = (int(client_id), x_arr, m_idx,
                                        cost_est)
            while len(self._pending_evals) > PENDING_EVAL_CAP:
                old = next(iter(self._pending_evals))
                self._pending_evals.pop(old)
                self._evicted_rids.append(old)
        return rid

    def _utility(self, x_arr: np.ndarray, lam: float) -> np.ndarray:
        """(M,) the router's A − λ·C on one query (``router.predict``)."""
        xt = torch.as_tensor(x_arr[None], dtype=torch.float32,
                             device=self.device)
        A, C = self.router.predict(xt)
        return (A[0] - lam * C[0]).cpu().numpy()

    def _submit_with_failover(self, m_idx: int, x_arr: np.ndarray,
                              lam: float) -> int:
        """The backend that will serve this submission: transient failures
        are retried up to ``max_retries`` times with exponential backoff,
        then the request walks down the router's utility ranking past the
        failed backends. Raises RuntimeError only when every backend of
        the pool has failed."""
        seq = self._submit_seq
        self._submit_seq += 1
        plan = self.fault_plan
        failed: set = set()
        order = None
        attempt = 0
        while plan.backend_fails(m_idx, seq, attempt):
            self.backend_failures += 1
            if attempt < self.max_retries:
                attempt += 1
                self.retries += 1
                if self.retry_backoff > 0.0:
                    time.sleep(self.retry_backoff * 2.0 ** (attempt - 1))
                continue
            failed.add(m_idx)
            if len(failed) == len(self.pool):
                raise RuntimeError(
                    f"all {len(self.pool)} pool backends failed request "
                    f"#{seq} — nothing left to re-route to")
            if order is None:  # rank once, only on a failover
                order = [int(i) for i in
                         np.argsort(-self._utility(x_arr, lam))]
            m_idx = next(i for i in order if i not in failed)
            self.failovers += 1
            attempt = 0
        return m_idx

    def _pick_draft(self, m_idx: int, x_arr: np.ndarray, lam: float) -> int:
        """The drafter for a request routed to ``m_idx``: among pool models
        that can draft for it — attention archs sharing its vocabulary —
        and cost strictly less per token, the one the router ranks highest
        under A − λ·C on this query; the target itself when none
        qualifies. The router's best cheap model on this query is the
        drafter most likely to agree with the target."""
        tgt = self.pool[m_idx]
        cand = [i for i, pm in enumerate(self.pool)
                if i != m_idx
                and pm.cost_per_token < tgt.cost_per_token
                and pm.cfg.vocab == tgt.cfg.vocab
                and pm.cfg.arch_type not in ("ssm", "hybrid")]
        if not cand:
            return m_idx
        util = self._utility(x_arr, lam)
        return max(cand, key=lambda i: util[i])

    # ------------------------------------------------------------ harvest
    def _unknown_rid(self, rid: int) -> ValueError:
        """The error for a rid with no pending evaluation, saying why."""
        if rid in self._evicted_rids:
            why = (f"it was evicted by the pending-eval cap "
                   f"(PENDING_EVAL_CAP={PENDING_EVAL_CAP}) — report "
                   "outcomes sooner or raise the cap")
        elif rid in self._reported_rids:
            why = "its outcome was already reported (each rid reports once)"
        elif rid in self._failed_rids:
            why = ("it EXPIRED past its deadline — the gateway already "
                   "recorded the expiry as a zero-score backend failure")
        elif rid in self._terminated_rids:
            why = ("it was cancelled or shed before serving — nothing was "
                   "generated, so there is no outcome to report")
        else:
            why = ("it was never harvest-registered — submit() it with "
                   "client_id= and attach a HarvestStore to track routing "
                   "outcomes")
        return ValueError(f"request {rid} has no pending evaluation: {why}")

    def routed_model(self, rid: int) -> int:
        """The model a harvest-registered request was routed to (after any
        failover). Raises ValueError for a rid with no pending
        evaluation."""
        try:
            return self._pending_evals[rid][2]
        except KeyError:
            raise self._unknown_rid(rid) from None

    def report_outcome(self, rid: int, score: float,
                       cost: Optional[float] = None) -> None:
        """Client feedback closes the harvest loop: append (query
        embedding, served model, score, cost) to the submitting client's
        buffer. ``cost`` defaults to the submit-time estimate
        (cost_per_token × max_new_tokens). Raises ValueError for a rid with
        no pending evaluation."""
        try:
            client_id, x_arr, m_idx, cost_est = self._pending_evals.pop(rid)
        except KeyError:
            raise self._unknown_rid(rid) from None
        self._reported_rids.append(rid)
        self.harvest.record(client_id, x_arr, m_idx, float(score),
                            float(cost if cost is not None else cost_est))

    def cancel(self, rid: int) -> str:
        """Cancel an engine request (``ServeEngine.cancel``) and drop its
        harvest registration; returns its typed status."""
        status = self.engine.cancel(rid)
        if self._pending_evals.pop(rid, None) is not None:
            self._terminated_rids.append(rid)
        return status

    def status(self, rid: int) -> str:
        """Typed lifecycle status of an engine request
        (``ServeEngine.status``)."""
        return self.engine.status(rid)

    def _absorb_outcomes(self, results) -> None:
        """React to the engine's typed non-completions. An EXPIRED request
        counts once as a backend failure, and a harvest-registered one is
        recorded as a zero-score outcome against its model, so the router
        learns an overloaded backend as it learns a failed one. CANCELLED
        and SHED drop the registration: nothing was served."""
        for rid, payload in results:
            if not isinstance(payload, Outcome):
                continue
            if payload.status == EXPIRED:
                if rid in self._failed_rids:
                    continue
                self._failed_rids.append(rid)
                self.backend_failures += 1
                self.expiry_failures += 1
                ent = self._pending_evals.pop(rid, None)
                if ent is not None and self.harvest is not None:
                    client_id, x_arr, m_idx, cost_est = ent
                    self.harvest.record(client_id, x_arr, m_idx, 0.0,
                                        cost_est)
            elif payload.status in (CANCELLED, SHED):
                if self._pending_evals.pop(rid, None) is not None:
                    self._terminated_rids.append(rid)

    def step(self):
        """Advance every busy engine lane one chunk. Returns
        [(request id, result)] for the requests that reached a terminal
        state: np tokens for completions, an ``Outcome`` for expired,
        cancelled or shed ones."""
        finished = self.engine.step()
        self._absorb_outcomes(finished)
        return finished

    def drain(self, rids=None) -> Dict[int, object]:
        """Run the engine until idle (or until ``rids`` end); returns
        {request id: np tokens or ``Outcome``}."""
        out = self.engine.drain(rids)
        self._absorb_outcomes(out.items())
        return out

    # ------------------------------------------------------------- generate
    def generate(self, prompts: List[str], *, lam: float = 0.5,
                 max_new_tokens: int = 16,
                 tokenize: Optional[Callable] = None,
                 scan_decode: bool = True, engine: bool = True) -> Dict:
        """Route, then serve every prompt as its own request through the
        continuous-batching engine. Each prompt is prefilled at its own
        pow2 length bucket, so results equal serving it alone.

        engine=False selects the per-call grouped path: each model's
        prompts are padded to one (B, S) batch and decoded together.
        scan_decode=False (with engine=False) further drops the pow2
        bucketing of (B, S, max_new) — same tokens, kept for comparison.
        SSM/hybrid models always take the per-call path.
        """
        choice = self.route(prompts, lam)
        results = [None] * len(prompts)
        cost = 0.0
        rid_to_slot = {}
        for m_idx in np.unique(choice):
            pm = self.pool[int(m_idx)]
            idx = np.where(choice == m_idx)[0]
            if (engine and scan_decode
                    and pm.cfg.arch_type not in ("ssm", "hybrid")):
                for i in idx:
                    toks_i = self._tokenize([prompts[i]], pm.cfg, tokenize)[0]
                    if not self.engine.fits(len(toks_i), max_new_tokens):
                        # request exceeds a slot region — serve it per-call
                        out = self._serve_batch(pm, toks_i[None],
                                                max_new_tokens)
                        results[i] = {"model": pm.name,
                                      "tokens": out[0].tolist()}
                        continue
                    rid = self.engine.submit(int(m_idx), toks_i,
                                             max_new_tokens)
                    rid_to_slot[rid] = (int(i), pm.name)
            else:
                toks = self._tokenize([prompts[i] for i in idx], pm.cfg,
                                      tokenize)
                out = self._serve_batch(pm, toks, max_new_tokens,
                                        scan_decode=scan_decode)
                for j, i in enumerate(idx):
                    results[i] = {"model": pm.name, "tokens": out[j].tolist()}
            cost += pm.cost_per_token * max_new_tokens * len(idx)
        if rid_to_slot:
            for rid, toks in self.engine.drain(rid_to_slot).items():
                i, name = rid_to_slot[rid]
                results[i] = {"model": name, "tokens": toks.tolist()}
        return {"results": results, "total_cost": cost,
                "routing": choice.tolist()}

    @staticmethod
    def _tokenize(prompts, cfg, tokenize):
        if tokenize is not None:
            return tokenize(prompts)
        # stub tokenizer: crc32 is stable across processes (unlike builtin
        # hash, which varies with PYTHONHASHSEED)
        L = max(max(len(p.split()) for p in prompts), 1)
        out = np.zeros((len(prompts), L), np.int32)
        for i, p in enumerate(prompts):
            for j, w in enumerate(p.split()):
                out[i, j] = zlib.crc32(w.encode("utf-8")) % (cfg.vocab - 1) + 1
        return out

    @staticmethod
    def _serve_batch(pm: PoolModel, toks: np.ndarray, max_new: int, *,
                     scan_decode: bool = True) -> np.ndarray:
        """Prefill + greedy decode of one (B, S) prompt batch against a
        contiguous cache. ``scan_decode`` buckets (B, S, max_new) to powers
        of two, decoding to the bucket length and slicing (greedy decode is
        prefix-stable); SSM/hybrid prompts stay unpadded in S, since their
        state integrates every prefill position (shorter prompts of a group
        still integrate its right padding, as in the reference). The tokens
        stay on the device until the end."""
        cfg, params = pm.cfg, pm.params
        dev = mdl.params_device(params)
        B, S = toks.shape
        if scan_decode:
            B_b, T = next_pow2(B), next_pow2(max_new)
            S_b = S if cfg.arch_type in ("ssm", "hybrid") else next_pow2(S)
            toks_p = np.zeros((B_b, S_b), np.int32)
            toks_p[:B, :S] = toks
            last = S - 1
        else:
            B_b, S_b, T = B, S, max_new
            toks_p = toks
            last = None
        logits, _, cache = mdl.forward(
            params, cfg, tokens=torch.as_tensor(toks_p, device=dev),
            logits_last_only=True, last_pos=last, return_cache=True,
            q_chunk=64)
        cache = extend_cache(cache, S_b + T)
        tok = _greedy(logits)
        out = []
        for t in range(T):
            out.append(tok[:, 0])
            logits_t, cache = mdl.decode_step(params, cache, cfg, tokens=tok,
                                              pos=S + t)
            tok = _greedy(logits_t)
        return torch.stack(out, dim=1).cpu().numpy()[:B, :max_new]
