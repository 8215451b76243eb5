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

Not ported yet, each raising ``NotImplementedError``: the harvest store
(``client_id``, ``report_outcome``, ``routed_model``), fault plans
(retries and failover), the cross-silo mesh, router hot-swap and model
onboarding.
"""
from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.data.encoder import encode
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import model as mdl
from repro_torch.routers import Router
from repro_torch.serve.engine import (EXPIRED, EngineConfig, Outcome,
                                      ServeEngine, next_pow2)
from repro_torch.serve.kv_cache import extend_cache


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


def _greedy(logits: torch.Tensor) -> torch.Tensor:
    """(B, 1, V) logits → (B, 1) int32 greedy tokens (first max on ties)."""
    return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)


class RoutedServer:
    """λ is a per-request knob — no router retraining needed (§3).

    Takes ONE fitted ``Router``; its model dimension M must match the
    pool. Runs on the CUDA device unless ``device`` names another; the
    router's state and every pool model's params must live there.
    """

    def __init__(self, pool: List[PoolModel], router: Router,
                 d_emb: Optional[int] = None,
                 engine_cfg: Optional[EngineConfig] = None,
                 harvest=None, fault_plan=None, mesh=None,
                 device: DeviceLike = None):
        for what, val in (("harvest", harvest), ("fault_plan", fault_plan),
                          ("mesh", mesh)):
            if val is not None:
                raise NotImplementedError(
                    f"RoutedServer({what}=...) is not ported to the PyTorch "
                    "gateway yet")
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
        self.engine = ServeEngine(pool, engine_cfg, device=self.device)
        #: expiries count as backend failures: the router should learn an
        #: overloaded backend as it learns a failed one
        self.backend_failures = 0
        self.expiry_failures = 0
        self._failed_rids = collections.deque(maxlen=4096)

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

    # -------------------------------------------------- engine streaming API
    def submit(self, prompt: str, *, lam: float = 0.5,
               max_new_tokens: int = 16,
               tokenize: Optional[Callable] = None,
               x: Optional[np.ndarray] = None,
               deadline: Optional[int] = None,
               draft_model: Optional[int] = None) -> int:
        """Route one prompt and enqueue it on the continuous-batching
        engine; returns a request id. ``x`` supplies a pre-computed query
        embedding instead of the stub ``encode``. ``deadline`` bounds the
        request's life in engine steps (``ServeEngine.submit``). On a
        speculative engine the request drafts with ``draft_model`` (a pool
        index) or else with ``_pick_draft``'s choice. Call ``step()`` to
        advance decoding or ``drain()`` to run to completion."""
        x_arr = (encode([prompt], self.d_emb)[0] if x is None
                 else np.asarray(x, np.float32).reshape(self.d_emb))
        m_idx = int(self._route_x(x_arr[None], lam)[0])
        toks = self._tokenize([prompt], self.pool[m_idx].cfg, tokenize)[0]
        if self.engine.ecfg.spec_k:
            draft = (int(draft_model) if draft_model is not None
                     else self._pick_draft(m_idx, x_arr, lam))
        elif draft_model is not None:
            raise ValueError("submit(draft_model=...) needs a speculative "
                             "engine — set EngineConfig.spec_k > 0")
        else:
            draft = None
        return self.engine.submit(m_idx, toks, max_new_tokens,
                                  deadline=deadline, draft=draft)

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
        xt = torch.as_tensor(x_arr[None], dtype=torch.float32,
                             device=self.device)
        A, C = self.router.predict(xt)
        util = (A[0] - lam * C[0]).cpu().numpy()
        return max(cand, key=lambda i: util[i])

    def cancel(self, rid: int) -> str:
        """Cancel an engine request (``ServeEngine.cancel``); returns its
        typed status."""
        return self.engine.cancel(rid)

    def status(self, rid: int) -> str:
        """Typed lifecycle status of an engine request
        (``ServeEngine.status``)."""
        return self.engine.status(rid)

    def _absorb_outcomes(self, results) -> None:
        """Count each EXPIRED request once as a backend failure. (The
        reference also records a zero-score outcome in the harvest store,
        which the port does not have yet.)"""
        for rid, payload in results:
            if (isinstance(payload, Outcome) and payload.status == EXPIRED
                    and rid not in self._failed_rids):
                self._failed_rids.append(rid)
                self.backend_failures += 1
                self.expiry_failures += 1

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
