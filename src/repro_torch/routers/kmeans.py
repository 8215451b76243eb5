"""Nonparametric K-Means-Router behind the unified interface (PyTorch
counterpart of ``repro/routers/kmeans.py``; §4.2, Alg. 2).

Fitting is the one-shot federated statistics protocol — there are no
rounds and no loss. The decision hot path (``route``) is the
``kmeans_assign`` kernel followed by a gather of each cluster's best model
under U_λ: the (K, M) utility table collapses to one best model per
cluster, so routing a query is assign + gather.
"""
from __future__ import annotations

import torch

from repro_torch.core import kmeans_router as KR
from repro_torch.device import on_device, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.routers.base import Router
from repro_torch.routers.registry import register


@register("kmeans")
class KMeansRouter(Router):
    parametric = False

    def init(self, gen, *, device=None) -> "KMeansRouter":
        """One-shot family: there is no pre-fit state. Checks the device and
        returns self, so ``make(...).init(gen)`` is family-agnostic."""
        resolve_device(device)
        return self

    def predict(self, x):
        self._require_state()
        return KR.predict(self.state, x)

    def route(self, x, lam):
        """Nearest global center (the kernel) → the precomputed per-cluster
        best model under U_λ."""
        self._require_state()
        assign = kops.kmeans_assign(x, self.state["centroids"])
        best = torch.argmax(self.state["A"] - lam * self.state["C"], dim=-1)
        return best.to(torch.int32)[assign.long()]

    def _state_num_models(self) -> int:
        return int(self.state["A"].shape[1])

    @property
    def device(self) -> torch.device:
        self._require_state()
        return self.state["centroids"].device

    # ------------------------------------------------------------ onboarding

    def onboard_model(self, calib, **kw) -> "KMeansRouter":
        """§6.3, training-free: estimate the new model's per-cluster stats
        from calibration evals {"x","acc","cost","w"}."""
        self._require_state()
        return self.with_state(KR.add_model_stats(
            self.state, on_device(calib, self.device), c_max=self.rcfg.c_max))

    def onboard_clients(self, data_new, **kw) -> "KMeansRouter":
        """App. D.3, training-free: count-weighted merge of the new
        clients' statistics against the existing centers."""
        self._require_state()
        return self.with_state(KR.merge_client_stats(
            self.state, on_device(data_new, self.device), self.rcfg,
            num_models=self.num_models))

    # --------------------------------------------------------------- fitting

    def _fit_federated(self, gen, data, fcfg, *, rounds=None, eval_fn=None,
                       mesh=None, client_mask=None, **kw):
        """Alg. 2: one-shot — local K-means upload, server K-means over
        centroids, one statistics round. ``rounds`` does not apply (and is
        ignored); parametric-only knobs are rejected. ``mesh=`` (a
        ``sharding.client_mesh``) runs the local stage on each process's
        block of clients, equal to the in-process fit (no client_mask on
        that path)."""
        if kw:
            raise ValueError("kmeans fit_federated got unsupported "
                             f"options: {', '.join(sorted(kw))}")
        if mesh is not None:
            if client_mask is not None:
                raise ValueError("the kmeans mesh path supports only the "
                                 "plain protocol — drop client_mask= or "
                                 "mesh=")
            state = KR.fed_kmeans_router_sharded(
                gen, data, self.rcfg, num_models=self._num_models,
                mesh=mesh)
        else:
            state = KR.fed_kmeans_router(gen, data, self.rcfg,
                                         num_models=self._num_models,
                                         client_mask=client_mask)
        new = self.with_state(state)
        return new, {"loss": [], "eval": [eval_fn(new)] if eval_fn else []}

    def _fit_local(self, gen, data_i, fcfg, *, k=None, **kw):
        """Client-local (no-FL) baseline: own K-means + own statistics.
        With ``k=rcfg.k_global`` on pooled data this is the centralized
        baseline."""
        state = KR.local_kmeans_router(gen, data_i, self.rcfg,
                                       num_models=self._num_models, k=k)
        return self.with_state(state), {"loss": []}
