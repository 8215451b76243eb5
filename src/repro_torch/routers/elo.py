"""Nonparametric similarity-weighted Elo/ranking router behind the unified
interface (PyTorch counterpart of ``repro/routers/elo.py``; one-shot,
Alg. 2).

Fitting is the one-shot federated statistics protocol: federated K-means
anchors, then one round of similarity-weighted evaluation sums whose
server aggregation is plain addition. ``route`` runs the fused
``router_utility`` kernel with the anchor similarities as features:
A = σ(s·R / s_elo) and C = s·C are both linear heads over s, exactly the
kernel's contract (zero biases).

``init(gen)`` returns an uninformative prior state with the structure of
any real fit, so a server can start cold and take the first fit in later.
"""
from __future__ import annotations

import torch

from repro_torch.core import elo_router as EL
from repro_torch.device import generator, on_device, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.routers.base import Router
from repro_torch.routers.registry import register


@register("elo")
class EloRouter(Router):
    parametric = False

    def init(self, gen, *, device=None) -> "EloRouter":
        """Cold-start prior state (``core.elo_router.prior_state``), drawn
        from ``gen`` on the CUDA device unless ``device`` names another."""
        gen = generator(gen, resolve_device(device))
        return self.with_state(
            EL.prior_state(gen, self.rcfg, num_models=self._num_models))

    def predict(self, x):
        self._require_state()
        return EL.predict(self.state, x)

    def route(self, x, lam):
        """Anchor similarities → the fused utility-argmax kernel."""
        self._require_state()
        st = self.state
        s = EL.kernel_weights(x, st["anchors"], st["tau"])
        zeros = torch.zeros((st["rating"].shape[1],), device=s.device)
        choice, _ = kops.router_utility(s, st["rating"] / EL.ELO_SCALE, zeros,
                                        st["C"], zeros, lam)
        return choice

    def _state_num_models(self) -> int:
        return int(self.state["rating"].shape[1])

    @property
    def device(self) -> torch.device:
        self._require_state()
        return self.state["anchors"].device

    # ------------------------------------------------------------ onboarding

    def onboard_model(self, calib, **kw) -> "EloRouter":
        """§6.3, training-free: rate the new model from calibration evals
        {"x","acc","cost","w"} (one new rating column, re-finalized)."""
        self._require_state()
        return self.with_state(EL.add_model_stats(
            self.state, on_device(calib, self.device), self.rcfg))

    def onboard_clients(self, data_new, **kw) -> "EloRouter":
        """App. D.3, training-free: add the new clients' similarity-weighted
        sums against the existing anchors (exact — raw sums are in state)."""
        self._require_state()
        return self.with_state(EL.merge_client_stats(
            self.state, on_device(data_new, self.device), self.rcfg,
            num_models=self.num_models))

    # --------------------------------------------------------------- fitting

    def _fit_federated(self, gen, data, fcfg, *, rounds=None, eval_fn=None,
                       mesh=None, client_mask=None, **kw):
        """Alg. 2: one-shot — no rounds (``rounds`` is ignored), no loss.
        ``mesh`` and parametric-only knobs are rejected, not dropped."""
        if mesh is not None:
            raise ValueError("the elo family is one-shot: there is no "
                             "sharded fitting path — drop mesh=")
        if kw:
            raise ValueError("elo fit_federated got unsupported "
                             f"options: {', '.join(sorted(kw))}")
        state = EL.fed_elo_router(gen, data, self.rcfg,
                                  num_models=self._num_models,
                                  client_mask=client_mask)
        new = self.with_state(state)
        return new, {"loss": [], "eval": [eval_fn(new)] if eval_fn else []}

    def _fit_local(self, gen, data_i, fcfg, *, k=None, **kw):
        """Client-local (no-FL) baseline: own anchors + own ratings. With
        ``k=rcfg.k_global`` on pooled data this is the centralized
        baseline."""
        state = EL.local_elo_router(gen, data_i, self.rcfg,
                                    num_models=self._num_models, k=k)
        return self.with_state(state), {"loss": []}
