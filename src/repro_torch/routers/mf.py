"""Parametric matrix-factorization router behind the unified interface
(PyTorch counterpart of ``repro/routers/mf.py``).

Query embeddings project into a rank-r latent space where each model
carries a learned factor per head — the direct factorization of the sparse
(query × model) evaluation matrix of the paper's non-uniform-coverage
setting. Federated fitting is the MLP family's FedAvg with the MF loss
(``core.federated`` through ``loss_fn``). ``route`` runs the fused
``router_utility`` kernel on the latent factors: the params carry the same
``heads`` layout, so one kernel serves both parametric families.
"""
from __future__ import annotations

import torch

from repro_torch.core import expansion as E
from repro_torch.core import federated as F
from repro_torch.core import mf_router as MF
from repro_torch.device import generator, on_device, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.routers.base import Router
from repro_torch.routers.registry import register
from repro_torch.train.optim import tree_map


@register("mf")
class MFRouter(Router):
    parametric = True

    def init(self, gen, *, device=None) -> "MFRouter":
        gen = generator(gen, resolve_device(device))
        return self.with_state(
            MF.init_mf_router(gen, self.rcfg, num_models=self._num_models))

    def predict(self, x):
        self._require_state()
        return MF.apply_mf_router(self.state, x)

    def route(self, x, lam):
        """Latent factors → the fused utility-argmax kernel."""
        self._require_state()
        z = MF.factor_apply(self.state, x)
        hd = self.state["heads"]
        choice, _ = kops.router_utility(z, hd["acc_w"], hd["acc_b"],
                                        hd["cost_w"], hd["cost_b"], lam)
        return choice

    def loss(self, batch, *, gen=None):
        self._require_state()
        return MF.mf_loss(self.state, batch, self.rcfg, gen=gen)

    def _state_num_models(self) -> int:
        return int(self.state["heads"]["acc_b"].shape[0])

    @property
    def device(self) -> torch.device:
        self._require_state()
        return self.state["heads"]["acc_w"].device

    # ------------------------------------------------------------ onboarding

    def onboard_model(self, calib, *, gen=None, fcfg=None, n_new: int = 1,
                      steps: int = 300) -> "MFRouter":
        """§6.3: append fresh factor columns and train ONLY those columns on
        the calibration evals (projection and existing factors frozen).
        ``gen``: a generator on the router's device, or an int seed."""
        self._require_state()
        if gen is None or fcfg is None:
            raise ValueError("MF model onboarding trains the new factors: "
                             "pass gen= and fcfg=")
        calib = on_device(calib, self.device)
        params, _ = E.onboard_models_mf(generator(gen, self.device),
                                        self.state, calib, self.rcfg, fcfg,
                                        n_new, steps=steps)
        return self.with_state(params)

    def onboard_clients(self, data_new, *, gen=None, fcfg=None,
                        rounds: int = 15, beta: float = 1.0) -> "MFRouter":
        """App. D.3: continued FedAvg on the new clients only, anchored by a
        distillation penalty toward the frozen pre-join factorization."""
        self._require_state()
        if gen is None or fcfg is None:
            raise ValueError("MF client onboarding continues FedAvg: pass "
                             "gen= and fcfg=")
        params, _ = E.onboard_clients_mf(generator(gen, self.device),
                                         self.state,
                                         on_device(data_new, self.device),
                                         self.rcfg, fcfg, rounds=rounds,
                                         beta=beta)
        return self.with_state(params)

    # --------------------------------------------------------------- fitting

    def _init_for_fit(self, gen):
        """The existing state (on the fit's device), or a fresh router with
        this router's M drawn from ``gen``."""
        if self.state is not None:
            return tree_map(lambda t: t.to(gen.device), self.state)
        return MF.init_mf_router(gen, self.rcfg, num_models=self._num_models)

    def _fit_federated(self, gen, data, fcfg, *, rounds=None, eval_fn=None,
                       mesh=None, **kw):
        """Alg. 1 with the MF loss; ``kw`` forwards optimizer / full_batch /
        freeze / distill / client_mask / dp_sigma / aggregator /
        eval_every to ``fedavg`` as the MLP family does."""
        init = self._init_for_fit(gen)
        wrapped = (None if eval_fn is None
                   else lambda p: eval_fn(self.with_state(p)))
        params, hist = F.fedavg(gen, data, self.rcfg, fcfg, rounds=rounds,
                                init=init, mesh=mesh, eval_fn=wrapped,
                                loss_fn=MF.mf_loss, **kw)
        return self.with_state(params), hist

    def _fit_local(self, gen, data_i, fcfg, *, steps: int = 400,
                   optimizer: str = "adamw", **kw):
        """Client-local / centralized ERM baseline (flat dataset)."""
        params, losses = F.sgd_train(gen, data_i, self.rcfg, fcfg,
                                     steps=steps, optimizer=optimizer,
                                     init=self._init_for_fit(gen),
                                     loss_fn=MF.mf_loss, **kw)
        return self.with_state(params), {"loss": losses.tolist()}
