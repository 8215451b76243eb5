"""Parametric MLP-Router behind the unified interface (PyTorch counterpart
of ``repro/routers/mlp.py``; paper §4.1). The decision hot path
(``route``) runs the trunk in PyTorch and the fused ``router_utility``
kernel on its features: both heads and the λ-utility argmax in one pass,
without materializing A and C."""
from __future__ import annotations

import torch

from repro_torch.core import mlp_router as R
from repro_torch.device import generator, resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.routers.base import Router
from repro_torch.routers.registry import register


@register("mlp")
class MLPRouter(Router):

    def init(self, gen, *, device=None) -> "MLPRouter":
        gen = generator(gen, resolve_device(device))
        return self.with_state(
            R.init_mlp_router(gen, self.rcfg, num_models=self._num_models))

    def predict(self, x):
        self._require_state()
        return R.apply_mlp_router(self.state, x)

    def route(self, x, lam):
        """Trunk features → the fused utility-argmax kernel."""
        self._require_state()
        h = R.trunk_apply(self.state, x)
        hd = self.state["heads"]
        choice, _ = kops.router_utility(h, hd["acc_w"], hd["acc_b"],
                                        hd["cost_w"], hd["cost_b"], lam)
        return choice

    def _state_num_models(self) -> int:
        return int(self.state["heads"]["acc_b"].shape[0])

    @property
    def device(self) -> torch.device:
        self._require_state()
        return self.state["heads"]["acc_w"].device
