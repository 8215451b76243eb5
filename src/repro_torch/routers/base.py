"""The unified ``Router`` interface (PyTorch counterpart of
``repro/routers/base.py``).

Every family exposes the same small surface:

  * ``init(gen, device=None)``   fresh state
  * ``predict(x) -> (A, C)``     per-query accuracy / cost estimates
  * ``route(x, lam) -> m``       argmax_m A − λ·C on the family's hot path
  * ``state``                    the fitted tensors

Routers are value-style containers: ``with_state`` returns a new router
carrying other state. Saving, loading, fitting and onboarding are not
ported yet.
"""
from __future__ import annotations

import abc
from typing import Any, ClassVar, Optional

import torch

from repro_torch.config import RouterConfig


class Router(abc.ABC):
    """One member of the router family zoo (see ``repro_torch.routers.make``)."""

    #: registry key ("mlp", ...) — set by @register
    name: ClassVar[str] = ""

    def __init__(self, rcfg: RouterConfig, *,
                 num_models: Optional[int] = None, state: Any = None):
        self.rcfg = rcfg
        self._num_models = (num_models if num_models is not None
                            else rcfg.num_models)
        self.state = state

    @abc.abstractmethod
    def init(self, gen, *, device=None) -> "Router":
        """Return a router with freshly initialized state drawn from
        ``gen`` (a ``torch.Generator`` or an int seed), on the CUDA device
        unless ``device`` names another."""

    @abc.abstractmethod
    def predict(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """x: (Q, d_emb) → (A (Q, M) in [0,1], C (Q, M))."""

    def route(self, x: torch.Tensor, lam: float) -> torch.Tensor:
        """argmax_m A − λ·C → chosen model indices (Q,)."""
        A, C = self.predict(x)
        return torch.argmax(A - lam * C, dim=-1)

    @property
    def initialized(self) -> bool:
        return self.state is not None

    @property
    def num_models(self) -> int:
        """M — the model-pool dimension of the predict/route outputs."""
        if self.state is not None:
            return self._state_num_models()
        return self._num_models

    @abc.abstractmethod
    def _state_num_models(self) -> int:
        """M as recorded in the fitted state."""

    @property
    @abc.abstractmethod
    def device(self) -> torch.device:
        """Where the fitted state lives."""

    def with_state(self, state: Any) -> "Router":
        """Value-style update: same config, new state."""
        return type(self)(self.rcfg, num_models=self._num_models,
                          state=state)

    def _require_state(self):
        if self.state is None:
            raise ValueError(
                f"{type(self).__name__} has no state — call init() first.")

    def __repr__(self) -> str:
        st = "fitted" if self.initialized else "uninitialized"
        return (f"{type(self).__name__}(name={self.name!r}, M="
                f"{self.num_models}, {st})")
