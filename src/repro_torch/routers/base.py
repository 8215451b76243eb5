"""The unified ``Router`` interface (PyTorch counterpart of
``repro/routers/base.py``).

Every family — parametric (MLP, Alg. 1) or nonparametric (K-means,
Alg. 2) — exposes the same small surface:

  * ``init(gen, device=None)``    fresh state (no-op for one-shot families)
  * ``predict(x) -> (A, C)``      per-query accuracy / cost estimates
  * ``route(x, lam) -> m``        argmax_m A − λ·C on the family's hot path
  * ``loss(batch)``               training loss (parametric families only)
  * ``onboard_model(calib, ...)`` §6.3 pool expansion
  * ``onboard_clients(data, ...)``App. D.3 client expansion
  * ``state``                     the fitted tensors; ``save`` / ``load``
                                  round-trip through ``train/checkpoint``
                                  in the reference's file format

Routers are value-style containers: fitting and onboarding return a new
router carrying the updated state.
"""
from __future__ import annotations

import abc
from typing import Any, ClassVar, Optional

import torch

from repro_torch.config import RouterConfig
from repro_torch.device import DeviceLike
from repro_torch.train import checkpoint as ckpt


class Router(abc.ABC):
    """One member of the router family zoo (see ``repro_torch.routers.make``)."""

    #: registry key ("mlp", "kmeans", ...) — set by @register
    name: ClassVar[str] = ""
    #: True for gradient-trained families (iterative FedAvg, Alg. 1);
    #: False for one-shot statistics families (Alg. 2).
    parametric: ClassVar[bool] = True

    def __init__(self, rcfg: RouterConfig, *,
                 num_models: Optional[int] = None, state: Any = None):
        self.rcfg = rcfg
        self._num_models = (num_models if num_models is not None
                            else rcfg.num_models)
        self.state = state

    # ------------------------------------------------------------- interface

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

    def loss(self, batch: dict, *, gen=None) -> torch.Tensor:
        """Per-batch training loss. Only parametric families have one."""
        raise NotImplementedError(
            f"{type(self).__name__} is nonparametric: it has no training "
            "loss — fit it with repro_torch.routers.fit_federated (one-shot).")

    @abc.abstractmethod
    def onboard_model(self, calib: dict, **kw) -> "Router":
        """§6.3: expand the pool with new model(s) from calibration evals."""

    @abc.abstractmethod
    def onboard_clients(self, data_new: dict, **kw) -> "Router":
        """App. D.3: fold newly joined clients into the router."""

    # -------------------------------------------------------- fitting hooks
    # Called by repro_torch.routers.fit_federated / fit_local with a
    # generator and data on the fit's device.

    @abc.abstractmethod
    def _fit_federated(self, gen, data: dict, fcfg, *, rounds=None,
                       eval_fn=None, mesh=None, **kw) -> tuple["Router", dict]:
        """Federated fit → (fitted router, {"loss": [...], "eval": [...]})."""

    @abc.abstractmethod
    def _fit_local(self, gen, data_i: dict, fcfg,
                   **kw) -> tuple["Router", dict]:
        """No-FL baseline fit on one flat dataset → (router, history)."""

    # ------------------------------------------------------------- state mgmt

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
        """M as recorded in the fitted state (pool may have been expanded)."""

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
                f"{type(self).__name__} has no state — call init()/"
                "fit_federated() or load() a checkpoint first.")

    # ---------------------------------------------------------- persistence

    def save(self, path) -> None:
        """Checkpoint the router (family tag + state, msgpack), readable by
        the reference's ``repro.routers.load``."""
        self._require_state()
        ckpt.save(path, {"kind": self.name, "state": self.state})

    @staticmethod
    def load_state(path, device: DeviceLike = None) -> tuple[str, Any]:
        """Low-level restore → (family name, state on ``device``). Prefer
        ``repro_torch.routers.load`` which also rebuilds the Router."""
        blob = ckpt.restore(path, device)
        return blob["kind"], blob["state"]

    def __repr__(self) -> str:
        st = "fitted" if self.initialized else "uninitialized"
        return (f"{type(self).__name__}(name={self.name!r}, M="
                f"{self.num_models}, {st})")
