"""Pool evolution for the gradient-trained families (PyTorch counterpart
of ``repro/core/expansion.py``; paper §6.3 + App. D.3).

  * model onboarding — append fresh head/factor columns and train ONLY
    those columns (everything else frozen) on a small calibration subset;
  * client onboarding — continued FedAvg restricted to the new clients with
    a distillation regularizer toward the frozen pre-join router.

The one-shot families' equivalents are training-free and live beside
their math (``kmeans_router.py`` / ``elo_router.py``: ``add_model_stats``
/ ``merge_client_stats``).
"""
from __future__ import annotations

import torch

from repro_torch.config import FedConfig, RouterConfig
from repro_torch.core import federated as F
from repro_torch.core import mf_router as MF
from repro_torch.core import mlp_router as R
from repro_torch.train.optim import tree_map


def add_models(params: dict, gen: torch.Generator, n_new: int,
               add_fn=None) -> dict:
    add_fn = add_fn if add_fn is not None else R.add_model_head
    for _ in range(n_new):
        params = add_fn(params, gen)
    return params


def new_head_freeze_mask(params: dict, n_new: int) -> dict:
    """Gradient mask: 1 only on the last n_new head columns. Works for any
    family whose params carry the {"heads": {acc_w, acc_b, cost_w, cost_b}}
    layout (MLP trunk features or MF latent factors alike)."""
    mask = tree_map(lambda a: torch.zeros_like(a, dtype=torch.float32),
                    params)
    hd = params["heads"]
    M = hd["acc_b"].shape[0]
    col = (torch.arange(M, device=hd["acc_b"].device)
           >= M - n_new).float()
    mask["heads"] = {"acc_w": col.expand(hd["acc_w"].shape),
                     "acc_b": col,
                     "cost_w": col.expand(hd["cost_w"].shape),
                     "cost_b": col}
    return mask


def _frozen_copy(params: dict) -> dict:
    return tree_map(lambda a: a.detach().clone(), params)


def onboard_models_mlp(gen, params, calib_data, rcfg: RouterConfig,
                       fcfg: FedConfig, n_new: int, *, steps: int = 300):
    """§6.3: train only the new columns on the calibration subset.
    calib_data: flat {"x","m","acc","cost","w"} with m indexing the
    EXPANDED pool (new models have indices ≥ M_old)."""
    params = add_models(params, gen, n_new)
    freeze = new_head_freeze_mask(params, n_new)
    return F.sgd_train(gen, calib_data, rcfg, fcfg, steps=steps, init=params,
                       freeze=freeze)


def onboard_clients_mlp(gen, params, data_new, rcfg: RouterConfig,
                        fcfg: FedConfig, *, rounds: int = 15,
                        beta: float = 1.0):
    """App. D.3: continued training using only newly joined clients, with
    a distillation penalty toward the frozen pre-join parameters."""
    return F.fedavg(gen, data_new, rcfg, fcfg, rounds=rounds, init=params,
                    distill=(_frozen_copy(params), beta))


def onboard_models_mf(gen, params, calib_data, rcfg: RouterConfig,
                      fcfg: FedConfig, n_new: int, *, steps: int = 300):
    """§6.3 for the MF family: append fresh factor columns, train only
    those columns on the calibration subset (projection + old factors
    frozen)."""
    params = add_models(params, gen, n_new, add_fn=MF.add_model_factor)
    freeze = new_head_freeze_mask(params, n_new)
    return F.sgd_train(gen, calib_data, rcfg, fcfg, steps=steps, init=params,
                       freeze=freeze, loss_fn=MF.mf_loss)


def onboard_clients_mf(gen, params, data_new, rcfg: RouterConfig,
                       fcfg: FedConfig, *, rounds: int = 15,
                       beta: float = 1.0):
    """App. D.3 for the MF family: continued FedAvg on the new clients,
    anchored by distillation toward the frozen pre-join factorization."""
    return F.fedavg(gen, data_new, rcfg, fcfg, rounds=rounds, init=params,
                    distill=(_frozen_copy(params), beta, MF.apply_mf_router),
                    loss_fn=MF.mf_loss)
