"""Federated partition of the evaluation corpus (PyTorch counterpart of
``repro/data/partition.py``; paper §6 + App. B).

  * query heterogeneity — Dirichlet(α) over task labels per client,
    α = 0.6 main / 0.03 extreme;
  * model heterogeneity — a client-specific Dirichlet(0.45) distribution
    over the model pool; each training query logs exactly ONE model drawn
    from it (App. B.2);
  * per-client 0.75/0.25 train/test split; the global test set is the union
    of client test splits (App. C).

The client assignment, shuffles and logged models are drawn with numpy's
``default_rng(fcfg.seed)``, as in the reference, so one corpus gives the
reference's split; the observed (acc, cost) draws come from the torch
generator. Outputs stacked, padded tensors on the corpus's device
(``core/federated.py``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import FedConfig
from repro_torch.data.synthetic import observe


def federated_split(gen: torch.Generator, corpus: dict, fcfg: FedConfig, *,
                    model_subset=None) -> dict:
    """Returns {"train": stacked padded client data, "test": per-client test
    dicts (x, acc_table, cost_table), "test_global": merged test dict}."""
    N = fcfg.num_clients
    Q = corpus["x"].shape[0]
    M = corpus["n_models"]
    T = corpus["n_tasks"]
    dev = corpus["x"].device
    rng = np.random.default_rng(fcfg.seed)

    task = corpus["task"].cpu().numpy()
    # Dirichlet over clients per task
    client_of = np.zeros(Q, dtype=np.int64)
    for t in range(T):
        idx = np.where(task == t)[0]
        p = rng.dirichlet(np.full(N, fcfg.dirichlet_alpha))
        client_of[idx] = rng.choice(N, size=len(idx), p=p)

    # per-client model-logging distribution (App. B.2); model_alpha = inf
    # gives uniform logging (ProxRouter-Data)
    if np.isinf(fcfg.model_alpha):
        logging_p = np.full((N, M), 1.0 / M)
    else:
        logging_p = rng.dirichlet(np.full(M, fcfg.model_alpha), size=N)
    if model_subset is not None:  # withheld-model experiments (§6.3)
        mask = np.zeros(M)
        mask[np.asarray(model_subset)] = 1.0
        logging_p = logging_p * mask[None, :]
        logging_p /= logging_p.sum(axis=1, keepdims=True)

    train_idx, test_idx = [], []
    model_of = np.zeros(Q, dtype=np.int64)
    for i in range(N):
        idx = np.where(client_of == i)[0]
        rng.shuffle(idx)
        n_tr = int(len(idx) * fcfg.train_frac)
        tr, te = idx[:n_tr], idx[n_tr:]
        train_idx.append(tr)
        test_idx.append(te)
        model_of[tr] = rng.choice(M, size=len(tr), p=logging_p[i])

    # observed (acc, cost) for each training sample's single logged model;
    # client i's rows are one contiguous run of the concatenation
    all_tr = torch.as_tensor(np.concatenate(train_idx), device=dev)
    acc_obs, cost_obs = observe(gen, corpus, all_tr,
                                torch.as_tensor(model_of, device=dev)[all_tr])

    D_max = max(1, max(len(t) for t in train_idx))
    d = corpus["x"].shape[1]
    f32 = dict(dtype=torch.float32, device=dev)
    train = {
        "x": torch.zeros((N, D_max, d), **f32),
        "m": torch.zeros((N, D_max), dtype=torch.int32, device=dev),
        "acc": torch.zeros((N, D_max), **f32),
        "cost": torch.zeros((N, D_max), **f32),
        "w": torch.zeros((N, D_max), **f32),
    }
    lo = 0
    for i, tr in enumerate(train_idx):
        n = len(tr)
        rows = all_tr[lo:lo + n]
        train["x"][i, :n] = corpus["x"][rows]
        train["m"][i, :n] = torch.as_tensor(model_of[tr], dtype=torch.int32,
                                            device=dev)
        train["acc"][i, :n] = acc_obs[lo:lo + n]
        train["cost"][i, :n] = cost_obs[lo:lo + n]
        train["w"][i, :n] = 1.0
        lo += n

    def test_dict(idx):
        idx = torch.as_tensor(idx, device=dev)
        return {"x": corpus["x"][idx], "acc_table": corpus["acc_table"][idx],
                "cost_table": corpus["cost_table"][idx]}

    return {
        "train": train,
        "test": [test_dict(te) for te in test_idx],
        "test_global": test_dict(np.concatenate(test_idx)),
        "train_idx": train_idx,
        "logging_p": logging_p,
    }


def flatten_clients(train: dict) -> dict:
    """Stacked (N, D, ...) client data → pooled flat dataset (centralized
    baseline, App. D.1). Padding rows keep w = 0."""
    return {k: v.reshape((-1,) + tuple(v.shape[2:])) for k, v in train.items()}


def client_slice(train: dict, i: int) -> dict:
    return {k: v[i] for k, v in train.items()}
