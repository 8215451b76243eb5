"""Harvest layer: bounded per-client evaluation logs fed by live serving
(PyTorch counterpart of ``repro/fed/harvest.py``).

Every routed request appends (query embedding, chosen model id, outcome
score, cost) to the submitting client's ``EvalBuffer`` — the sparse,
non-uniform-coverage evaluation matrices the paper assumes (clients only
observe the models they were routed to). The ``HarvestStore`` groups
buffers by client and gives the stacked, padded federated view that
``core/federated.py`` trains on, as tensors on the store's device.

The rings are numpy arrays on the host of fixed capacity: sustained
traffic overwrites the oldest entries and host memory stays constant.
``state()`` is numpy and ints only, the reference's layout, so either
package loads the other's snapshot.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


class EvalBuffer:
    """One client's bounded local (x, m, acc, cost) log, oldest-evicting."""

    def __init__(self, d_emb: int, capacity: int = 1024):
        if capacity < 1:
            raise ValueError("EvalBuffer capacity must be >= 1")
        self.d_emb = int(d_emb)
        self.capacity = int(capacity)
        self._x = np.zeros((self.capacity, self.d_emb), np.float32)
        self._m = np.zeros((self.capacity,), np.int32)
        self._acc = np.zeros((self.capacity,), np.float32)
        self._cost = np.zeros((self.capacity,), np.float32)
        self._total = 0  # lifetime appends; write head is _total % capacity

    def append(self, x, m: int, acc: float, cost: float) -> None:
        i = self._total % self.capacity
        self._x[i] = np.asarray(x, np.float32).reshape(self.d_emb)
        self._m[i] = int(m)
        self._acc[i] = float(acc)
        self._cost[i] = float(cost)
        self._total += 1

    def __len__(self) -> int:
        return min(self._total, self.capacity)

    @property
    def total_seen(self) -> int:
        """Lifetime appends (>= len once the ring has wrapped)."""
        return self._total

    @property
    def nbytes(self) -> int:
        """Host bytes held — constant for the buffer's lifetime."""
        return (self._x.nbytes + self._m.nbytes + self._acc.nbytes
                + self._cost.nbytes)

    def _order(self) -> np.ndarray:
        """Row indices in chronological (oldest → newest) order."""
        n = len(self)
        if self._total <= self.capacity:
            return np.arange(n)
        return (np.arange(n) + self._total) % self.capacity

    def as_client_data(self, pad_to: int | None = None) -> Dict[str, np.ndarray]:
        """Flat ``{"x","m","acc","cost","w"}`` numpy arrays in
        chronological order, zero-padded to ``pad_to`` rows (w marks real
        rows): one client row of the federated stack, or ``fit_local``'s
        input."""
        n = len(self)
        D = int(pad_to) if pad_to is not None else max(n, 1)
        if n > D:
            raise ValueError(f"buffer holds {n} rows > pad_to={D}")
        order = self._order()
        out = {"x": np.zeros((D, self.d_emb), np.float32),
               "m": np.zeros((D,), np.int32),
               "acc": np.zeros((D,), np.float32),
               "cost": np.zeros((D,), np.float32),
               "w": np.zeros((D,), np.float32)}
        out["x"][:n] = self._x[order]
        out["m"][:n] = self._m[order]
        out["acc"][:n] = self._acc[order]
        out["cost"][:n] = self._cost[order]
        out["w"][:n] = 1.0
        return out

    # ------------------------------------------------------- checkpointing
    def state(self) -> Dict[str, np.ndarray]:
        """Raw ring contents + lifetime counter — restoring reproduces the
        buffer exactly (write head, wrap state, chronological order)."""
        return {"x": self._x.copy(), "m": self._m.copy(),
                "acc": self._acc.copy(), "cost": self._cost.copy(),
                "total": self._total}

    def load_state(self, state: Dict) -> None:
        x = np.asarray(state["x"], np.float32)
        if x.shape != (self.capacity, self.d_emb):
            raise ValueError(
                f"EvalBuffer state has ring shape {x.shape}, this buffer "
                f"is ({self.capacity}, {self.d_emb}) — construct the "
                "store with the checkpoint's d_emb/capacity")
        self._x = x.copy()
        self._m = np.asarray(state["m"], np.int32).copy()
        self._acc = np.asarray(state["acc"], np.float32).copy()
        self._cost = np.asarray(state["cost"], np.float32).copy()
        self._total = int(state["total"])


class HarvestStore:
    """client id → ``EvalBuffer``, plus the stacked federated view on the
    CUDA device unless ``device`` names another.

    Pre-registering the expected clients (``clients=range(N)``) keeps the
    federated stack's client dimension stable from the first sync.
    ``max_clients`` bounds the number of live buffers: past it, the
    least-recently-written client's buffer is evicted (``evicted_clients``
    counts them), so harvest memory is O(max_clients). Pair it with
    ``as_federated_data(client_ids=...)`` to fit on a cohort of the warm
    clients."""

    def __init__(self, d_emb: int, capacity: int = 1024,
                 clients: Iterable[int] = (),
                 max_clients: int | None = None,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.d_emb = int(d_emb)
        self.capacity = int(capacity)
        self.max_clients = None if max_clients is None else int(max_clients)
        if self.max_clients is not None and self.max_clients < 1:
            raise ValueError("max_clients must be >= 1")
        self.evicted_clients = 0  #: lifetime LRU evictions
        # insertion order doubles as the LRU order: record() re-inserts
        self._buffers: Dict[int, EvalBuffer] = {}
        for c in clients:
            self.buffer(c)

    def buffer(self, client_id: int) -> EvalBuffer:
        b = self._buffers.get(int(client_id))
        if b is None:
            b = self._buffers[int(client_id)] = EvalBuffer(self.d_emb,
                                                           self.capacity)
            self._evict_cold()
        return b

    def _evict_cold(self) -> None:
        while (self.max_clients is not None
               and len(self._buffers) > self.max_clients):
            coldest = next(iter(self._buffers))
            del self._buffers[coldest]
            self.evicted_clients += 1

    def record(self, client_id: int, x, m: int, acc: float,
               cost: float) -> None:
        cid = int(client_id)
        b = self.buffer(cid)
        b.append(x, m, acc, cost)
        # move-to-end: this client is now the warmest in the LRU order
        del self._buffers[cid]
        self._buffers[cid] = b

    def client_ids(self) -> list[int]:
        return sorted(self._buffers)

    def __len__(self) -> int:
        """Samples currently held across every client buffer."""
        return sum(len(b) for b in self._buffers.values())

    @property
    def nbytes(self) -> int:
        return sum(b.nbytes for b in self._buffers.values())

    def as_federated_data(self, pad_to: int | None = None,
                          client_ids: Iterable[int] | None = None,
                          ) -> Dict[str, torch.Tensor]:
        """Stacked, padded ``(N, D, ...)`` tensors on the store's device
        over sorted client ids — ``core/federated.py``'s client dataset
        layout, in (client id, chronological) order. ``pad_to=None`` pads
        to the fullest buffer; ``pad_to=capacity`` keeps D fixed across
        syncs.

        Zero-sample clients: without ``pad_to`` they are skipped (they
        contribute no rows); with ``pad_to`` they stay as all-zero rows with
        ``w = 0``, keeping the client dimension, and ``dataset_sizes`` gives
        them zero aggregation weight. ``client_ids`` restricts the stack to
        a subset (a cohort of the warm clients)."""
        ids = (self.client_ids() if client_ids is None
               else sorted(int(c) for c in client_ids))
        if not ids:
            raise ValueError("no harvested clients — nothing to federate")
        missing = [c for c in ids if c not in self._buffers]
        if missing:
            raise ValueError(
                f"client_ids {missing} have no live buffer (never seen, or "
                "evicted by max_clients) — sample the cohort from "
                "client_ids()")
        if pad_to is None:
            ids = [c for c in ids if len(self._buffers[c]) > 0]
        if not ids or all(len(self._buffers[c]) == 0 for c in ids):
            raise ValueError("no harvested samples — every requested "
                             "client's buffer is empty; serve some traffic "
                             "first")
        D = (int(pad_to) if pad_to is not None
             else max(max(len(self._buffers[c]) for c in ids), 1))
        rows = [self._buffers[c].as_client_data(D) for c in ids]
        return {k: torch.from_numpy(np.stack([r[k] for r in rows])).to(
            self.device) for k in rows[0]}

    # ------------------------------------------------------- checkpointing
    def state(self) -> dict:
        """Serializable snapshot: every ring verbatim, in LRU order."""
        return {"d_emb": self.d_emb, "capacity": self.capacity,
                "clients": [[int(c), b.state()]
                            for c, b in self._buffers.items()]}

    def load_state(self, state: dict) -> None:
        """Restore a ``state()`` snapshot of either package exactly (rings,
        lifetime counters, LRU order). The store must be constructed with
        the same d_emb/capacity."""
        if (int(state["d_emb"]) != self.d_emb
                or int(state["capacity"]) != self.capacity):
            raise ValueError(
                f"checkpoint is d_emb={int(state['d_emb'])}, capacity="
                f"{int(state['capacity'])}; this store is d_emb="
                f"{self.d_emb}, capacity={self.capacity}")
        self._buffers = {}
        for c, bstate in state["clients"]:
            b = EvalBuffer(self.d_emb, self.capacity)
            b.load_state(bstate)
            self._buffers[int(c)] = b
        self._evict_cold()
