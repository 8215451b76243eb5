"""Loop layer: the FedLoop scheduler — serve → harvest → federate → swap
(PyTorch counterpart of ``repro/fed/loop.py``).

A ``FedLoop`` wraps a ``RoutedServer`` (with a ``HarvestStore`` attached)
and interleaves federated refits over the harvested client buffers with the
engine's decode chunks:

  * ``step()`` advances every busy engine lane one chunk (exactly
    ``RoutedServer.step``) and, at ``sync_every``-chunk boundaries with
    enough harvested samples, runs a federated sync.
  * ``sync()`` is literally ``routers.fit_federated`` over
    ``harvest.as_federated_data()`` starting from the live router's state —
    so an offline fit over the same buffers with the same generator
    reproduces an online sync bit for bit (test-enforced) — followed by
    ``server.swap_router_state``: requests in flight keep their models, the
    engine's KV pools stay the same storage and no kernel is rebuilt.
  * ``onboard_model()`` admits a new ``PoolModel`` mid-run (§6.3): new head
    columns trained on calibration evals, pool extended, expanded router
    installed.

The loop owns one random stream, a CPU ``torch.Generator``: each sync draws
one 63-bit seed from it and fits with a fresh generator on the server's
device seeded with it — the reference splits its PRNG key once per sync.
The stream therefore advances by one draw per sync whatever the fit
consumes. Padding harvested data to the buffer capacity
(``pad_to_capacity``, the default) keeps the federated stack's shapes the
same across syncs.

``FedLoopConfig.mesh`` (a ``sharding.client_mesh()``) runs each sync's
fit on the clients mesh, one process per device: the harvested stack is
padded to the "clients" axis (``pad_client_axis``: empty clients, zero
weight), placed with ``shard_clients`` and fitted with
``fit_federated(mesh=)`` — the in-process fit of the same padded stack.
Every process runs the loop with the same calls. PyTorch has no buffer
donation: the reference donates the freshly built slab into the compiled
fit; here the slab is dropped after the fit. On a mesh ``save`` writes
from the mesh's first process behind a barrier, and ``restore`` reads in
every process; a checkpoint restores on a mesh of any size, or on none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import routers
from repro_torch import sharding as shd
from repro_torch.config import FedConfig
from repro_torch.core import federated as F
from repro_torch.device import on_device
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optim import tree_map

#: FedLoop.save() payload format version (bumped on layout changes).
CHECKPOINT_FORMAT = 1

#: one sync's fit seed is drawn from [0, 2**63 - 1)
_SEED_HI = 2 ** 63 - 1


@dataclasses.dataclass(frozen=True)
class FedLoopConfig:
    sync_every: int = 16      #: engine chunks between federated syncs
    rounds_per_sync: int = 4  #: FedAvg rounds per sync (ignored by one-shot
    #: families, which refit from scratch each sync)
    min_samples: int = 16     #: total harvested samples required to sync
    pad_to_capacity: bool = True  #: pad the federated stack to the buffer
    #: capacity — the same shapes for every sync
    cohort: Optional[int] = None  #: per-round client sampling inside each
    #: sync's fit (parametric families; see core/federated.fedavg)
    mesh: Any = None  #: cross-silo clients mesh for the sync fits
    #: (``sharding.client_mesh()``; see the module doc)


def _stream(gen: Union[int, torch.Generator]) -> torch.Generator:
    """The loop's own stream: a CPU generator, or one seeded with ``gen``."""
    if isinstance(gen, int):
        return torch.Generator().manual_seed(gen)
    if gen.device.type != "cpu":
        raise ValueError(f"the loop's stream is a CPU generator; got one on "
                         f"{gen.device} (each sync seeds a generator on the "
                         "server's device from it)")
    return gen


class FedLoop:
    """Online federation runtime over one ``RoutedServer``.

    ``gen`` (an int seed or a CPU ``torch.Generator``) is the stream of the
    online refits, so a loop run is exactly reproducible from its seed;
    ``history`` records one entry per sync (router version, per-round
    losses, harvested sample count, engine counters).
    """

    def __init__(self, server, fcfg: FedConfig, *, gen,
                 aggregator=None, cfg: Optional[FedLoopConfig] = None):
        if server.harvest is None:
            raise ValueError("FedLoop needs a RoutedServer with a "
                             "HarvestStore attached (harvest=...)")
        cfg = cfg or FedLoopConfig()
        if cfg.mesh is not None:
            shd.clients_rank(cfg.mesh)   # a clients mesh, or TypeError
        self.server = server
        self.fcfg = fcfg
        self.aggregator = aggregator
        self.cfg = cfg
        self._gen = _stream(gen)
        self._chunks = 0
        self.history: List[Dict[str, Any]] = []
        # Staleness bookkeeping for buffered-async aggregators: per client,
        # the lifetime sample count at the previous sync and the sync index
        # at which it last contributed fresh data.
        self._syncs = 0
        self._seen_at_sync: Dict[int, int] = {}
        self._fresh_at_sync: Dict[int, int] = {}

    @property
    def version(self) -> int:
        """The served router version (bumped by syncs and onboarding)."""
        return self.server.router_version

    # ------------------------------------------------------------- serving
    def step(self) -> List[Tuple[int, Any]]:
        """One engine chunk on every busy lane; a federated sync fires at
        ``sync_every`` boundaries once ``min_samples`` are harvested.
        Returns the requests finished this chunk, like ``server.step``."""
        finished = self.server.step()
        self._chunks += 1
        if self._chunks % self.cfg.sync_every == 0:
            self.maybe_sync()
        return finished

    def drain(self) -> Dict[int, Any]:
        """Step (with sync boundaries) until every lane is idle."""
        out: Dict[int, Any] = {}
        while self.server.engine.busy:
            out.update(self.step())
        return out

    # ---------------------------------------------------------- federation
    def maybe_sync(self):
        """Sync iff enough evaluations are harvested; None otherwise."""
        if len(self.server.harvest) < self.cfg.min_samples:
            return None
        return self.sync()

    def sync(self, *, gen=None) -> dict:
        """One federated refit over the harvested buffers + hot-swap.

        Exactly ``routers.fit_federated(server.router, harvested, fcfg,
        gen=...)`` from the live router's state — deterministically
        harvested buffers therefore reproduce an offline fit bit for bit
        (test-enforced). ``gen`` (a generator on the server's device or an
        int seed) replaces the one drawn from the loop's stream. Returns
        the fit history."""
        srv = self.server
        harvest = srv.harvest
        if len(harvest) == 0:
            raise ValueError("sync() with empty harvest buffers would "
                             "aggregate zero-weight clients — serve some "
                             "traffic first (maybe_sync gates on "
                             "min_samples)")
        if gen is None:
            seed = int(torch.randint(_SEED_HI, (1,), generator=self._gen))
            gen = torch.Generator(device=srv.device).manual_seed(seed)
        data = harvest.as_federated_data(
            pad_to=harvest.capacity if self.cfg.pad_to_capacity else None)
        kw = {} if self.aggregator is None else {
            "aggregator": self.aggregator}
        if self.cfg.cohort is not None:
            kw["cohort"] = self.cfg.cohort
        if getattr(self.aggregator, "needs_staleness", False):
            ids = harvest.client_ids()
            if not self.cfg.pad_to_capacity:  # unpadded stacks skip empties
                ids = [c for c in ids if len(harvest.buffer(c)) > 0]
            kw["staleness"] = self._staleness_vector(ids)
        if self.cfg.mesh is not None:
            # pad the stack to the clients axis (zero-weight clients), place
            # it sharded and fit on the mesh
            _, n = shd.clients_rank(self.cfg.mesh)
            data, stal = F.pad_client_axis(data, n, kw.get("staleness"))
            if stal is not None:
                kw["staleness"] = stal
            data = shd.shard_clients(data, self.cfg.mesh)
            kw["mesh"] = self.cfg.mesh
        new_router, hist = routers.fit_federated(
            srv.router, data, self.fcfg, gen=gen,
            rounds=self.cfg.rounds_per_sync, device=srv.device, **kw)
        del data                 # the sharded slab (no donation in torch)
        srv.swap_router_state(new_router.state)
        self._note_sync()
        # snapshot the engine's resilience counters alongside each sync so
        # a history trace shows how much shedding/preemption/expiry the
        # serving layer absorbed while this router version was learned
        self.history.append({"version": self.version,
                             "loss": hist["loss"],
                             "samples": len(harvest),
                             "engine": srv.engine.counters()})
        return hist

    def _staleness_vector(self, ids) -> np.ndarray:
        """(N,) syncs since each stacked client (sorted ids — the
        ``as_federated_data`` order) last contributed fresh samples; 0 for
        clients with new data since the previous sync."""
        out = []
        for c in ids:
            seen = self.server.harvest.buffer(c).total_seen
            if seen > self._seen_at_sync.get(c, 0):
                out.append(0)
            else:
                out.append(self._syncs - self._fresh_at_sync.get(c, 0))
        return np.asarray(out, np.float32)

    def _note_sync(self) -> None:
        """Advance the staleness bookkeeping after a completed sync."""
        for c in self.server.harvest.client_ids():
            seen = self.server.harvest.buffer(c).total_seen
            if seen > self._seen_at_sync.get(c, 0):
                self._fresh_at_sync[c] = self._syncs
            self._seen_at_sync[c] = seen
        self._syncs += 1

    # -------------------------------------------------- checkpoint / resume
    def save(self, path) -> None:
        """Checkpoint the WHOLE loop — router state + version, every
        harvest ring (verbatim: write heads, lifetime counters, LRU
        order), the loop stream's state, chunk counter, staleness
        bookkeeping, sync history, pending evaluations, and the engine's
        rid counter — via ``train/checkpoint`` (the reference's msgpack
        layout, atomic write). A loop restored from this file continues
        BIT-IDENTICALLY to one that was never interrupted (test-enforced).

        Requires an idle engine: in-flight KV state is not checkpointable,
        so ``drain()`` first. Pending evaluations (submitted, outcome not
        yet reported) survive: they are host-side tuples."""
        if self.server.engine.busy:
            raise ValueError("save() needs an idle engine — drain() "
                             "in-flight requests first (decode KV state "
                             "is not checkpointable; queued, active, and "
                             "preempted-awaiting-resume requests all count "
                             "as in-flight)")
        srv = self.server
        payload = {
            "format": CHECKPOINT_FORMAT,
            "family": srv.router.name,
            "router_state": srv.router.state,
            "router_version": int(srv.router_version),
            "key": self._gen.get_state(),
            "chunks": int(self._chunks),
            "syncs": int(self._syncs),
            "seen_at_sync": [[int(c), int(v)]
                             for c, v in self._seen_at_sync.items()],
            "fresh_at_sync": [[int(c), int(v)]
                              for c, v in self._fresh_at_sync.items()],
            "history": self.history,
            "harvest": srv.harvest.state(),
            "pending": [[int(rid), int(c), x, int(m), float(co)]
                        for rid, (c, x, m, co)
                        in srv._pending_evals.items()],
            "next_rid": int(srv.engine._next_rid),
        }
        mesh = self.cfg.mesh
        if mesh is None:
            ckpt.save(path, payload)
            return
        # every process holds the same loop: the mesh's first one writes,
        # and none returns before the file is whole
        import torch.distributed as dist
        if dist.get_rank() == int(mesh.mesh.reshape(-1)[0]):
            ckpt.save(path, payload)
        dist.barrier()

    def restore(self, path) -> "FedLoop":
        """Load a ``save()`` checkpoint of either package into this
        (freshly constructed, structurally identical) loop: same pool, same
        router family/config, same harvest d_emb/capacity. Returns self.
        The restored loop's subsequent routes, syncs, and history are
        bit-identical to the uninterrupted run's.

        The file is read onto the host: the router state then moves to the
        server's device, the harvest rings and pending embeddings become
        numpy, and the stream's state goes back to the CPU generator. A
        file of the JAX package holds a PRNG key (uint32 words) there; the
        stream is seeded from those words, so the port's later draws differ
        from the reference's, as all of its draws do."""
        blob = ckpt.restore(path, device="cpu")
        fmt = blob.get("format")
        if fmt != CHECKPOINT_FORMAT:
            raise ValueError(f"unsupported FedLoop checkpoint format {fmt} "
                             f"(this build reads {CHECKPOINT_FORMAT})")
        srv = self.server
        if blob["family"] != srv.router.name:
            raise ValueError(
                f"checkpoint holds a {blob['family']!r} router, this loop "
                f"serves {srv.router.name!r} — construct the server with "
                "the matching family")
        if srv.engine.busy:
            raise ValueError("restore() into a server with in-flight "
                             "requests — use a freshly built server")
        srv.router = srv.router.with_state(
            tree_map(lambda t: t.to(srv.device), blob["router_state"]))
        srv.router_version = int(blob["router_version"])
        srv.harvest.load_state(tree_map(
            lambda v: v.numpy() if isinstance(v, torch.Tensor) else v,
            blob["harvest"]))
        srv._pending_evals = {
            int(rid): (int(c), x.numpy().astype(np.float32), int(m),
                       float(co))
            for rid, c, x, m, co in blob["pending"]}
        srv.engine._next_rid = int(blob["next_rid"])
        key = blob["key"]
        if key.dtype == torch.uint8:
            self._gen.set_state(key.contiguous())
        else:
            seed = 0
            for w in key.reshape(-1).tolist():
                seed = (seed << 32) | (int(w) & 0xFFFFFFFF)
            self._gen.manual_seed(seed % 2 ** 64)
        self._chunks = int(blob["chunks"])
        self._syncs = int(blob["syncs"])
        self._seen_at_sync = {int(c): int(v)
                              for c, v in blob["seen_at_sync"]}
        self._fresh_at_sync = {int(c): int(v)
                               for c, v in blob["fresh_at_sync"]}
        self.history = [dict(h) for h in blob["history"]]
        return self

    def onboard_model(self, pm, calib: dict, *, gen,
                      steps: int = 100) -> None:
        """Mid-run pool expansion (§6.3): train the new model's head
        column on the calibration evals, then install model + expanded
        router. One model per call — ``server.add_model`` admits exactly
        one PoolModel. ``gen``: a generator on the server's device or an
        int seed."""
        router = self.server.router.onboard_model(
            calib, gen=gen, fcfg=self.fcfg, n_new=1, steps=steps)
        self.server.add_model(pm, router)


def personalize_client(fed_router, local_router, data_i: dict):
    """§6.4 composed with the loop: mix the FedLoop-produced global router
    with a client's locally fitted router, weighted per model by
    calibration errors on the client's own harvested samples
    (``EvalBuffer.as_client_data()``, moved to the routers' device).
    Returns (predict_fn, (w_acc, w_cost)) exactly like
    ``core.personalization.make_personalized``."""
    from repro_torch.core import personalization as P
    return P.make_personalized(fed_router.predict, local_router.predict,
                               on_device(data_i, fed_router.device),
                               fed_router.num_models)
