"""The clients mesh over ``torch.distributed`` (PyTorch counterpart of
``repro/sharding.py``, its cross-silo part).

JAX runs one controller over every device; ``torch.distributed`` runs one
process per device. A mesh here is a ``DeviceMesh`` over the initialized
default process group, and the federated fit shards its stacked
``(N, ...)`` client slab over the mesh's ``"clients"`` dimension, as
DTensors placed ``Shard(0)`` (the reference's ``NamedSharding(mesh,
P("clients"))``). Each process trains the clients it holds; no client's
data leaves its process, and the server stages run replicated in every
process.

Two pieces keep a sharded fit equal to the in-process one:

  * the fit's one collective, ``all_gather_rows``, is data movement
    only: every process's rows come back, in process order, unchanged;
  * ``ClientRows`` stands for the fit's generator over a stack of clients
    of which this process trains some rows: every draw over the stack
    (``rand``, ``multinomial1``) is made whole, from the same generator
    stream in every process, and this process keeps its rows. So each
    process draws exactly what the in-process fit draws, and the
    generators stay in step.

The serving meshes (``head_mesh``, ``data_mesh``, ``kv_pool_spec``,
``shard_kv_pool``) and the logical-axis rules (``use_rules``,
``constrain``) are not ported yet (slice 13 of the port).
"""
from __future__ import annotations

import math

import torch

CLIENTS = "clients"


def _dist():
    import torch.distributed as dist
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "a mesh needs an initialized default process group: call "
            "torch.distributed.init_process_group first (nccl on CUDA, "
            "gloo on the CPU)")
    return dist


def make_mesh(shape: dict):
    """A ``DeviceMesh`` of ``{axis: size}`` over the default process
    group, whose world size must equal the product of the sizes: of CUDA
    devices under nccl, else of CPU processes."""
    from torch.distributed.device_mesh import init_device_mesh
    dist = _dist()
    names = tuple(shape)
    sizes = tuple(int(shape[n]) for n in names)
    need, world = math.prod(sizes), dist.get_world_size()
    if need != world:
        raise ValueError(f"mesh {dict(zip(names, sizes))} needs {need} "
                         f"processes, the process group has {world}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, sizes, mesh_dim_names=names)


def client_mesh():
    """1-D ``("clients",)`` mesh over the whole default process group;
    each process owns a contiguous block of the client slab."""
    return make_mesh({CLIENTS: _dist().get_world_size()})


def clients_rank(mesh) -> tuple:
    """(this process's index along "clients", the dimension's size)."""
    names = getattr(mesh, "mesh_dim_names", None) or ()
    if CLIENTS not in names:
        raise TypeError("mesh= must be a DeviceMesh with a 'clients' "
                        "dimension (sharding.client_mesh), got "
                        f"{type(mesh).__name__}")
    return mesh.get_local_rank(CLIENTS), mesh.size(names.index(CLIENTS))


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def shard_clients(data: dict, mesh) -> dict:
    """Place a stacked federated dataset ``{"x": (N, D, d), ...}`` (the
    same full tensors in every process) with the client axis split over
    the mesh's "clients" dimension: DTensors ``Shard(0)``, each process
    holding N/n clients. N must divide the axis."""
    from torch.distributed.tensor import Shard, distribute_tensor
    N = next(iter(data.values())).shape[0]
    _, n = clients_rank(mesh)
    if N % n != 0:
        raise ValueError(
            f"client stack N={N} does not divide the clients mesh axis "
            f"({n}) — pad the stack (core.federated.pad_client_axis) or "
            "resize the mesh")
    return {k: distribute_tensor(torch.as_tensor(v), mesh, [Shard(0)])
            for k, v in data.items()}


def local_block(data: dict, mesh) -> tuple:
    """(the rows this process holds, N, the first global row it holds,
    whether it holds every row). Plain tensors are the whole stack in
    every process; DTensors hold this process's ``Shard(0)`` block."""
    first = next(iter(data.values()))
    N = first.shape[0]
    if not _is_dtensor(first):
        return dict(data), N, 0, True
    r, n = clients_rank(mesh)
    return {k: v.to_local() for k, v in data.items()}, N, r * (N // n), False


def _group(mesh):
    return mesh.get_group(CLIENTS)


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """(L, ...) rows of every process → (n·L, ...), in process order."""
    _, n = clients_rank(mesh)
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist = _dist()
    # the newer name of all_gather_into_tensor, where it exists
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, t, group=_group(mesh))
    return out


class ClientRows:
    """The fit's generator, standing for a stack of ``total`` clients of
    which this process trains the rows ``rows`` (stack positions, in
    order), padded to ``width`` rows with empty clients that draw
    nothing (zeros). Every draw is made over the whole stack and its rows
    kept, so it equals the in-process draw row for row and advances
    ``gen`` as the in-process fit does."""

    def __init__(self, gen: torch.Generator, rows: torch.Tensor, total: int,
                 width: int):
        self.gen, self.total, self.width = gen, total, width
        self.rows = torch.as_tensor(rows, dtype=torch.long, device=gen.device)
        self.device = gen.device

    def _rows(self, full: torch.Tensor, per: int) -> torch.Tensor:
        full = full.reshape((self.total, per) + tuple(full.shape[1:]))
        got = full[self.rows].reshape((-1,) + tuple(full.shape[2:]))
        pad = (self.width - self.rows.shape[0]) * per
        if pad:
            got = torch.cat([got, torch.zeros((pad,) + tuple(got.shape[1:]),
                                              dtype=got.dtype,
                                              device=got.device)])
        return got

    def rand(self, shape, dtype=None) -> torch.Tensor:
        full = torch.rand((self.total,) + tuple(shape[1:]),
                          generator=self.gen, device=self.device, dtype=dtype)
        return self._rows(full, 1)

    def multinomial1(self, p: torch.Tensor, per: int) -> torch.Tensor:
        """One draw per row of p (rows of ``per`` consecutive rows per
        client): ``torch.multinomial(p, 1)``'s own algorithm, argmax of
        p / q with q ~ Exp(1) drawn over the whole stack."""
        q = torch.empty((self.total * per, p.shape[-1]), dtype=p.dtype,
                        device=p.device).exponential_(1, generator=self.gen)
        return torch.argmax(p / self._rows(q, per), dim=-1, keepdim=True)


def rand(shape, gen, *, device, dtype=None) -> torch.Tensor:
    """``torch.rand(shape)`` from ``gen``, a generator or ``ClientRows``."""
    if isinstance(gen, ClientRows):
        return gen.rand(shape, dtype)
    return torch.rand(shape, generator=gen, device=device, dtype=dtype)


def multinomial1(p: torch.Tensor, gen, per: int = 1) -> torch.Tensor:
    """``torch.multinomial(p, 1)`` from ``gen``, a generator or
    ``ClientRows`` (whose clients own ``per`` consecutive rows of p)."""
    if isinstance(gen, ClientRows):
        return gen.multinomial1(p, per)
    return torch.multinomial(p, 1, generator=gen)


def _serving_mesh(name: str):
    def refuse(*args, **kwargs):
        raise NotImplementedError(
            f"sharding.{name} (the serving meshes and logical-axis rules) "
            "is not ported yet: slice 13 of the port")
    refuse.__name__ = name
    return refuse


head_mesh = _serving_mesh("head_mesh")
data_mesh = _serving_mesh("data_mesh")
kv_pool_spec = _serving_mesh("kv_pool_spec")
shard_kv_pool = _serving_mesh("shard_kv_pool")
use_rules = _serving_mesh("use_rules")
constrain = _serving_mesh("constrain")
