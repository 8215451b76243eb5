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

The serving meshes split the engine's KV pools the same way, one process
per device: ``"data"`` splits the slots (slot-parallel decode: each
process decodes its block of slots, and one all-gather of the chunk's
tokens gives every process the whole batch), ``"heads"`` splits the KV
heads (each process attends over its block of KV heads and their query
heads, and the outputs are all-gathered in head order before ``wo``).
Both are data movement only, so tokens equal the solo engine's. A process
holds its block of a pool as a tensor of its own (``shard_kv_pool``): the
decode kernels want contiguous caches, and the block is what saves
memory. ``SlotBlock`` and ``HeadBlock`` are this process's blocks and
their collectives.

The logical-axis rules (``use_rules``, ``resolve_spec``, ``constrain``,
``ENGINE_RULES``) are the reference's logic in plain Python:
``resolve_spec`` returns one mesh axis (or None) per dimension, and
``constrain`` redistributes a ``DTensor`` to it (plain tensors pass
through). The MoE's expert-parallel dispatch reads the active rules
(``models/moe.py``). The reference's ``named`` (a ``NamedSharding``
constructor) and its ``shard_map`` version shim are JAX mechanism and have
no counterpart here.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence, Union

import torch

from repro_torch.train.optim import tree_leaves, tree_map

Axis = Union[str, Sequence[str], None]

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


def _all_gather(t: torch.Tensor, group, n: int) -> torch.Tensor:
    """(L, ...) rows of each of the group's n processes → (n·L, ...), in
    group-rank order."""
    t = t.contiguous()
    out = torch.empty((n * t.shape[0],) + tuple(t.shape[1:]), dtype=t.dtype,
                      device=t.device)
    dist = _dist()
    # the newer name of all_gather_into_tensor, where it exists
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, t, group=group)
    return out


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """(L, ...) rows of every process → (n·L, ...), in process order."""
    _, n = clients_rank(mesh)
    return _all_gather(t, _group(mesh), n)


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




# ---------------------------------------------------------------------------
# Logical-axis rules
# ---------------------------------------------------------------------------

_CURRENT: Optional[tuple] = None  # (mesh, rules: dict[str, Axis])

#: the serve engine's rules: the attention heads onto the "heads" axis
#: (``heads4d`` is the uneven-shardable 4-D head name) and the batch (slot)
#: dimension onto "data"
ENGINE_RULES = {"heads": "heads", "heads4d": "heads", "batch": "data"}


@contextlib.contextmanager
def use_rules(mesh, rules: dict):
    """Bind logical axis names to the mesh's axes inside the block."""
    global _CURRENT
    prev = _CURRENT
    _CURRENT = (mesh, rules)
    try:
        yield
    finally:
        _CURRENT = prev


def active() -> bool:
    return _CURRENT is not None


def current() -> tuple:
    """(mesh, rules) of the innermost ``use_rules``."""
    if _CURRENT is None:
        raise TypeError("no logical-axis rules are active: run this under "
                        "sharding.use_rules(mesh, rules)")
    return _CURRENT


def mesh_axes(mesh) -> dict:
    """{axis name: size} of a ``DeviceMesh`` (or of any object whose
    ``shape`` is that mapping, as a JAX mesh's is)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        return dict(mesh.shape)
    return dict(zip(names, tuple(mesh.shape)))


def _names(axis: Axis) -> tuple:
    return () if axis is None else (
        (axis,) if isinstance(axis, str) else tuple(axis))


def axis_size(mesh, axis: Axis) -> int:
    axes = mesh_axes(mesh)
    return math.prod(axes[a] for a in _names(axis))


def resolve_spec(logical: Sequence, shape: Sequence[int]) -> Optional[tuple]:
    """Map logical axis names to one mesh axis (or None) per dimension
    under the active rules; None outside ``use_rules``. A rule naming an
    axis the mesh lacks replicates, as does a dimension the axis size does
    not divide, unless the logical name ends in "!" (uneven sharding)."""
    if _CURRENT is None:
        return None
    mesh, rules = _CURRENT
    axes = mesh_axes(mesh)
    out = []
    for dim, name in zip(shape, logical):
        uneven = isinstance(name, str) and name.endswith("!")
        key = name[:-1] if uneven else name
        axis = rules.get(key) if key is not None else None
        if axis is not None and any(a not in axes for a in _names(axis)):
            axis = None
        if axis is not None and not uneven \
                and dim % axis_size(mesh, axis) != 0:
            axis = None  # non-divisible → replicate this dim
        out.append(axis)
    return tuple(out)


def _placements(mesh, spec: tuple) -> list:
    """DTensor placements of a resolved spec: each mesh dimension shards
    the tensor dimension that names it, or replicates."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [i for i, a in enumerate(spec) if name in _names(a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def constrain(x, logical: Sequence):
    """Lay x out as its logical axis names say under the active rules: a
    ``DTensor`` is redistributed; outside ``use_rules``, and for a plain
    tensor (the same whole values in every process), x is returned as it
    is."""
    if _CURRENT is None or not _is_dtensor(x):
        return x
    mesh, _ = _CURRENT
    return x.redistribute(mesh, _placements(mesh,
                                            resolve_spec(logical, x.shape)))


def axis_index(mesh, axis: Axis) -> int:
    """This process's index along ``axis`` (row-major over a tuple)."""
    axes, idx = mesh_axes(mesh), 0
    for a in _names(axis):
        idx = idx * axes[a] + mesh.get_local_rank(a)
    return idx


def axis_group(mesh, axis: Axis):
    """The process group along ``axis`` (a tuple of several mesh axes is
    flattened into one)."""
    names = _names(axis)
    if len(names) == 1:
        return mesh.get_group(names[0])
    return mesh[names]._flatten().get_group()


def all_reduce_sum(t: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """The sum of t over ``axis`` (in place; returns t)."""
    if axis_size(mesh, axis) > 1:
        _dist().all_reduce(t, group=axis_group(mesh, axis))
    return t


def all_gather_axis(t: torch.Tensor, mesh, axis: Axis) -> torch.Tensor:
    """(L, ...) rows of each process along ``axis`` → (n·L, ...), in
    index order along it."""
    n = axis_size(mesh, axis)
    return _all_gather(t, axis_group(mesh, axis), n) if n > 1 else t


# ---------------------------------------------------------------------------
# The serving meshes
# ---------------------------------------------------------------------------


def head_mesh():
    """1-D ``("heads",)`` mesh over the whole default process group: the
    engine splits each KV pool's heads over it."""
    return make_mesh({"heads": _dist().get_world_size()})


def data_mesh():
    """1-D ``("data",)`` mesh over the whole default process group: the
    engine splits each lane's slots over it (slot-parallel decode)."""
    return make_mesh({"data": _dist().get_world_size()})


def replicate(tree, mesh):
    """Broadcast every tensor leaf of ``tree`` (dicts and lists) in place
    from the mesh's first process, so every process serves the same bytes
    (the mesh spans the whole default group). Returns ``tree``."""
    dist = _dist()
    src = int(mesh.mesh.reshape(-1)[0])
    for t in tree_leaves(tree):
        dist.broadcast(t, src)
    return tree


def shard_leading(tree, mesh, axis: str):
    """Every tensor leaf as a DTensor with its leading dim split over the
    mesh's ``axis`` (replicated where that dim does not divide it)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    n = mesh_axes(mesh)[axis]

    def put(a):
        a = torch.as_tensor(a)
        split = a.dim() and a.shape[0] % n == 0
        pl = [Shard(0) if name == axis and split else Replicate()
              for name in mesh.mesh_dim_names]
        return distribute_tensor(a, mesh, pl)

    return tree_map(put, tree)


def kv_pool_spec(leaf_ndim: int, mesh, leaf_shape=None) -> tuple:
    """The mesh axis of each dimension of a KV-pool leaf: 5-D leaves
    ``(n_units, slots|pages, Hkv, seq, hd)`` split dim 1 over "data" and
    dim 2 over "heads" where the mesh has the axis and it divides the dim;
    other leaves split only their dim-1 batch over "data"; the rest
    replicates."""
    axes = mesh_axes(mesh)

    def fits(dim_size, ax):
        return ax in axes and dim_size is not None \
            and dim_size % axes[ax] == 0

    shape = leaf_shape if leaf_shape is not None else [None] * leaf_ndim
    spec = [None] * leaf_ndim
    if leaf_ndim >= 2 and fits(shape[1], "data"):
        spec[1] = "data"
    if leaf_ndim == 5 and fits(shape[2], "heads"):
        spec[2] = "heads"
    return tuple(spec)


def _block(mesh, axis: str, size: int) -> tuple:
    """(first index, length) of this process's block of ``size`` along
    ``axis``, which divides it."""
    n = size // mesh_axes(mesh)[axis]
    return mesh.get_local_rank(axis) * n, n


def shard_kv_pool(pool, mesh, *, paged: bool = False):
    """This process's block of each leaf of a KV pool (nested dicts), as
    ``kv_pool_spec`` splits it, each a tensor of its own (contiguous; the
    whole leaf can then be freed). ``paged=True`` keeps a page pool's
    page dimension (dim 1) whole: the engine splits a paged lane's slots,
    not its pages (``serve/kv_cache.py``)."""
    def local(a):
        spec = list(kv_pool_spec(a.dim(), mesh, tuple(a.shape)))
        if paged:
            spec[1] = None
        for dim, axis in enumerate(spec):
            if axis is not None:
                a = a.narrow(dim, *_block(mesh, axis, a.shape[dim]))
        return a.clone(memory_format=torch.contiguous_format)

    return tree_map(local, pool)


class SlotBlock:
    """This process's block of a lane's slots over the mesh's "data"
    axis: slots ``lo`` .. ``lo + n``; ``gather`` returns every process's
    rows of a per-slot tensor in slot order."""

    def __init__(self, mesh, slots: int):
        self.lo, self.n = _block(mesh, "data", slots)
        self.rows = slice(self.lo, self.lo + self.n)
        self.k = mesh_axes(mesh)["data"]
        self.group = mesh.get_group("data")

    @classmethod
    def of(cls, mesh, slots: int) -> Optional["SlotBlock"]:
        """The block, or None where the slots are not split (no "data"
        axis, or one that does not divide them: every process decodes
        every slot, as ``kv_pool_spec`` replicates)."""
        if kv_pool_spec(2, mesh, (None, slots))[1] is None:
            return None
        return cls(mesh, slots)

    def owns(self, slot: int) -> bool:
        return self.lo <= slot < self.lo + self.n

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        """(n, ...) rows of this process → (slots, ...)."""
        return _all_gather(t, self.group, self.k)


class HeadBlock:
    """This process's block of a model's KV heads over the mesh's "heads"
    axis: KV heads ``lo`` .. ``lo + n`` of ``total``, and their query
    heads. ``take`` keeps the block of a projection, ``gather`` puts every
    process's attention output back in head order."""

    def __init__(self, mesh, total: int):
        self.lo, self.n = _block(mesh, "heads", total)
        self.total = total
        self.k = mesh_axes(mesh)["heads"]
        self.group = mesh.get_group("heads")

    @classmethod
    def of(cls, mesh, n_kv_heads: int) -> Optional["HeadBlock"]:
        """The block, or None where the heads are not split (no "heads"
        axis, or one that does not divide them)."""
        if kv_pool_spec(5, mesh, (None, None, n_kv_heads))[2] is None:
            return None
        return cls(mesh, n_kv_heads)

    def take(self, q, k, v, g: int) -> tuple:
        """The block's heads of (B, S, H, hd) projections: q heads
        ``lo·g`` .. ``(lo + n)·g``, K and V heads ``lo`` .. ``lo + n``."""
        lo, n = self.lo, self.n
        return (q[:, :, lo * g:(lo + n) * g], k[:, :, lo:lo + n],
                v[:, :, lo:lo + n])

    def kv(self, cache: dict) -> dict:
        """The block's heads of a prefill cache (leaves (L, B, Hkv, S,
        hd), nested by layer)."""
        return {name: {k: t[:, :, self.lo:self.lo + self.n]
                       for k, t in layer.items()}
                for name, layer in cache.items()}

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """(..., n, g, hd) attention output of this process's heads →
        (..., total, g, hd), every process's heads in order."""
        lead, (n, g, hd) = out.shape[:-3], out.shape[-3:]
        got = _all_gather(out.reshape(1, -1, n, g, hd), self.group, self.k)
        return got.transpose(0, 1).reshape(tuple(lead) + (self.total, g, hd))
