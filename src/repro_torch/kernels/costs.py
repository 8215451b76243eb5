"""Operation and byte counts of an eager PyTorch step (PyTorch counterpart
of ``repro/launch/hlo_analysis.py``'s counting; its roofline is
``launch/op_analysis.py``).

The reference parses the compiled HLO text of a step. The port runs
eagerly, so ``OpCosts`` is a ``TorchDispatchMode`` that sees every aten
op the step dispatches, on any device, the meta device included (where
nothing is allocated and no value exists):

  * FLOPs — every matmul-family op (``mm``, ``bmm``, ``addmm``,
    ``baddbmm``, ``addbmm``, ``mv``, ``dot``; ``einsum``, ``matmul`` and
    ``linear`` reach the mode as these): 2 · |out| · Π(contracting dims),
    the reference's ``dot`` rule. Elementwise FLOPs are ignored, as in
    MFU arithmetic.
  * ``op_bytes`` — Σ(inputs + outputs) of every op that is not a view or
    a metadata op (views, ``detach``, ``empty*``, ``_unsafe_view`` and
    the like are free, as the reference's ``_FREE_OPS``). The reference
    skips elementwise ops, which XLA fuses into their neighbours on the
    TPU; the port runs eagerly on the GPU, where each elementwise op is a
    kernel that reads and writes memory, so they are counted. An op that
    writes into part of a tensor (``index_put_``, ``index_copy_``, the
    scatters) counts its values once read and once written, not the whole
    destination (the reference's in-place ``dynamic-update-slice`` rule);
    ``copy_``, ``fill_`` and ``zero_`` do not read their destination.
  * collectives — the output bytes of every ``c10d`` op the mode sees,
    by kind (all-gather, all-reduce, reduce-scatter, all-to-all,
    broadcast, scatter).

The hand-written kernels go through ``ctypes``, so the mode cannot see
them. Each entry of ``kernels/ops.py`` (and the model code that stands
for a kernel, or whose work is counted once and scaled) therefore
records its work through ``kernel`` whatever implements it, and nothing
inside is counted twice. A kernel's nominal work is taken from shapes
(the whole cache capacity, as the reference's CPU HLO dots count it), not
from ``n_valid`` values, which meta tensors do not have. So a step counts
the same on the meta device, on the CPU and on the card.

``kernel`` costs one module-level test when no ``OpCosts`` is counting:
the serving paths call it on every kernel launch.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_flatten

_aten = torch.ops.aten

#: matmul-family ops → (index of the left operand, its contracting dim)
_MATMUL = {
    _aten.mm.default: (0, -1), _aten.bmm.default: (0, -1),
    _aten.addmm.default: (1, -1), _aten.baddbmm.default: (1, -1),
    _aten.addbmm.default: (1, -1), _aten.mv.default: (0, -1),
    _aten.dot.default: (0, -1),
}
#: ops that move no data (metadata, allocation, aliasing)
_FREE = {"detach", "empty", "empty_like", "empty_strided", "new_empty",
         "new_empty_strided", "_unsafe_view", "lift_fresh", "alias",
         "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
         "_local_scalar_dense", "resize_", "set_", "record_stream"}
#: in-place ops that write their destination without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "exponential_", "random_", "bernoulli_"}
#: in-place ops that write part of their destination: (values' arg index)
_PARTIAL_WRITE = {"index_put_": 2, "_index_put_impl_": 2, "index_copy_": 3,
                  "index_add_": 3, "scatter_": 3, "scatter_add_": 3,
                  "scatter_reduce_": 3, "masked_scatter_": 2}
_COLLECTIVE_KINDS = (("allgather", "all-gather"), ("all_gather", "all-gather"),
                     ("allreduce", "all-reduce"),
                     ("reduce_scatter", "reduce-scatter"),
                     ("alltoall", "all-to-all"), ("broadcast", "broadcast"),
                     ("scatter", "scatter"))

#: how many ``OpCosts`` are entered in this process (``kernel``'s fast path)
_ENTERED = 0


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) else 0


def _tensors(x) -> list:
    return [t for t in tree_flatten(x)[0] if isinstance(t, torch.Tensor)]


def _collective_kind(name: str) -> Optional[str]:
    for key, kind in _COLLECTIVE_KINDS:
        if key in name:
            return kind
    return None


class OpCosts(TorchDispatchMode):
    """Counts the FLOPs, bytes and collective bytes of everything run
    inside ``with OpCosts() as c:``. ``totals()`` returns them;
    ``by_op`` (FLOPs by op name) and ``kernels`` (FLOPs, bytes and calls
    by the name a ``kernel`` region records) say where they came from."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.op_bytes = 0
        self.collectives = Counter()
        self.by_op = Counter()
        self.kernels = {}
        self._suspended = 0

    def __enter__(self):
        global _ENTERED
        _ENTERED += 1
        return super().__enter__()

    def __exit__(self, *exc):
        global _ENTERED
        _ENTERED -= 1
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._suspended:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        if func.namespace == "c10d":
            kind = _collective_kind(func._opname)
            if kind is not None:
                self.collectives[kind] += sum(_nbytes(t)
                                              for t in _tensors(args[0]))
            return
        name = func._opname
        if func in _MATMUL:
            i, dim = _MATMUL[func]
            k = args[i].shape[dim]
            if func is _aten.addbmm.default:     # the batch is summed away
                k *= args[i].shape[0]
            n_out = out.numel() if func is not _aten.dot.default else 1
            f = 2 * n_out * k
            self.flops += f
            self.by_op[name] += f
        if func.is_view or name in _FREE:
            return
        written = [a.name for a in func._schema.arguments
                   if a.alias_info is not None and a.alias_info.is_write]
        if not written:
            self.op_bytes += (sum(map(_nbytes, _tensors((args, kwargs))))
                              + sum(map(_nbytes, _tensors(out))))
            return
        pos = {a.name: j for j, a in enumerate(func._schema.arguments)}
        dest = [args[pos[n]] if pos[n] < len(args) else kwargs.get(n)
                for n in written]
        rest = [a for j, a in enumerate(args)
                if func._schema.arguments[j].name not in written]
        rest += [v for k, v in kwargs.items() if k not in written]
        read = sum(map(_nbytes, _tensors(rest)))
        if name in _PARTIAL_WRITE:
            vals = args[_PARTIAL_WRITE[name]]
            self.op_bytes += read + _nbytes(vals)
            return
        wrote = sum(map(_nbytes, _tensors(dest)))
        # an in-place update (add_, mul_) reads its destination too
        write_only = (name in _WRITE_ONLY
                      or func._schema.overload_name.startswith("out"))
        self.op_bytes += read + wrote * (1 if write_only else 2)

    def add_kernel(self, name: str, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.op_bytes += nbytes
        self.by_op[name] += flops
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0,
                                           "bytes": 0})
        k["calls"] += 1
        k["flops"] += flops
        k["bytes"] += nbytes

    def totals(self) -> dict:
        return {"flops": self.flops, "op_bytes": self.op_bytes,
                "collectives": dict(self.collectives),
                "collective_bytes": sum(self.collectives.values())}


def active() -> list:
    """Every ``OpCosts`` counting here (innermost last)."""
    if not _ENTERED:
        return []
    return [m for m in _get_current_dispatch_mode_stack()
            if isinstance(m, OpCosts)]


class _Region:
    """``kernel``'s region while some ``OpCosts`` counts."""

    def __init__(self, name: str, work):
        self.name, self.work, self.costs = name, work, []

    def __enter__(self):
        self.costs = active()
        for c in self.costs:
            c._suspended += 1
        if self.costs:
            # ``work`` may count ops itself (``measure``): nothing it runs
            # reaches the suspended modes
            flops, nbytes = self.work()
            for c in self.costs:
                c.add_kernel(self.name, flops, nbytes)
        return self

    def __exit__(self, *exc):
        for c in self.costs:
            c._suspended -= 1
        return False


class _Nothing:
    """``kernel``'s region when nothing counts: one shared object."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOTHING = _Nothing()


def kernel(name: str, work):
    """A region whose work, ``work()`` → (FLOPs, bytes), is recorded in
    every active ``OpCosts`` under ``name``, and of which nothing that
    runs inside (a kernel's wrapper or its plain version) is counted.
    With no ``OpCosts`` entered it returns a shared do-nothing region."""
    if not _ENTERED:
        return _NOTHING
    return _Region(name, work)


def measure(fn, *args) -> tuple:
    """(FLOPs, bytes) that ``fn(*args)`` dispatches, counted in an
    ``OpCosts`` of its own (run it on meta tensors to count the work of
    shapes that hold no values)."""
    with OpCosts() as c:
        fn(*args)
    return c.flops, c.op_bytes


def tensor_bytes(*ts) -> int:
    """Bytes of the tensors ``ts`` (each read or written once)."""
    return sum(math.prod(t.shape) * t.element_size() for t in ts)
