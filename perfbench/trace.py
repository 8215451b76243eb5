"""The device trace of a ``--trace 1`` run: ``torch.profiler`` over a
steady sub-window of whole steps, reduced in memory (no trace file).

The harness opens a ``Tracer`` at a step boundary, marks each ``step()``
and ``submit`` it drives with a ``record_function`` span, and closes it
after its last step. ``reduce`` returns, on the profiler's clock in
seconds: ``ops`` — (name, start, end) of every device operation (kernels,
copies, sets; the harness's own span names left out), ``steps`` — the
steps' spans, ``spans`` — every harness span, and ``step_ids`` — the
harness's indices of the traced steps.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch

from perfbench.reduce import merged

STEP, SUBMIT = "perfbench.step", "perfbench.submit"


class Tracer:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.step_ids: List[int] = []
        self.prof.__enter__()

    @staticmethod
    def span(name: str):
        return torch.profiler.record_function(name)

    def close(self) -> Dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        return reduce(self.prof, self.step_ids)


def reduce(prof, step_ids: List[int]) -> Dict:
    ops, spans = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        a, b = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.name.startswith("perfbench."):
            if e.device_type != cuda:
                spans.append((e.name, a, b))
        elif e.device_type == cuda:
            ops.append((e.name, a, b))
    steps = sorted((a, b) for n, a, b in spans if n == STEP)
    return {"ops": ops, "spans": spans, "steps": steps,
            "step_ids": list(step_ids)}


def device_summary(tr: Optional[Dict], top: int = 10) -> Dict:
    """busy_s and window_s of the traced window (first step's start to
    the last step's end), and the breakdown: the device operations that
    took most time, by name, and the longest idle gaps, each named by the
    harness span the host was in (``loop`` outside any)."""
    if not tr or not tr["steps"]:
        return {}
    lo, hi = tr["steps"][0][0], tr["steps"][-1][1]
    ivs = merged((max(a, lo), min(b, hi)) for _, a, b in tr["ops"]
                 if b > lo and a < hi)
    busy = sum(b - a for a, b in ivs)
    by_name: Dict[str, float] = {}
    for n, a, b in tr["ops"]:
        by_name[n] = by_name.get(n, 0.0) + (b - a)
    gaps = []
    edges = [lo] + [x for iv in ivs for x in iv] + [hi]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            mid = 0.5 * (g0 + g1)
            inside = [n for n, a, b in tr["spans"] if a <= mid < b]
            name = inside[-1].split(".", 1)[1] if inside else "loop"
            gaps.append((name, g1 - g0))
    return {
        "busy_s": busy, "window_s": hi - lo,
        "device_ops": [[n[:64], s] for n, s in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps": [[n, s] for n, s in sorted(
            gaps, key=lambda g: -g[1])[:top]],
    }


@contextlib.contextmanager
def maybe_span(tracer: Optional[Tracer], name: str):
    if tracer is None:
        yield
    else:
        with tracer.span(name):
            yield
