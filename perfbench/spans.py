"""The port's own spans in a traced run, on the device trace's clock.

While a profiler records, the port logs ``engine.prefill`` and
``engine.decode`` spans and ``engine.first_token`` marks
(``repro_torch.tracing``) on ``time.perf_counter_ns``, the clock of the
record's step times. Each traced step has a host interval
(``rec["steps"]``) and a ``perfbench.step`` span on the profiler's clock
(``rec["trace"]["steps"]``); the two ends give the step's offset between
the clocks. The ends, not the starts: the first ``record_function`` of a
profiler session records its start late, by up to a millisecond, while
the pair of ends agrees with the step's own device operations within
about 0.1 ms. ``program_spans`` keeps the log's records that lie inside
a traced step and tags each with its step's offset.

An operation belongs to a span when its start, on the profiler's clock,
lies in the span's mapped interval. Each prefill and decode span ends in
a device → host copy, so the device queue is empty at its end and an
operation that starts inside it was launched there.

Each reader returns None, and its metric is left out, where the record
has no traced steps, the port keeps no span log, or the log holds none
of the names it reads; the device readers also where the trace holds no
device operation.
"""
from __future__ import annotations

import bisect
import math
from typing import List, NamedTuple, Optional

from perfbench import reduce

PREFILL, DECODE, FIRST = "engine.prefill", "engine.decode", "engine.first_token"


class Span(NamedTuple):
    name: str
    t0: float           #: start on the host clock, s (a mark: t0 == t1)
    t1: float
    attrs: dict
    offset: float       #: profiler clock − host clock in its step, s

    @property
    def mapped(self):
        """(start, end) on the profiler's clock."""
        return self.t0 + self.offset, self.t1 + self.offset


def program_spans(rec, name: Optional[str] = None) -> List[Span]:
    """The port's log records named ``name`` (all, if None) that lie
    within a traced step of ``rec``, oldest first."""
    tr = rec.get("trace")
    if not tr or not tr["step_ids"] or len(tr["step_ids"]) != len(
            tr["steps"]):
        return []
    try:
        from repro_torch import tracing
    except ImportError:         # a port without the span log
        return []
    t_start, t_end = rec["steps"]["t_start"], rec["steps"]["t_end"]
    steps = [(t_start[i], t_end[i], p1 - t_end[i])
             for i, (_, p1) in zip(tr["step_ids"], tr["steps"])]
    out = []
    for n, a, b, attrs in tracing.snapshot():
        if name is not None and n != name:
            continue
        a, b = a * 1e-9, b * 1e-9
        for lo, hi, off in steps:
            if lo <= a and b <= hi:
                out.append(Span(n, a, b, attrs, off))
                break
    return out


def ops_in(rec, spans: List[Span]) -> List[tuple]:
    """The trace's device operations (name, start, end) whose start lies
    in one of ``spans``' mapped intervals."""
    ops = sorted(rec["trace"]["ops"], key=lambda op: op[1])
    starts = [op[1] for op in ops]
    out = []
    for s in spans:
        lo, hi = s.mapped
        out += ops[bisect.bisect_left(starts, lo):
                   bisect.bisect_right(starts, hi)]
    return out


def wall_per(rec, name: str, attr: str) -> Optional[float]:
    """Σ wall of the traced ``name`` spans ÷ Σ their ``attr``, in s."""
    sp = program_spans(rec, name)
    n = sum(s.attrs[attr] for s in sp)
    return sum(s.t1 - s.t0 for s in sp) / n if n else None


def ops_per_layer(rec, name: str) -> Optional[float]:
    """Device operations starting in the traced ``name`` spans ÷ Σ the
    layers they ran: each span's model's layers, times its ``passes``
    for a decode span."""
    sp = program_spans(rec, name)
    if not sp or not rec["trace"]["ops"]:
        return None
    layers = sum(rec["models"][s.attrs["model"]]["num_hidden_layers"]
                 * s.attrs.get("passes", 1) for s in sp)
    return len(ops_in(rec, sp)) / layers


def idle_share_pct(rec, name: str) -> Optional[float]:
    """Share of the traced ``name`` spans' mapped wall with no device
    operation running (the union of the operations' intervals), in %."""
    sp = program_spans(rec, name)
    if not sp or not rec["trace"]["ops"]:
        return None
    ivs = [(a, b) for _, a, b in rec["trace"]["ops"]]
    wall = sum(s.t1 - s.t0 for s in sp)
    busy = sum(reduce.union_length(ivs, *s.mapped) for s in sp)
    return (1.0 - busy / wall) * 100 if wall > 0 else None


def first_token_hold_ms(rec) -> Optional[float]:
    """Mean over the requests whose first ``engine.first_token`` mark lies
    in a traced step of the harness's ``t_first`` (the return of the step
    that admitted it) − the mark, matched by rid, in ms."""
    r = rec["req"]
    row = {int(rid): i for i, rid in enumerate(r["rid"])}
    holds, seen = [], set()
    for m in program_spans(rec, FIRST):
        i = row.get(m.attrs["rid"])
        if i is None or i in seen or math.isnan(r["t_first"][i]):
            continue
        seen.add(i)
        holds.append(r["t_first"][i] - m.t0)
    return sum(holds) / len(holds) * 1e3 if holds else None
