"""The arithmetic that turns a run's record into metrics, shared by the
readers in ``metrics/``. A reader that finds nothing to read returns None
and the harness leaves its metric out of the line.

A record (``bench.drive``) holds, on the host clock in seconds:

* ``t0``, ``t1`` — the window: from its start to the end of the first
  ``step()`` that returned at or after ``t0 + seconds``;
* ``req`` — per request, in submit order: ``due`` (absolute; open loop),
  ``t_first`` (the return of the ``step()`` after which it was no longer
  QUEUED), ``t_done``, ``step_admit``, ``step_done``, ``model``,
  ``P`` (prompt tokens), ``O`` (output tokens), ``submit_s`` (host time
  of its ``submit``);
* ``steps`` — per ``step()``: ``t_start``, ``t_end``, ``rows`` (requests
  it decoded: active after it plus finished by it), ``profiled``;
* ``trace`` — from the profiled sub-window (``trace.py``), or None.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from perfbench import costs


def p90(values) -> Optional[float]:
    v = np.asarray(list(values), np.float64)
    if len(v) == 0:
        return None
    return float(np.percentile(v, 90))


def window_steps(rec) -> np.ndarray:
    """Indices of the window's steps, the profiled ones left out."""
    s = rec["steps"]
    t = np.asarray(s["t_start"])
    keep = (t >= rec["t0"]) & (np.asarray(s["t_end"]) <= rec["t1"])
    return np.nonzero(keep & ~np.asarray(s["profiled"], bool))[0]


def ttft_ms(rec) -> np.ndarray:
    """Per request due in the window: due → first token, or due → the
    window's end for one still queued then."""
    r = rec["req"]
    due = np.asarray(r["due"], np.float64)
    first = np.asarray(r["t_first"], np.float64)
    inw = (due >= rec["t0"]) & (due < rec["t0"] + rec["seconds"])
    first = np.where(np.isnan(first) | (first > rec["t1"]), rec["t1"], first)
    return (first[inw] - due[inw]) * 1e3


def tpot_ms(rec) -> np.ndarray:
    """Per request completed in the window with ≥ 2 tokens: (completion −
    first token) / (tokens − 1)."""
    r = rec["req"]
    done = np.asarray(r["t_done"], np.float64)
    first = np.asarray(r["t_first"], np.float64)
    O = np.asarray(r["O"], np.float64)
    ok = (done > rec["t0"]) & (done <= rec["t1"]) & (O >= 2)
    return (done[ok] - first[ok]) / (O[ok] - 1) * 1e3


def output_tok_s(rec) -> float:
    r = rec["req"]
    done = np.asarray(r["t_done"], np.float64)
    ok = (done > rec["t0"]) & (done <= rec["t1"])
    return float(np.asarray(r["O"])[ok].sum() / (rec["t1"] - rec["t0"]))


def mean_step_ms(rec) -> Optional[float]:
    i = window_steps(rec)
    if len(i) == 0:
        return None
    s = rec["steps"]
    wall = np.asarray(s["t_end"])[i] - np.asarray(s["t_start"])[i]
    return float(wall.mean() * 1e3)


def mean_rows(rec) -> Optional[float]:
    i = window_steps(rec)
    return float(np.asarray(rec["steps"]["rows"])[i].mean()) if len(i) else None


def mean_submit_ms(rec) -> Optional[float]:
    r = rec["req"]
    t = np.asarray(r["t_submit"], np.float64)
    ok = (t >= rec["t0"]) & (t < rec["t1"]) & ~np.asarray(
        r["submit_profiled"], bool)
    v = np.asarray(r["submit_s"], np.float64)[ok]
    return float(v.mean() * 1e3) if len(v) else None


def step_flops(rec) -> np.ndarray:
    """Useful model FLOPs per step: a request's prefill in the step that
    admitted it (its real prompt tokens), and its decode passes t = 0 ..
    O - 2 (pass t yields token t + 2) in step admit + t // chunk; the
    passes past its last token are waste and not counted."""
    n = len(rec["steps"]["t_start"])
    out = np.zeros(n, np.float64)
    r, chunk = rec["req"], rec["chunk"]
    for i in range(len(r["P"])):
        a = r["step_admit"][i]
        if a < 0:
            continue
        m = rec["models"][r["model"][i]]
        P, useful = int(r["P"][i]), int(r["O"][i]) - 1
        out[a] += costs.prefill_flops(m, P)
        for s0 in range(0, useful, chunk):
            step = a + s0 // chunk
            if step >= n:
                break
            k = min(chunk, useful - s0)
            out[step] += costs.decode_passes_flops(m, P + s0, k)
    return out


def mfu_pct(rec) -> Optional[float]:
    i = window_steps(rec)
    if len(i) == 0:
        return None
    s = rec["steps"]
    wall = (np.asarray(s["t_end"])[i] - np.asarray(s["t_start"])[i]).sum()
    return float(step_flops(rec)[i].sum() / (wall * costs.PEAK_BF16_FLOPS)
                 * 100)


def union_length(intervals: Iterable[Tuple[float, float]],
                 lo: float, hi: float) -> float:
    """Length of the union of [a, b) intervals clipped to [lo, hi)."""
    total, end = 0.0, lo
    for a, b in sorted(intervals):
        a, b = max(a, end), min(b, hi)
        if b > a:
            total += b - a
            end = b
    return total


def merged(intervals: Iterable[Tuple[float, float]]) -> List[List[float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def idle_share_pct(rec) -> Optional[float]:
    """Share of the traced steps' wall with no device operation running
    (the union of the operations' intervals)."""
    tr = rec.get("trace")
    if not tr or not tr["ops"]:
        return None
    ops = [(a, b) for _, a, b in tr["ops"]]
    wall = busy = 0.0
    for a, b in tr["steps"]:
        wall += b - a
        busy += union_length(ops, a, b)
    return (1.0 - busy / wall) * 100 if wall > 0 else None


def decode_rows_nv(rec, step: int, model: int) -> List[List[int]]:
    """For each decode pass of ``model``'s lane in ``step``, the n_valid
    of every row: active rows at their position + 1, free rows 1."""
    r, chunk, slots = rec["req"], rec["chunk"], rec["slots"]
    act = [i for i in range(len(r["P"]))
           if r["model"][i] == model and 0 <= r["step_admit"][i] <= step
           and (r["step_done"][i] < 0 or r["step_done"][i] >= step)]
    if not act:
        return []
    passes = []
    for j in range(chunk):
        nv = [int(r["P"][i]) + chunk * (step - r["step_admit"][i]) + j + 1
              for i in act]
        passes.append(nv + [1] * (slots - len(act)))
    return passes


def roofline_pct(rec, kernel: str, extra: Tuple[str, ...] = ()
                 ) -> Optional[float]:
    """Σ least time ÷ Σ profiled device time of a decode attention
    kernel's launches in the traced steps (device operations whose name
    holds ``kernel``, plus those holding a name in ``extra``: the launch's
    other kernels). None when the trace holds none of them, or not as many
    launches of ``kernel`` as the timeline's passes × layers."""
    tr = rec.get("trace")
    if not tr:
        return None
    main = [b - a for n, a, b in tr["ops"] if kernel in n]
    rest = [b - a for n, a, b in tr["ops"] if any(k in n for k in extra)]
    least, launches = 0.0, 0
    for step in tr["step_ids"]:
        for mi, m in enumerate(rec["models"]):
            for nv in decode_rows_nv(rec, step, mi):
                f, b = costs.paged_decode_cost(m, nv, rec["page_size"])
                least += m["num_hidden_layers"] * costs.least_seconds(f, b)
                launches += m["num_hidden_layers"]
    if not main or launches != len(main):
        return None
    return least / (sum(main) + sum(rest)) * 100
