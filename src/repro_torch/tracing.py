"""The port's span log: where the engine's host time goes, on the clock
of ``time.perf_counter``.

``span(name, **attrs)`` is a context manager and ``mark(name, **attrs)``
an instant event. Each records ``(name, t0_ns, t1_ns, attrs)`` on
``time.perf_counter_ns()`` (``CLOCK_MONOTONIC``; a mark has
``t1_ns == t0_ns``) into one bounded process-wide ring of
``RING_LEN`` records; ``snapshot()`` returns a list copy of it.

Recording is on exactly while a ``torch.profiler`` session records in
the process (``torch.autograd._profiler_enabled()``), so the spans cover
the same window as the device trace. There is no other switch. Off, a
``span`` costs that one check and returns a shared no-op context
manager, and a ``mark`` returns at once.

To use it: attach a ``torch.profiler`` session, step the engine, and
read ``snapshot()`` beside ``prof.events()``.

The log creates no profiler event (no ``record_function``, no NVTX
range): with CUDA activity on, a user annotation also appears as a
device-typed event, and a reader of the device trace would count it as
device work and its interval as the device busy.
"""
from __future__ import annotations

import collections
import contextlib
import time
from typing import Deque, List, Tuple

import torch

#: records the ring holds; the oldest are dropped past it
RING_LEN = 65536

Record = Tuple[str, int, int, dict]

_ring: Deque[Record] = collections.deque(maxlen=RING_LEN)
_recording = torch.autograd._profiler_enabled
_OFF = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "attrs", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self) -> "_Span":
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        _ring.append((self.name, self.t0, time.perf_counter_ns(),
                      self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager that records ``name`` from entry to exit while a
    profiler records, and does nothing otherwise."""
    if not _recording():
        return _OFF
    return _Span(name, attrs)


def mark(name: str, **attrs) -> None:
    """Record an instant event while a profiler records."""
    if not _recording():
        return
    t = time.perf_counter_ns()
    _ring.append((name, t, t, attrs))


def snapshot() -> List[Record]:
    """The ring's records, oldest first."""
    return list(_ring)
