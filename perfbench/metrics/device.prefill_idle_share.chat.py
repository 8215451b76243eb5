"""Share of the port's ``engine.prefill`` spans' wall in the traced steps,
mapped onto the profiler's clock, with no device operation running (the
union of the profiled operations' intervals), in %."""
from perfbench import spans


def read(rec):
    return spans.idle_share_pct(rec, spans.PREFILL)
