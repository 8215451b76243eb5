"""Share of the traced steps' wall with no device operation running
(the union of the profiled operations' intervals), in %."""
from perfbench import reduce


def read(rec):
    return reduce.idle_share_pct(rec)
