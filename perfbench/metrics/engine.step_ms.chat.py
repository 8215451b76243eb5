"""Mean wall time of ``step()`` over the window's untraced steps."""
from perfbench import reduce


def read(rec):
    return reduce.mean_step_ms(rec)
