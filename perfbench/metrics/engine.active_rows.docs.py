"""Mean rows a window step decoded: ``engine.n_active()`` read after the
step plus the requests the step finished."""
from perfbench import reduce


def read(rec):
    return reduce.mean_rows(rec)
