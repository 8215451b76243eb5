"""Device operations starting in the port's ``engine.decode`` spans of the
traced steps ÷ Σ (passes × the lane's model's layers): the launches of
one layer of one decode pass."""
from perfbench import spans


def read(rec):
    return spans.ops_per_layer(rec, spans.DECODE)
