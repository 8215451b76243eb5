"""Device operations starting in the port's ``engine.prefill`` spans of
the traced steps ÷ Σ the span's model's layers: the launches of one
layer of one bucket's prefill."""
from perfbench import spans


def read(rec):
    return spans.ops_per_layer(rec, spans.PREFILL)
