"""Σ wall of the port's ``engine.prefill`` spans in the traced steps ÷ Σ
their real prompt tokens (resume prefixes included), in µs: a prefill's
host and device time per token, up to its first tokens on the host."""
from perfbench import spans


def read(rec):
    v = spans.wall_per(rec, spans.PREFILL, "tokens")
    return None if v is None else v * 1e6
