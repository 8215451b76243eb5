"""Σ wall of the port's ``engine.decode`` spans in the traced steps ÷ Σ
their decode passes, in ms: one pass of a lane's whole decode batch,
host and device, the chunk's device → host copy included."""
from perfbench import spans


def read(rec):
    v = spans.wall_per(rec, spans.DECODE, "passes")
    return None if v is None else v * 1e3
