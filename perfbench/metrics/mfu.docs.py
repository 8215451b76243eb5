"""Useful model FLOPs of the window's untraced steps (real prompt tokens,
decode passes up to each request's last token, top-k experts; ``costs.py``)
÷ (Σ their ``step()`` wall × the bf16 peak), in %."""
from perfbench import reduce


def read(rec):
    return reduce.mfu_pct(rec)
