"""Kernel #3, ``paged_decode_attention`` (``kernels/csrc/decode_attention.cu``:
``decode_paged_kernel`` and its ``decode_merge_kernel``): the least time of
its launches in the traced steps, each row at its valid context
(``costs.paged_decode_cost``), ÷ their profiled device time, in %."""
from perfbench import reduce


def read(rec):
    return reduce.roofline_pct(rec, "decode_paged", ("decode_merge",))
