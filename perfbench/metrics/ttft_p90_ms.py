"""p90 over every request due in the window of due → first token (a
request still queued at the window's end counts with its wait so far)."""
from perfbench import reduce


def read(rec):
    return reduce.p90(reduce.ttft_ms(rec))
