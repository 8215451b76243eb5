"""Process start → the window's start: imports, CUDA start, kernel builds
and loads, weights, pools, the pre-warm and the warm traffic."""


def read(rec):
    return rec["setup_s"]
