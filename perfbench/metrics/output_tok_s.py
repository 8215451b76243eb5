"""Output tokens of every request completed in the window ÷ the window's
seconds."""
from perfbench import reduce


def read(rec):
    return reduce.output_tok_s(rec)
