"""Mean host time of ``RoutedServer.submit`` (embedding in, routing by the
MLP trunk and kernel #1, tokenizing, enqueueing) over the window's
untraced submits."""
from perfbench import reduce


def read(rec):
    return reduce.mean_submit_ms(rec)
