"""view.median_ms: the median view latency over the window, in ms."""

from benchmark.lib import readers


def read(run):
    return readers.median(readers.latencies_ms(run))
