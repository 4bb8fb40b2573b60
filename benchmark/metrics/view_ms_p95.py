"""view_ms_p95: the 95th percentile of every view's latency in the window,
in ms."""

from benchmark.lib import readers, stats


def read(run):
    ms = readers.latencies_ms(run)
    return stats.percentile(ms, 95) if ms else None
