"""device_idle.grasp: 100 x (1 - device busy / wall) over the traced run's
profiled segment (a fixed count of units after the window)."""

from benchmark.lib import readers


def read(run):
    return readers.device_idle(run)
