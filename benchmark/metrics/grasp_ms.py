"""grasp_ms: the window's time over the grasp requests completed in it
(the mean service time of a request, in ms)."""

from benchmark.lib import readers


def read(run):
    return readers.per_unit_ms(run)
