"""train.step_ms_median: median host time of a step (from taking the batch
to its loss on the host) over the window, in ms."""

from benchmark.lib import readers


def read(run):
    return readers.median([r["step_s"] * 1e3 for r in run.records
                           if "step_s" in r])
