"""mfu.grasp: the least time the published H100 peaks allow for one unit's
model operations (lib/work.py, at the precision the configuration states)
over the window's time per unit, in %."""

from benchmark.lib import readers


def read(run):
    return readers.mfu(run)
