"""train.update_dev_ms: device time of the operations launched in the
port's "tcnerf.train.update" range (the clip and Adam) and in the
optimiser's own range inside it ("Optimizer.step#..."), per step of the
profiled segment, in ms."""

from benchmark.lib import program


def read(run):
    return program.ranges_ms(run, ("tcnerf.train.update",),
                             prefixes=("Optimizer.",))
