"""train.backward_dev_ms: device time of the operations launched in the
port's "tcnerf.train.backward" range (`loss.backward()`, the checkpointed
chunks' recompute included), per step of the profiled segment, in ms."""

from benchmark.lib import program


def read(run):
    return program.ranges_ms(run, ("tcnerf.train.backward",))
