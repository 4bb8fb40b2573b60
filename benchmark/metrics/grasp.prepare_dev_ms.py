"""grasp.prepare_dev_ms: device time of the operations launched in the
port's "tcnerf.grasp.prepare" range (`PoseOptimizer.prepare`), per request
of the profiled segment, in ms."""

from benchmark.lib import program


def read(run):
    return program.ranges_ms(run, ("tcnerf.grasp.prepare",))
