"""train.forward_dev_ms: device time of the operations launched in the
port's "tcnerf.train.forward" range (the draws and `nerf_loss`) and the
encoder's ranges inside it, per step of the profiled segment, in ms."""

from benchmark.lib import program


def read(run):
    return program.ranges_ms(run, ("tcnerf.train.forward", "tcnerf.encode",
                                   "tcnerf.combine", "tcnerf.clip"))
