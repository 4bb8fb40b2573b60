"""grasp.step_dev_ms: device time of the operations launched in the port's
"tcnerf.grasp.step" ranges (energy, `autograd.grad`, Adam, post-process),
per ascent step of the profiled segment, in ms."""

from benchmark.lib import program


def read(run):
    return program.ranges_ms(run, ("tcnerf.grasp.step",),
                             per=run.work.get("steps", 0))
