"""grasp.ascent_step_ms: CUDA-event time of `PoseOptimizer.optimize_pose`
(energy, `autograd.grad`, Adam) per ascent step, in ms."""

from benchmark.lib import readers

SPANS = {"grasp.ascent":
         "tcnerf_torch.opt.pose_optimizer:PoseOptimizer.optimize_pose"}


def read(run):
    per_request = readers.span_mean_ms(run, "grasp.ascent")
    steps = run.work.get("steps")
    return per_request / steps if per_request is not None and steps else None
