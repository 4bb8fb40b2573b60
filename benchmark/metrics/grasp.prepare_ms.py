"""grasp.prepare_ms: CUDA-event time of `PoseOptimizer.prepare` (the
corner image through `GraspEBM.prepare`) per request, in ms."""

from benchmark.lib import readers

SPANS = {"grasp.prepare":
         "tcnerf_torch.opt.pose_optimizer:PoseOptimizer.prepare"}


def read(run):
    return readers.span_mean_ms(run, "grasp.prepare")
