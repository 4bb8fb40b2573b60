"""grasp.encode_ms: CUDA-event time of `GraspEBM.compute_features` per
request, in ms."""

from benchmark.lib import readers

SPANS = {"grasp.encode":
         "tcnerf_torch.models.grasp:GraspEBM.compute_features"}


def read(run):
    return readers.span_mean_ms(run, "grasp.encode")
