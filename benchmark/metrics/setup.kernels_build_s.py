"""setup.kernels_build_s: host time of the port's "tcnerf.kernels.build"
span (`ops/cuda_lib.py` `build_all`: nvcc on each CUDA library not yet
built in the checkout's `build/`) in the run's set-up, its warm-up units
included, where the first launch builds; 0 where every library was built
by an earlier run, in s."""

from benchmark.lib import program


def read(run):
    return program.in_setup_s(run, "tcnerf.kernels.build")
