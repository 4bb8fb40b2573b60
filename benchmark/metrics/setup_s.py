"""setup_s: seconds from the start of the process to the start of the
window: imports, the card's context, weights, inputs, kernels built or
loaded, and the warm-up units."""


def read(run):
    return run.setup_s
