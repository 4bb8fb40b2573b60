"""view.encode_ms: device time of the operations launched in the port's
"tcnerf.encode" range (the visual encoder), per view of the profiled
segment, in ms."""

from benchmark.lib import readers


def read(run):
    return readers.range_ms(run, "tcnerf.encode")
