"""view.chunks_ms: device time of every operation launched in the port's
"tcnerf.chunks" range (the chunk loop, K2 included), per view of the
profiled segment, in ms."""

from benchmark.lib import readers


def read(run):
    return readers.range_ms(run, "tcnerf.chunks")
