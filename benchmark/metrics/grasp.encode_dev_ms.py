"""grasp.encode_dev_ms: device time of the operations launched in the
port's "tcnerf.grasp.encode" range (`GraspPipeline.encode`: the upload and
`compute_features`) and the encoder's ranges inside it, per request of the
profiled segment, in ms."""

from benchmark.lib import program


def read(run):
    return program.ranges_ms(run, ("tcnerf.grasp.encode", "tcnerf.encode",
                                   "tcnerf.combine", "tcnerf.clip"))
