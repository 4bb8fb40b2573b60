"""setup.init_params_s: host time of the port's "tcnerf.init_params" span
(the builder's seeded initialisation, which the benchmark's weights then
overwrite) in the run's set-up, in s."""

from benchmark.lib import program


def read(run):
    return program.in_setup_s(run, "tcnerf.init_params")
