"""grasp.guesses_ms: host time of the port's "tcnerf.grasp.guesses" span
(the schedules reset, the guesses drawn on the host and uploaded), median
over the window's requests, in ms."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.per_root_ms("tcnerf.grasp.guesses")) \
        if win else None
