"""train.enqueue_ms: host time of the port's "tcnerf.train.step" span (the
host's time to launch a step; nothing in it waits on the card), median over
the window's steps, in ms."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.per_root_ms("tcnerf.train.step")) \
        if win else None
