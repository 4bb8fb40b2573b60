"""grasp.topk_ms: host time of the port's "tcnerf.grasp.topk" span (the
argsort of the energies on the host, the top poses read back and built
into the result), median over the window's requests, in ms."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.per_root_ms("tcnerf.grasp.topk")) \
        if win else None
