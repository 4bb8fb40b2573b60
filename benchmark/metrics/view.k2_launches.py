"""view.k2_launches: the swg library's kernel launches (`ops/swg.py`, the
counters "kernels.swg.*") over each view, median over the window's views."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.counter_changes("kernels.swg.")) \
        if win else None
