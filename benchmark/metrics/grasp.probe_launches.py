"""grasp.probe_launches: the probe chain library's kernel launches
(`ops/probe.py`, the counters "kernels.probe.*") over each grasp request,
median over the window's requests: 16 ascent steps of a forward and a
backward, and the final energies' forward. 0 where the requests launched
none: the plain path ran, or the program has no such library."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.counter_changes("kernels.probe.")) \
        if win else None
