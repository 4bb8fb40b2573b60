"""view.readback_ms: host time of the port's "tcnerf.view.readback" span
(the rendered rgb and depth copied to the host, which waits for the card,
and made uint8), median over the window's views, in ms."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.per_root_ms("tcnerf.view.readback")) \
        if win else None
