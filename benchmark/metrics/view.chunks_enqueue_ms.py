"""view.chunks_enqueue_ms: host time of the port's "tcnerf.chunks" span
(the host launching the view's chunks), median over the window's views, in
ms; against view.chunks_ms, the same range's device time."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.per_root_ms("tcnerf.chunks")) if win else None
