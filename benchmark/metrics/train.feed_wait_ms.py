"""train.feed_wait_ms: host time of the port's "tcnerf.feed.wait" span (the
consumer taking the next prefetched batch), mean over the window, in ms."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.mean(win.each_ms("tcnerf.feed.wait")) if win else None
