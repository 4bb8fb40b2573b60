"""train.feed_make_ms: host time of the port's "tcnerf.feed.make" span (one
batch made in the producer thread: the generator, the pin and the upload
enqueued), median over the window, in ms."""

from benchmark.lib import program


def read(run):
    win = program.window(run)
    return program.median(win.each_ms("tcnerf.feed.make")) if win else None
