"""train.batch_wait_ms: host time of taking the next prefetched batch
(`data/prefetch.py` over `MVNeRFDataGenerator`), mean over the window's
steps, in ms."""


def read(run):
    waits = [r["wait_s"] for r in run.records if "wait_s" in r]
    return 1e3 * sum(waits) / len(waits) if waits else None
