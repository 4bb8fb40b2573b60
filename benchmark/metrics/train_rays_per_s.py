"""train_rays_per_s: rays trained over the window's wall time; each step
ends with its loss on the host."""


def read(run):
    rays = sum(r.get("rays", 0) for r in run.records)
    return rays / run.window_s if rays and run.window_s > 0 else None
