"""view_chunks_roofline: the least time of the chunks' gather + MLP work
at the view's shapes (lib/work.py `chunk_work`, bfloat16 operations or
bytes, whichever bounds it) over view.chunks_ms, in %."""

from benchmark.lib import peaks, readers


def read(run):
    ms = readers.range_ms(run, "tcnerf.chunks")
    work = run.work.get("chunks")
    if not ms or not work:
        return None
    return 100.0 * peaks.bound_ms(work["flops"], work["bytes"])[0] / ms
