"""front_ms.batch (ms/frame): device ms of the front stage (grey conversion,
smoothing, binarisation, the statistic images and joint centroids) inside
the replayed B-frame step, the median over the traced calls of the
program's span ``detect.front`` (two events inside the captured graph),
over B."""

from bench_h100.common import spans


def read(run):
    d = run.driver
    if d.entry != "batch":
        return None
    return spans.stage_ms_per_frame(spans.collect(run), "detect.front", "batch", d.batch)
