"""roi_ms.batch (ms/frame): device ms of the ROI stage (quarter-res ROI and
saturation CC, ROI mask, centre seed, saturation carve) inside the
replayed B-frame step, the median over the traced calls of the program's
span ``detect.roi`` (two events inside the captured graph), over B."""

from bench_h100.common import spans


def read(run):
    d = run.driver
    if d.entry != "batch":
        return None
    return spans.stage_ms_per_frame(spans.collect(run), "detect.roi", "batch", d.batch)
