"""lm_ms.batch (ms/frame): device ms of the fit's curvature start, LM steps,
axis prior and transform inside the replayed B-frame step, the median over
the traced calls of the program's span ``fit.lm`` (two events inside the
captured graph), over B."""

from bench_h100.common import spans


def read(run):
    d = run.driver
    if d.entry != "batch":
        return None
    return spans.stage_ms_per_frame(spans.collect(run), "fit.lm", "batch", d.batch)
