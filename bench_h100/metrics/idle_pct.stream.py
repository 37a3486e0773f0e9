"""idle_pct.stream (%): share of the traced window of whole calls in which no
kernel, copy or set ran on the card (union of the profiler's device
intervals over the window's range)."""


def read(run):
    if run.driver.entry != "stream" or run.trace is None:
        return None
    return run.trace.idle_pct
