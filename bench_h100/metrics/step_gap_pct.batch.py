"""step_gap_pct.batch (%): 100 x (1 - the device ms of the replayed step,
from the events the program puts first and last into its captured graph,
summed, over the wall time of the traced calls): the share of the calls,
with the profiler off, in which the card runs no replayed graph."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "batch":
        return None
    return spans.step_gap_pct(spans.collect(run), ["batch"])
