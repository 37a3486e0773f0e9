"""step_gap_pct.experiment (%): 100 x (1 - the device ms of the replayed batch
and registration steps, from the events the program puts first and last
into each captured graph, summed, over the wall time of the traced calls):
the share of the calls, with the profiler off, in which the card runs no
replayed graph."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "experiment":
        return None
    return spans.step_gap_pct(spans.collect(run), ["batch", "registration"])
