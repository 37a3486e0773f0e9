"""graph_launch_ms.batch (ms): host ms of the replayed step's graph launch
(the program's span ``step.launch`` around ``graph.replay()``), the median
over the traced calls."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "batch":
        return None
    return spans.launch_ms_per_call(spans.collect(run), ["batch"])
