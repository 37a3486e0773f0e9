"""graph_launch_ms.experiment (ms): host ms of both replayed steps' graph
launches (the program's spans ``step.launch`` of the batch and the
registration step) in a call, the median over the traced calls."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "experiment":
        return None
    return spans.launch_ms_per_call(spans.collect(run), ["batch", "registration"])
