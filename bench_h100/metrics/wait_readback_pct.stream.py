"""wait_readback_pct.stream (%): 100 x the host time of the program's spans
``stream.wait_readback`` (the wait for a chunk's readback before it is
materialised, ``done.synchronize()``), summed over the traced calls, over
their wall time."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "stream":
        return None
    return spans.wait_pct(spans.collect(run), "stream.wait_readback")
