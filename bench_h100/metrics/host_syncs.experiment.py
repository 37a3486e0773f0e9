"""host_syncs.experiment (syncs/call): the program's counters ``sync.*``
(each a place the host waits for the card: ``sync.stereo_key``, the rig
read back to key the compiled step, one per leaf) summed over the traced
calls, per call."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "experiment":
        return None
    return spans.per_call(spans.collect(run), "sync.")
