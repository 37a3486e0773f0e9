"""wait_upload_pct.stream (%): 100 x the host time of the program's spans
``stream.wait_upload`` (the main loop waiting for the uploader thread's
next chunk, ``fut.result()``), summed over the traced calls, over their
wall time."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "stream":
        return None
    return spans.wait_pct(spans.collect(run), "stream.wait_upload")
