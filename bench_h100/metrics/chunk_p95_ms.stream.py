"""chunk_p95_ms.stream (ms): 95th percentile of the program's span
``stream.chunk``, a chunk's time from the start of its load to the end of
its materialisation on the host, over the chunks of the traced calls."""

from bench_h100.common import spans


def read(run):
    if run.driver.entry != "stream":
        return None
    return spans.p95_ms(spans.collect(run), "stream.chunk")
