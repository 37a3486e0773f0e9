"""device_ms.stream (ms/frame): the card's busy time (union of kernel,
copy and set intervals) in the traced window of whole stream calls, over
the frames those calls returned."""


def read(run):
    if run.driver.entry != "stream" or run.trace is None or run.trace.n_device_events == 0:
        return None
    return 1e3 * run.trace.busy_s / run.traced_frames
