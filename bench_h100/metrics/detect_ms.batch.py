"""detect_ms.batch (ms/frame): device ms of one replay of the B-frame
detect step (``compiled_batch(..., probe="detect")``, both views of every
frame) over B, by CUDA events over many replays."""


def read(run):
    d = run.driver
    if d.entry != "batch":
        return None
    return d.step_ms(run, "detect") / d.batch
