"""fit_ms.batch (ms/frame): device ms of one replay of the full B-frame
step less that of its detect step (``probe="detect"``), over B: the
correspondence, triangulation, curvature and LM fit tail."""


def read(run):
    d = run.driver
    if d.entry != "batch":
        return None
    return (d.step_ms(run) - d.step_ms(run, "detect")) / d.batch
