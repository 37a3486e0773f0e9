"""The kernel calls a roofline reader times, as the detector makes them:
one eager ``detect_grid`` call on the cell's first batch, with the
wrappers of ``ops.frontend`` that a reader names recording their
arguments on the way.  The detector's own stages build every input, so a
site is the cell's, at the cell's shapes."""

from __future__ import annotations

from typing import Optional

WRAPPERS = ("connected_components", "bridge_morphology")


def sites(run) -> dict:
    """{wrapper: [(args, kwargs), ...]} of the calls of one eager
    ``detect_grid`` on the driver's first batch, in call order; made once a
    run."""
    return run.memo("kernel_sites", lambda: _record(run.driver))


def _record(d) -> dict:
    import torch

    fe = d.p.frontend
    calls = {name: [] for name in WRAPPERS}
    originals = {name: getattr(fe, name) for name in WRAPPERS}

    def recorder(name):
        def call(*args, **kwargs):
            calls[name].append((args, kwargs))
            return originals[name](*args, **kwargs)
        return call

    da, db = d.upload(*d.batches[0])
    try:
        for name in WRAPPERS:
            setattr(fe, name, recorder(name))
        with torch.inference_mode():
            d.p.detector.detect_grid(torch.cat([da, db]), d.detect_cfg)
    finally:
        for name, fn in originals.items():
            setattr(fe, name, fn)
    return calls


def route_ms(run, wrapper: str, route: str, site, reps: int = 20) -> Optional[float]:
    """Device ms of one ``wrapper`` call on a recorded ``site`` (args,
    kwargs), by CUDA events over ``reps`` calls (``run.cuda_ms``); None
    unless the program counts the route (``kernel.<wrapper>.<route>``) and
    one call counts once on it."""
    fe = run.driver.p.frontend
    counter = f"{wrapper}.{route}"
    if counter not in fe.launch_counts():
        return None
    import torch

    args, kwargs = site
    fn = getattr(fe, wrapper)
    with torch.inference_mode():
        before = fe.launch_counts()[counter]
        fn(*args, **kwargs)
        if fe.launch_counts()[counter] != before + 1:
            return None
        return run.cuda_ms(lambda: fn(*args, **kwargs), reps)
