"""bridge_split_roofline (%): the least time of one
``ops.frontend.bridge_morphology`` call (kernel 2.3) on its split route,
at the cell's bridge site (2B views x 2 bool masks on the half-res
canvas), over its device time by CUDA events over many calls.  The
call's arguments are the detector's own on the cell's first batch
(``common.sites``); the least time is its bytes (``common.route_bytes``:
the bool mask and expandable pixels read once, the bridged bool mask
written once) over the card's peak bandwidth.  Nothing to read unless the
timed call took the split route (``kernel.bridge_morphology.split``)."""

from bench_h100.common import roofline, route_bytes, sites


def read(run):
    d = run.driver
    if d.entry != "batch" or not d.detect_cfg.use_pallas:
        return None
    calls = sites.sites(run)["bridge_morphology"]
    if not calls:
        return None
    ms = sites.route_ms(run, "bridge_morphology", "split", calls[-1])
    if ms is None:
        return None
    import torch

    n, h, w = calls[-1][0][0].shape
    return roofline.bandwidth_share(route_bytes.bridge_morphology_bytes(n, h, w), ms,
                                    torch.cuda.get_device_name(0))
