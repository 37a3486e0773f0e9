"""cc_band_roofline (%): the least time of one
``ops.frontend.connected_components`` call (kernel 2.2) on its large-frame
(band) route, at the cell's warm half-res site (the final labels of the
bridged masks, warm-started from the bridge's labels: 2B views x 2 masks
on the half-res canvas), over its device time by CUDA events over many
calls.  The call's arguments are the detector's own on the cell's first
batch (``common.sites``); the least time is its bytes
(``common.route_bytes``: the float32 mask and the int32 initial labels
read once, the int32 labels written once) over the card's peak
bandwidth.  Nothing to read unless the program counts the band route
(``kernel.connected_components.band``) and the timed call took it."""

from bench_h100.common import roofline, route_bytes, sites


def read(run):
    d = run.driver
    if d.entry != "batch" or not d.detect_cfg.use_pallas:
        return None
    warm = [c for c in sites.sites(run)["connected_components"] if c[1].get("init_labels") is not None]
    if not warm:
        return None
    ms = sites.route_ms(run, "connected_components", "band", warm[-1])
    if ms is None:
        return None
    import torch

    n, h, w = warm[-1][0][0].shape
    return roofline.bandwidth_share(route_bytes.connected_components_bytes(n, h, w, warm=True), ms,
                                    torch.cuda.get_device_name(0))
