"""preprocess_binarize_roofline (%): the least time of one
``ops.frontend.preprocess_binarize`` call (kernel 2.1) on the cell's 2B
pre-smoothed views with the configuration's arguments, over its device
time by CUDA events over many calls.  The least time is the call's bytes
(``common.roofline``: the input plane read once, the six output planes
written once, float32) over the card's peak bandwidth: the kernel is
bandwidth-bound.  Nothing to read where the configuration runs the XLA
branch or the kernel smooths itself."""

from bench_h100.common import roofline


def read(run):
    d = run.driver
    cfg = d.detect_cfg
    if d.entry != "batch" or not cfg.use_pallas or not cfg.smooth_mxu:
        return None
    import torch

    det, fe = d.p.detector, d.p.frontend
    da, db = d.upload(*d.batches[0])
    with torch.inference_mode():
        gray = det._smooth(det._to_gray(torch.cat([da, db])), cfg)

        def call():
            return fe.preprocess_binarize(
                gray, blur_ksize=cfg.blur_ksize, ridge_sigma=cfg.ridge_sigma, pre_smoothed=True,
                sauvola_window=cfg.sauvola_window, sauvola_k=cfg.sauvola_k, sauvola_r=cfg.sauvola_r,
                min_contrast=0.05, line_len=cfg.line_kernel_len, margin=det._border_margin(cfg),
                joint_peak_iters=cfg.joint_peak_iters)

        ms = run.cuda_ms(call, 50)
    n, h, w = gray.shape
    return roofline.bandwidth_share(roofline.preprocess_binarize_bytes(n, h, w), ms,
                                    torch.cuda.get_device_name(0))
