"""step_kernels.batch (kernels): kernel nodes of the B-frame step
(``estimate_poses_batch``, the body of ``compiled_batch``) captured as a
CUDA graph, counted by the benchmark's own node count."""

from bench_h100.common.graphs import graph_kernels


def read(run):
    d = run.driver
    if d.entry != "batch":
        return None
    da, db = d.upload(*d.batches[0])
    pipeline = d.p.pipeline
    return float(graph_kernels(lambda: pipeline.estimate_poses_batch(da, db, d.rig, d.detect_cfg, d.fit_cfg)))
