"""Rank programs of tests/test_torch_parallel.py and tests/test_torch_nojax.py.

``parallel.dryrun.launch`` runs a program on every spawned rank as
``program(mesh, *args)``, so each lives in a module the ranks can import;
it imports torch, numpy and the port only.  Inputs arrive in an ``.npz``
file and rank 0 writes the gathered results beside it, leaf by leaf.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, RegistrationConfig
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu_torch.parallel import dryrun
from cylinder_pose_estimation_tpu_torch.parallel.mesh import frame_slice, gather_frames
from cylinder_pose_estimation_tpu_torch.parallel.sharding import shard_map_pose, sharded_pipeline
from cylinder_pose_estimation_tpu_torch.types import GridPoints, stereo_from_numpy

# The slice's configuration at 192x256 (tests/test_parallel.py's).
H, W = 192, 256


def slice_configs(use_pallas: bool):
    return (CylinderDetectConfig(height=H, width=W, use_pallas=use_pallas, cc_iters=8, min_ok_points=5,
                                 drop_first_row=False, drop_last_col=False),
            FitConfig(cyl_radius=55.0, lm_iters=40),
            RegistrationConfig(cyl_radius=55.0, lm_iters=10, min_frame_points=5))


def save_tree(path: str, **trees) -> None:
    """Each tree's leaves as ``<name>.<index>`` host arrays."""
    out = {}
    for name, tree in trees.items():
        for i, x in enumerate(pipeline._tree_leaves(tree)):
            out[f"{name}.{i}"] = x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    np.savez(path, **out)


def _stereo(d, device):
    return stereo_from_numpy(*[d[f"stereo{i}"] for i in range(7)], device=device)


def fit_program(mesh, path: str) -> dict:
    """The fit stage: each rank fits its block of the grid points in
    ``path`` (gp1_*/gp2_* leaves, frames first), the results all-gathered."""
    torch.set_num_threads(1)
    d = np.load(path)
    start, stop = frame_slice(mesh, d["gp1_xy"].shape[0])

    def gp(view):
        return GridPoints(*[torch.as_tensor(d[f"{view}_{k}"][start:stop]) for k in GridPoints._fields])

    fit = fit_single_cylinder(gp("gp1"), gp("gp2"), _stereo(d, mesh.device), FitConfig(cyl_radius=55.0,
                                                                                       lm_iters=30))
    fit = gather_frames(fit, mesh)
    if mesh.rank == 0:
        save_tree(path.replace(".npz", ".out.npz"), fit=fit)
    return {"rank": mesh.rank, "digest": dryrun.digest(fit)}


def slice_program(mesh, path: str, use_pallas: bool, chunk: int) -> dict:
    """The slice on the frames in ``path``: the sharded pipeline and
    ``shard_map_pose`` on (i1, i2, angles), and the stream of (s1, s2) at
    ``chunk``, compact and full, with the overlap on and off."""
    torch.set_num_threads(1)
    d = np.load(path)
    stereo = _stereo(d, mesh.device)
    cfg, fit_cfg, reg_cfg = slice_configs(use_pallas)
    batch, reg = sharded_pipeline(mesh, stereo, cfg, fit_cfg, reg_cfg)(d["i1"], d["i2"], d["angles"])
    local = shard_map_pose(mesh, stereo, cfg, fit_cfg)(d["i1"], d["i2"])
    start, stop = frame_slice(mesh, d["i1"].shape[0])
    streams = [pipeline.estimate_poses_stream(d["s1"], d["s2"], stereo, cfg, fit_cfg, chunk=chunk,
                                              compact=compact, overlap=overlap, reg_cfg=reg_cfg, mesh=mesh)
               for compact in (True, False) for overlap in (True, False)]
    regs = gather_frames(reg.t_cam_agv[None], mesh)
    if mesh.rank == 0:
        save_tree(path.replace(".npz", ".out.npz"), batch=batch, reg=reg, compact_overlap=streams[0],
                  compact_serial=streams[1], full_overlap=streams[2], full_serial=streams[3])
    return {"rank": mesh.rank, "digest": [dryrun.digest(x) for x in (batch, reg, *streams)],
            "t_cam_agv_ranks_equal": bool(all(torch.equal(regs[0], t) for t in regs)),
            "shard_map_equal": not dryrun.differing(local, pipeline._tree_map(lambda x: x[start:stop], batch))}


def failing_program(mesh) -> dict:
    """Rank 1 raises; the others wait for it in a collective."""
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    gather_frames(torch.zeros(1), mesh)
    return {"rank": mesh.rank}


def sleeping_program(mesh, seconds: float) -> dict:
    """Every rank sleeps past the launch's time limit."""
    time.sleep(seconds)
    return {"rank": mesh.rank}
