"""Dry run of frame-parallel serving over N ranks (the port's counterpart of
the JAX package's multi-chip dry run).

    python -m cylinder_pose_estimation_tpu_torch.parallel.dryrun --ranks 2 --device cpu
    python -m cylinder_pose_estimation_tpu_torch.parallel.dryrun --ranks 4 --device cuda
    python -m cylinder_pose_estimation_tpu_torch.parallel.dryrun --ranks 2 --device cuda --ranks-per-card 2

``launch`` starts N rank processes with the ``spawn`` method (CUDA cannot
fork), joins them into one group through a ``FileStore`` in a temporary
directory (no TCP port, so concurrent runs never collide) and runs a
program on each rank's FrameMesh.  The backend follows the devices: gloo on
the CPU, NCCL with one rank per card, gloo again when several ranks share a
card (``--ranks-per-card``: the check mode).  A rank that raises, or a run
past its time limit, fails the launch; the other ranks are stopped.

``check``, the dry run's program, runs what the JAX dry run runs on its
192x256 scenes (``cc_iters=8``, ``min_ok_points=5``, ``lm_iters=10``) on the
kernel branch (``use_pallas=True``; the plain versions on the CPU), one
frame per rank: ``sharded_pipeline``, ``shard_map_pose`` and a two-chunk
``estimate_poses_stream(mesh=...)``.  Every rank must return the same whole
result, each rank's ``shard_map_pose`` block must equal its slice of it,
and the ranks' T_Cam_AGV must agree.  Rank 0 runs the same work unsharded,
and ``held`` holds the sharded results to it by the card's contract
(integer and bool leaves equal, points and centres within 0.05 px, fit
parameters within 0.05, reprojection within 0.01 px), counting the leaves
and frames that differ: the float32 arithmetic of the batched stages depends
on the batch size (one frame per rank against all of them).  The
registration must meet the experiment's contract against the unsharded one
(predicted axes within 0.05 deg and 0.1 mm, fval within rel 1e-2) where
the unsharded one is well posed; an ill-posed solve has no answer to hold
it to, so it is only reported (the JAX dry run's scenes, at one frame per
rank, give 0 healthy frames and an ill-posed registration).  The script prints one JSON line and exits non-zero on any mismatch
or failed rank.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing as mp
import multiprocessing.connection
import os
import sys
import tempfile
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from cylinder_pose_estimation_tpu_torch.parallel.mesh import TIMEOUT, make_mesh

# Launch time limit (seconds) of the dry run's own program.
LAUNCH_TIMEOUT = 900.0


def _rank_main(rank, ranks, store_path, devices, backend, program, args, out_dir):
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        store = dist.FileStore(store_path, ranks)
        kw = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=store, rank=rank, world_size=ranks, timeout=TIMEOUT, **kw)
        result = program(make_mesh(devices=devices, backend=backend), *args)
        dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(result, f)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as f:
            f.write(traceback.format_exc())
        sys.stdout.flush()
        os._exit(1)  # skip interpreter teardown: a peer may still hold the group


def launch(program, args=(), ranks: int = 2, device: str = "cpu", ranks_per_card: int = 1,
           timeout: float = LAUNCH_TIMEOUT) -> list:
    """Run ``program(mesh, *args)`` on ``ranks`` spawned processes and return
    each rank's result (JSON values) in rank order.  ``program`` and
    ``args`` must pickle (a module-level function).  Raises RuntimeError when
    a rank fails or the run passes ``timeout`` seconds."""
    if device == "cpu":
        devices, backend = ["cpu"] * ranks, "gloo"
    elif device == "cuda":
        # Card r // ranks_per_card; ranks sharing a card (the check mode) need gloo.
        devices = [f"cuda:{r // ranks_per_card}" for r in range(ranks)]
        backend = "nccl" if ranks_per_card == 1 else "gloo"
    else:
        raise ValueError(f"device {device!r}: cpu or cuda")
    if device == "cuda":
        cards = -(-ranks // ranks_per_card)
        if torch.cuda.device_count() < cards:
            raise RuntimeError(f"{ranks} ranks at {ranks_per_card} per card need {cards} CUDA devices; "
                               f"{torch.cuda.device_count()} found")
        from cylinder_pose_estimation_tpu_torch.ops import kernels

        kernels.build()  # once here; every rank loads the same library
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="cpe_dryrun_") as tmp:
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, ranks, os.path.join(tmp, "store"), devices, backend, program, args, tmp))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        try:
            live = list(procs)
            while live:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"dry run: ranks {[procs.index(p) for p in live]} still running "
                                       f"after {timeout:.0f} s")
                mp.connection.wait([p.sentinel for p in live], timeout=left)
                for p in [p for p in live if not p.is_alive()]:
                    p.join()
                    live.remove(p)
                    if p.exitcode != 0:
                        r = procs.index(p)
                        err = os.path.join(tmp, f"rank{r}.err")
                        tb = open(err).read() if os.path.exists(err) else ""
                        raise RuntimeError(f"dry run: rank {r} exited with code {p.exitcode}\n{tb}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                p.join()
        out = []
        for r in range(ranks):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                out.append(json.load(f))
    return out


def _leaves(tree) -> list:
    """(path, host array) of every leaf that is not None."""
    from cylinder_pose_estimation_tpu_torch.parallel.mesh import _flatten

    return [(p, np.asarray(x.cpu()) if isinstance(x, torch.Tensor) else np.asarray(x))
            for p, x in _flatten(tree) if x is not None]


def digest(tree) -> str:
    """SHA-256 of a tree's leaves (shape, dtype and bytes)."""
    h = hashlib.sha256()
    for _, x in _leaves(tree):
        h.update(repr((x.shape, str(x.dtype))).encode())
        h.update(np.ascontiguousarray(x).tobytes())
    return h.hexdigest()


def differing(got, want) -> dict:
    """Leaves of two trees of one structure that differ, by path: the number
    of frames (rows of the leading axis) that differ, -1 for another shape or
    dtype; NaN equals NaN."""
    out = {}
    for (path, g), (_, w) in zip(_leaves(got), _leaves(want)):
        if g.shape != w.shape or g.dtype != w.dtype:
            out[path] = -1
            continue
        eq = np.equal(g, w) | (np.isnan(g) & np.isnan(w)) if np.issubdtype(w.dtype, np.floating) else g == w
        bad = ~eq.reshape(eq.shape[0], -1).all(-1) if eq.ndim else ~eq[None]
        if bad.any():
            out[path] = int(bad.sum())
    return out


# The card's contract for per-frame results (chip_smoke phase 2's, the
# golden fixtures'): every integer and bool leaf (ids, validity, ok, stable,
# health, counts) equal, grid points and centres within 0.05 px, and on the
# healthy frames (``frame_health``: those the registration uses) fit
# parameters within 0.05 (the axis direction rescaled to the reference's
# norm, the origin measured across the reference's axis line: the LM's
# objective sees neither the direction's length nor where the origin sits
# along the axis) and reprojection within 0.01 px.  The other float leaves,
# and the fits of unhealthy frames, are counted and bounded, not gated.
XY_PX, PARAMS_ABS, REPROJ_PX = 0.05, 0.05, 0.01
XY_LEAVES = ("xy", "center", "center1", "center2")
PARAM_LEAVES = ("params", "params0")


def param_gap(g: np.ndarray, w: np.ndarray, frames) -> dict:
    """Gaps between (F, 6) cylinder parameters (origin, direction): the
    direction's largest component difference at the reference's norm, the
    axis angle (rad) and the origin's distance from the reference's axis
    line (mm), each the largest over ``frames`` (a mask; 0 if none)."""
    if not frames.any():
        return {"direction": 0.0, "axis_rad": 0.0, "perp_mm": 0.0}
    g, w = g[frames].astype(np.float64), w[frames].astype(np.float64)
    dw = w[:, 3:6] / np.linalg.norm(w[:, 3:6], axis=-1, keepdims=True)
    dg = g[:, 3:6] / np.linalg.norm(g[:, 3:6], axis=-1, keepdims=True)
    scale = np.linalg.norm(w[:, 3:6], axis=-1, keepdims=True)
    rel = g[:, :3] - w[:, :3]
    perp = rel - np.sum(rel * dw, -1, keepdims=True) * dw
    return {"direction": float(np.max(np.abs(dg * scale - w[:, 3:6]))),
            "axis_rad": float(np.max(np.arccos(np.clip(np.abs(np.sum(dg * dw, -1)), 0.0, 1.0)))),
            "perp_mm": float(np.max(np.linalg.norm(perp, axis=-1)))}


def held(got, want) -> dict:
    """``got`` against ``want``, per-frame results of one structure, by the
    card's contract above: ``ok``, the differing leaves (frames that
    differ), each one's largest absolute difference (None for an integer or
    bool leaf), the parameter leaves' gaps (``param_gap``) and the fits'
    largest fval relative difference."""
    from cylinder_pose_estimation_tpu_torch.models.pipeline import frame_health

    diff = differing(got, want)
    gl, wl = dict(_leaves(got)), dict(_leaves(want))
    healthy = want.healthy if hasattr(want, "healthy") else frame_health(want)
    healthy = np.asarray(healthy.cpu() if isinstance(healthy, torch.Tensor) else healthy)
    out = {"ok": True, "differing": diff, "max_abs": {}, "healthy": int(healthy.sum())}
    for path, n in diff.items():
        g, w, name = gl[path], wl[path], path.split(".")[-1]
        if n < 0 or not np.issubdtype(w.dtype, np.floating):
            out["ok"], out["max_abs"][path] = False, None
            continue
        d = np.where(np.isnan(g) & np.isnan(w), 0.0, np.abs(g.astype(np.float64) - w.astype(np.float64)))
        out["max_abs"][path] = float(np.max(d))
        if name in PARAM_LEAVES:
            gap = out[path] = param_gap(g, w, healthy)
            out[f"{path} unhealthy"] = param_gap(g, w, ~healthy)
            out["ok"] &= gap["direction"] < PARAMS_ABS and gap["perp_mm"] < PARAMS_ABS
        elif name in XY_LEAVES:
            out["ok"] &= out["max_abs"][path] < XY_PX
        elif name == "mean_reproj_error":
            out["ok"] &= float(np.max(d[healthy], initial=0.0)) < REPROJ_PX
        elif name == "fvals":
            out["fval_rel"] = float(np.max(d / np.maximum(np.abs(w), 1e-30)))
    return out


def scene(ranks: int):
    """The JAX dry run's input at this mesh size: the bench family at
    192x256, one frame per rank, its pan/tilt angles, and the stream's two
    chunks (the frames, then the same frames reversed)."""
    from cylinder_pose_estimation_tpu_torch.utils.synthetic import example_pair

    stereo, (i1, i2) = example_pair(192, 256, n_frames=ranks)
    angles = np.stack([np.linspace(-0.4, 0.4, ranks), np.linspace(0.1, -0.1, ranks)], -1).astype(np.float32)
    s1 = np.concatenate([i1, i1[::-1]]).astype(np.uint8)
    s2 = np.concatenate([i2, i2[::-1]]).astype(np.uint8)
    return stereo, i1, i2, angles, s1, s2


def check(mesh) -> dict:
    """The dry run's program on one rank; see the module docstring."""
    from cylinder_pose_estimation_tpu_torch.config import CylinderDetectConfig, FitConfig, RegistrationConfig
    from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors
    from cylinder_pose_estimation_tpu_torch.models import pipeline
    from cylinder_pose_estimation_tpu_torch.parallel.mesh import frame_slice, gather_frames
    from cylinder_pose_estimation_tpu_torch.parallel.sharding import shard_map_pose, sharded_pipeline
    from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy

    if mesh.device.type == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    st_np, i1, i2, angles, s1, s2 = scene(mesh.size)
    stereo = stereo_from_numpy(*st_np, device=mesh.device)
    cfg = CylinderDetectConfig(height=192, width=256, use_pallas=True, cc_iters=8, min_ok_points=5)
    fit_cfg, reg_cfg = FitConfig(lm_iters=10), RegistrationConfig(lm_iters=10)
    batch, reg = sharded_pipeline(mesh, stereo, cfg, fit_cfg, reg_cfg)(i1, i2, angles)
    regs = gather_frames(reg.t_cam_agv[None], mesh)
    local = shard_map_pose(mesh, stereo, cfg, fit_cfg)(i1, i2)
    start, stop = frame_slice(mesh, i1.shape[0])
    stream = pipeline.estimate_poses_stream(s1, s2, stereo, cfg, fit_cfg, chunk=mesh.size, compact=True,
                                            mesh=mesh)
    out = {"rank": mesh.rank, "device": str(mesh.device), "backend": mesh.backend,
           "digest": [digest(batch), digest(reg), digest(stream)],
           "t_cam_agv_ranks_equal": bool(all(torch.equal(regs[0], t) for t in regs)),
           "shard_map_equal": not differing(local, pipeline._tree_map(lambda x: x[start:stop], batch)),
           "ok": int(stream.ok.sum()), "frames": int(stream.ok.shape[0])}
    if mesh.rank == 0:
        d1 = torch.as_tensor(i1, device=mesh.device)
        d2 = torch.as_tensor(i2, device=mesh.device)
        ang = torch.as_tensor(angles, device=mesh.device)
        ref_batch, ref_reg = pipeline.full_experiment(d1, d2, ang, stereo, cfg, fit_cfg, reg_cfg)
        ref_stream = pipeline.estimate_poses_stream(s1, s2, stereo, cfg, fit_cfg, chunk=mesh.size,
                                                    compact=True, device=mesh.device)
        ang_err, perp = axis_errors(ref_reg.t_cam_agv.cpu().numpy(), reg.t_cam_agv.cpu().numpy(), angles)
        fval_rel = abs(float(reg.fval) - float(ref_reg.fval)) / max(abs(float(ref_reg.fval)), 1e-12)
        out["unsharded"] = {"batch": held(batch, ref_batch), "stream": held(stream, ref_stream),
                            "registration": {"differing": differing(reg, ref_reg), "axis_deg": float(ang_err.max()),
                                             "perp_mm": float(perp.max()), "fval_rel": fval_rel,
                                             "well_posed": bool(ref_reg.well_posed),
                                             "ok": bool(not ref_reg.well_posed or (
                                                 ang_err.max() < 0.05 and perp.max() < 0.1
                                                 and fval_rel <= 1e-2))}}
        out["fval"] = float(reg.fval)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--ranks-per-card", type=int, default=1)
    a = ap.parse_args(argv)
    t0 = time.perf_counter()
    try:
        results = launch(check, ranks=a.ranks, device=a.device, ranks_per_card=a.ranks_per_card)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "ranks": a.ranks, "device": a.device, "error": str(e)[-4000:]}))
        return 1
    r0 = results[0]
    ref = r0["unsharded"]
    ranks_agree = all(r["digest"] == r0["digest"] for r in results)
    ok = (ranks_agree and all(r["t_cam_agv_ranks_equal"] and r["shard_map_equal"] for r in results)
          and ref["batch"]["ok"] and ref["stream"]["ok"] and ref["registration"]["ok"])
    print(json.dumps({"ok": ok, "ranks": a.ranks, "device": a.device, "ranks_per_card": a.ranks_per_card,
                      "backend": r0["backend"], "devices": [r["device"] for r in results],
                      "frames": r0["frames"], "stream_ok": r0["ok"], "fval": r0["fval"],
                      "ranks_agree": ranks_agree, "unsharded": ref,
                      "seconds": round(time.perf_counter() - t0, 2)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
