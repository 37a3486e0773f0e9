"""End-to-end pipelines: stereo images in, cylinder poses and T_Cam_AGV out
(port of the JAX package's models/pipeline.py).

* ``estimate_pose_stereo`` / ``estimate_poses_batch``: detect both views,
  correspond, triangulate, fit, for one frame or a batch of frames.
* ``preprocess_stereo_batch``: undistort + adapthisteq of raw frames.
* ``frame_health`` / ``register_sequence`` / ``full_experiment``: the whole
  exp_gridDetection.m experiment, ending in the multi-frame AGV registration.
* ``estimate_poses_stream``: a long sequence through fixed-size chunks in
  bounded device memory, with the upload of chunk k+1 and the readback of
  chunk k-1 overlapped with the compute of chunk k.
"""

from __future__ import annotations

import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.config import DetectConfig, FitConfig, RegistrationConfig
from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu_torch.ops.clahe import preprocess_stereo
from cylinder_pose_estimation_tpu_torch.ops.linalg import exact_float32
from cylinder_pose_estimation_tpu_torch.types import (
    CameraModel,
    CylinderFitResult,
    DetectResult,
    GridPoints,
    RegistrationResult,
    StereoParams,
)


class StereoPoseResult(NamedTuple):
    detect1: DetectResult
    detect2: DetectResult
    fit: CylinderFitResult


def _split(det: DetectResult, f: int):
    first = type(det)(*[_slice(x, slice(0, f)) for x in det])
    second = type(det)(*[_slice(x, slice(f, None)) for x in det])
    return first, second


def _slice(x, sl):
    if isinstance(x, GridPoints):
        return GridPoints(*[t[sl] for t in x])
    return x[sl]


@torch.inference_mode()
def estimate_poses_batch(
    images1: torch.Tensor,
    images2: torch.Tensor,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    probe: str | None = None,
):
    """Detect both views of F frames as one (2F,) batch, then fit each frame.

    images1/images2: (F, H, W) or (F, H, W, 3) on the device the work should
    run on.  ``probe="detect"`` returns the stacked (2F,) DetectResult right
    after detection (the detect-only split of the timing)."""
    exact_float32()
    f = images1.shape[0]
    det = detect_grid(torch.cat([images1, images2], dim=0), detect_cfg)
    if probe == "detect":
        return det
    d1, d2 = _split(det, f)
    fit = fit_single_cylinder(d1.grid, d2.grid, stereo, fit_cfg)
    return StereoPoseResult(detect1=d1, detect2=d2, fit=fit)


def estimate_pose_stereo(
    image1: torch.Tensor,
    image2: torch.Tensor,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
) -> StereoPoseResult:
    """One stereo frame (H, W) -> StereoPoseResult without a frame axis."""
    res = estimate_poses_batch(image1[None], image2[None], stereo, detect_cfg, fit_cfg)

    def first(x):
        return _slice(x, 0)

    return StereoPoseResult(
        detect1=type(res.detect1)(*[first(x) for x in res.detect1]),
        detect2=type(res.detect2)(*[first(x) for x in res.detect2]),
        fit=type(res.fit)(*[x[0] for x in res.fit]),
    )


def preprocess_stereo_batch(
    images1: torch.Tensor,
    images2: torch.Tensor,
    stereo: StereoParams,
    tiles: int = 8,
    clip_limit: float = 0.01,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Undistort (cubic) + adaptive histogram equalisation of both views of
    (F, H, W) or (F, H, W, 3) frames as one batch per view (ref
    utils/preProcessing.m:4-21; adapthisteq defaults 8x8 tiles, clip 0.01)."""
    with torch.inference_mode():
        return preprocess_stereo(images1, images2, stereo.cam1, stereo.cam2,
                                 tiles=tiles, clip_limit=clip_limit)


def _tree_map(fn, *trees):
    """Apply fn leaf-wise over equal NamedTuple trees of tensors / arrays."""
    first = trees[0]
    if isinstance(first, tuple):
        return type(first)(*[_tree_map(fn, *leaves) for leaves in zip(*trees)])
    return fn(*trees)


def _tree_leaves(tree) -> list:
    """The leaves of a NamedTuple tree, depth first."""
    if isinstance(tree, tuple):
        return [x for leaf in tree for x in _tree_leaves(leaf)]
    return [tree]


class StreamPoseSummary(NamedTuple):
    """Compact per-frame serving output of the stream (~200 B/frame): what a
    pose-serving deployment returns instead of the ~28 KB/frame
    StereoPoseResult."""

    params0: torch.Tensor             # (F, 6)
    params: torch.Tensor              # (F, 6)
    fvals: torch.Tensor               # (F, 2)
    t_cam_cyl: torch.Tensor           # (F, 4, 4)
    mean_reproj_error: torch.Tensor   # (F,)
    n_points: torch.Tensor            # (F,) int32 triangulated points in the fit
    ok: torch.Tensor                  # (F,) both views detected a usable grid
    stable: torch.Tensor              # (F,) both views stable
    bridged_components: torch.Tensor  # (F,) int32, summed over both views
    healthy: torch.Tensor             # (F,) frame_health mask
    center1: torch.Tensor             # (F, 2) view-1 grid origin
    center2: torch.Tensor             # (F, 2)


def _summarize_batch(batch: StereoPoseResult, reg_cfg: RegistrationConfig) -> StreamPoseSummary:
    fit = batch.fit
    return StreamPoseSummary(
        params0=fit.params0,
        params=fit.params,
        fvals=fit.fvals,
        t_cam_cyl=fit.t_cam_cyl,
        mean_reproj_error=fit.mean_reproj_error,
        n_points=torch.sum(fit.points_valid, dim=-1, dtype=torch.int32),
        ok=batch.detect1.ok & batch.detect2.ok,
        stable=batch.detect1.stable & batch.detect2.stable,
        bridged_components=batch.detect1.bridged_components + batch.detect2.bridged_components,
        healthy=frame_health(batch, reg_cfg),
        center1=batch.detect1.grid.center,
        center2=batch.detect2.grid.center,
    )


def _stereo_to(stereo: StereoParams, device: torch.device) -> StereoParams:
    def to(x):
        return None if x is None else x.to(device)

    def cam(c: CameraModel) -> CameraModel:
        return CameraModel(*[to(x) for x in c])

    return StereoParams(cam(stereo.cam1), cam(stereo.cam2),
                        *[to(x) for x in stereo[2:]])


class _Uploader:
    """Host chunk -> device tensors.  On a CUDA device, each chunk is copied
    into one of two pinned host buffers per view and from there to a fresh
    device tensor with ``non_blocking=True`` on a side stream; ``upload``
    returns the tensors and an event recorded after the copy, on which the
    compute stream must wait.  A pinned buffer is refilled only once the
    event of its previous copy has completed.  On the CPU the chunk is the
    tensor itself."""

    def __init__(self, device: torch.device, shape, dtype: np.dtype):
        self.device = device
        self.cuda = device.type == "cuda"
        if self.cuda:
            tdtype = torch.from_numpy(np.zeros(0, dtype)).dtype
            self.stream = torch.cuda.Stream(device=device)
            self.pinned = [[torch.empty(shape, dtype=tdtype, pin_memory=True) for _ in range(2)]
                           for _ in range(2)]
            self.freed = [None, None]
            self.slot = 0

    def upload(self, a: np.ndarray, b: np.ndarray):
        if not self.cuda:
            return torch.tensor(a), torch.tensor(b), None
        # current_device is per thread: name the device for this thread.
        with torch.cuda.device(self.device):
            slot = self.slot
            self.slot ^= 1
            if self.freed[slot] is not None:
                self.freed[slot].synchronize()
            outs = []
            with torch.cuda.stream(self.stream):
                for view, arr in enumerate((a, b)):
                    buf = self.pinned[view][slot]
                    buf.copy_(torch.from_numpy(arr))
                    outs.append(buf.to(self.device, non_blocking=True))
                done = torch.cuda.Event()
                done.record(self.stream)
            self.freed[slot] = done
            return outs[0], outs[1], done


def estimate_poses_stream(
    images1,
    images2,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    chunk: int = 64,
    compact: bool = False,
    overlap: bool = True,
    reg_cfg: RegistrationConfig = RegistrationConfig(),
    mesh=None,
    device=None,
):
    """Bounded-device-memory ``estimate_poses_batch`` over a long sequence.

    images1/images2: (N, H, W) host arrays (numpy, memmap or anything that
    slices into numpy).  Frames go through fixed-size ``chunk`` slices on
    ``device`` (default: the device of ``stereo``); the tail chunk is padded
    by repeating its last frame, so every chunk has the same shape, and the
    padding is dropped from the result.  Every chunk is uploaded to
    ``device``; a CUDA device that cannot run raises.

    ``compact=True`` reduces each chunk on the device to a
    StreamPoseSummary before readback (the serving configuration); otherwise
    the full StereoPoseResult comes back.  Returns that NamedTuple of host
    numpy arrays.

    ``overlap=True`` runs a three-deep pipeline: an uploader thread stages
    chunk k+1 (pinned buffers, side-stream copy) while chunk k computes, the
    readback of chunk k into pinned host memory is started, and chunk k-1 is
    materialised.  Device memory holds about three chunks.
    ``overlap=False`` runs one chunk at a time.  Either way each chunk's
    result is that of ``estimate_poses_batch`` on the same frames.

    ``mesh`` (a ``parallel.mesh.FrameMesh``): multi-device serving, the
    stream running on every rank of the mesh with the same arguments.  Each
    chunk (its tail padded first) splits into ``mesh.size`` blocks; each
    rank loads, uploads and computes only its block on ``mesh.device``,
    then all-gathers the chunk's result (the summary when ``compact``), so
    every rank returns the whole sequence.  ``chunk`` must be divisible by
    the mesh size."""
    n = images1.shape[0]
    if n == 0:
        raise ValueError("estimate_poses_stream needs at least one frame")
    lo, hi = 0, chunk
    if mesh is not None:
        from cylinder_pose_estimation_tpu_torch.parallel.mesh import FrameMesh, frame_slice, gather_frames

        if not isinstance(mesh, FrameMesh):
            raise TypeError(f"estimate_poses_stream: mesh must be a FrameMesh (parallel.mesh.make_mesh), "
                            f"not {type(mesh).__name__}")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"estimate_poses_stream: device {device} is not the mesh's {mesh.device}")
        device = mesh.device
        lo, hi = frame_slice(mesh, chunk)
    device = torch.device(stereo.t_c2_c1.device if device is None else device)
    stereo = _stereo_to(stereo, device)

    def load(s):
        """Frames [s + lo, s + hi) of the chunk at s, past the sequence's end
        repeating its last frame."""
        a0, a1 = min(s + lo, n), min(s + hi, n)
        src = slice(a0, a1) if a1 > a0 else slice(n - 1, n)
        a = np.ascontiguousarray(images1[src])
        b = np.ascontiguousarray(images2[src])
        if not (a.flags.writeable and b.flags.writeable):
            a, b = a.copy(), b.copy()
        pad = hi - lo - a.shape[0]
        if pad:
            a = np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            b = np.concatenate([b, np.repeat(b[-1:], pad, axis=0)])
        return a, b, min(chunk, n - s)

    def stage(s):
        a, b, live = first if s == 0 else load(s)
        return (*uploader.upload(a, b), live)

    def step(da, db, ready):
        if ready is not None:
            compute = torch.cuda.current_stream(device)
            compute.wait_event(ready)
            da.record_stream(compute)
            db.record_stream(compute)
        batch = estimate_poses_batch(da, db, stereo, detect_cfg, fit_cfg)
        r = _summarize_batch(batch, reg_cfg) if compact else batch
        return r if mesh is None else gather_frames(r, mesh)

    def start_readback(r):
        if device.type != "cuda":
            return r, None
        host = _tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         .copy_(x, non_blocking=True), r)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return host, done

    def materialise(pending):
        host, done, live = pending
        if done is not None:
            done.synchronize()
        return _tree_map(lambda x: x[:live].numpy(), host)

    starts = list(range(0, n, chunk))
    outs = []
    with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        # The pinned buffers and the side stream belong to this device.
        first = load(0)
        uploader = _Uploader(device, first[0].shape, first[0].dtype)
        if overlap:
            pending = None
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(stage, starts[0])
                for i in range(len(starts)):
                    da, db, ready, live = fut.result()
                    if i + 1 < len(starts):
                        fut = ex.submit(stage, starts[i + 1])
                    r = step(da, db, ready)
                    # Start chunk k's readback, then materialise chunk k-1
                    # while chunk k computes and chunk k+1 uploads.
                    host, done = start_readback(r)
                    if pending is not None:
                        outs.append(materialise(pending))
                    pending = (host, done, live)
            outs.append(materialise(pending))
        else:
            for s in starts:
                da, db, ready, live = stage(s)
                outs.append(materialise((*start_readback(step(da, db, ready)), live)))
    return _tree_map(lambda *xs: np.concatenate(xs, axis=0), *outs)


def frame_health(batch: StereoPoseResult, reg_cfg: RegistrationConfig = RegistrationConfig()
                 ) -> torch.Tensor:
    """(F,) mask of frames whose detection and fit are trustworthy: both views
    detected a usable, stable grid, enough points triangulated, the fit is
    finite and the correspondences reproject within the limit."""
    fit = batch.fit
    n_pts = torch.sum(fit.points_valid, dim=-1)
    finite = torch.all(torch.isfinite(fit.params), dim=-1)
    return (
        batch.detect1.ok
        & batch.detect2.ok
        & batch.detect1.stable
        & batch.detect2.stable
        & (n_pts >= reg_cfg.min_frame_points)
        & finite
        & (fit.mean_reproj_error <= reg_cfg.max_frame_reproj_px)
    )


def register_sequence(
    batch: StereoPoseResult,
    angles: torch.Tensor,
    reg_cfg: RegistrationConfig = RegistrationConfig(),
) -> RegistrationResult:
    """Multi-frame camera<->AGV registration of a batched pose result (ref
    exp_gridDetection.m:87 fitCylinderWPts3sAngs) with unhealthy frames
    masked out (all frames if fewer than 2 are healthy).  ``angles`` (F, 2)
    [pan, tilt] in radians, on the device of the batch."""
    return fit_cylinders_with_angles(
        batch.fit.points3,
        batch.fit.points_valid,
        angles,
        reg_cfg,
        frame_valid=frame_health(batch, reg_cfg),
    )


def full_experiment(
    images1: torch.Tensor,
    images2: torch.Tensor,
    angles: torch.Tensor,
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    reg_cfg: RegistrationConfig = RegistrationConfig(),
    preprocess: bool = False,
) -> Tuple[StereoPoseResult, RegistrationResult]:
    """The whole exp_gridDetection.m: F stereo pairs + pan/tilt angles ->
    per-frame poses + T_Cam_AGV, on the device of the inputs.
    ``preprocess=True`` first undistorts and equalises raw frames (ref
    utils/preProcessing.m:4-21)."""
    if preprocess:
        images1, images2 = preprocess_stereo_batch(images1, images2, stereo)
    batch = estimate_poses_batch(images1, images2, stereo, detect_cfg, fit_cfg)
    reg = register_sequence(batch, angles, reg_cfg)
    return batch, reg
