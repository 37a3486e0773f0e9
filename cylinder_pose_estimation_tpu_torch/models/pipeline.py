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
* ``compiled_batch`` / ``_stream_step`` / the registration step: the JAX
  package's compile-once, dispatch-once steps.  On a CUDA device each is one
  ``torch.cuda.CUDAGraph`` per input shape, dtype and device.  The first
  call with a key is the eager call, so a one-shot caller (the CLI's
  ``experiment``, one ``full_experiment``) pays no capture; the second is an
  eager warm-up on a side stream, a capture into static buffers and a
  replay; every later call copies into the static inputs and replays (no
  host round trip, none of the ~10^4 per-op launches of the eager call).
  On the CPU the step is the eager call.  A failed capture or replay
  raises; nothing falls back to eager on the card.  ``estimate_poses_batch``
  itself stays eager: it is what each replay is held to.
"""

from __future__ import annotations

import collections
import contextlib
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple, Tuple

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.config import DetectConfig, FitConfig, RegistrationConfig
from cylinder_pose_estimation_tpu_torch.geometry.registration import fit_cylinders_with_angles
from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid
from cylinder_pose_estimation_tpu_torch.models.pose import fit_single_cylinder
from cylinder_pose_estimation_tpu_torch.ops import kernels
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
from cylinder_pose_estimation_tpu_torch.utils import profiling


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
        leaves = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(first)(*leaves) if hasattr(first, "_fields") else tuple(leaves)
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


def _stereo_key(stereo: StereoParams) -> tuple:
    """The rig's content as a hashable key (the JAX ``_stream_step``'s
    fingerprint): bytes, shape and dtype of every leaf.  Reads the rig back
    to the host once: on a card one wait per leaf (counter
    ``sync.stereo_key``)."""
    leaves = [x for x in _tree_leaves(stereo) if x is not None]
    profiling.count("sync.stereo_key", sum(x.is_cuda for x in leaves))
    return tuple((x.detach().cpu().numpy().tobytes(), tuple(x.shape), str(x.dtype)) for x in leaves)


def _stereo_copy(stereo: StereoParams) -> StereoParams:
    """A private copy of the rig: a captured graph reads its tensors in
    every replay, so a caller's later in-place change must not reach it."""
    return _tree_map(lambda x: None if x is None else x.detach().clone(), stereo)


class _GraphStep:
    """``fn(*inputs)`` as one captured CUDA graph.

    The inputs are copied into static input buffers; one eager call runs on
    a side stream (kernel plans, ``cudaFuncSetAttribute``, the constant
    caches and cuBLAS's workspace are settled there); then the same call is
    captured into ``self.graph`` with its own memory pool, and its outputs
    are the static outputs.  A call copies its inputs into the static
    inputs, replays, and returns the static outputs, which the next replay
    overwrites: callers that hand results out clone them.  The capture is
    ``thread_local``: the stream's uploader thread may allocate pinned
    memory meanwhile.  A capture that meets a host synchronisation raises.

    ``self.launches``: the kernel wrappers' calls the capture recorded
    (``ops.kernels.launch_counts``); each replay runs those kernels again
    without the wrappers, so it adds them to the counters
    ``graph.replayed.<kernel>``.

    With tracing on (``utils.profiling``) the capture also puts timing
    events into the graph: one as its first node and one as its last
    (``self.window``), which time each replay's device ms from the graph's
    start on the card to its end, and two around each timed span inside the
    step (the detect and fit stages, ``self.stages``).  With tracing off the
    graph is the step's kernels alone."""

    def __init__(self, fn, inputs):
        dev = inputs[0].device
        self.fn = fn  # keeps the tensors the graph reads (the rig) alive
        self.inputs = [torch.empty_like(x) for x in inputs]
        for dst, x in zip(self.inputs, inputs):
            dst.copy_(x)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn(*self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        before = kernels.launch_counts()
        with profiling.graph_stages() as self.stages:
            with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
                first = profiling.device_event(self.inputs[0])
                self.outputs = fn(*self.inputs)
                self.window = (first, profiling.device_event(self.inputs[0]))
        after = kernels.launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] > before[k]}
        for k, n in self.launches.items():
            profiling.count(f"graph.captured.{k}", n)

    def __call__(self, *inputs):
        profiling.poll(owner=self)
        for dst, x in zip(self.inputs, inputs):
            dst.copy_(x)
        with profiling.span("step.launch"):
            self.graph.replay()
        if self.window[0] is not None:
            profiling.time_device(profiling.current(), *self.window, owner=self)
            profiling.replayed(self.stages, owner=self)
        for k, n in self.launches.items():
            profiling.count(f"graph.replayed.{k}", n)
        profiling.count("step.replay")
        return self.outputs


# Kernel launches seen by the compiled steps, per launch counter of
# ops.kernels, in the registry of utils/profiling: the wrapper calls their
# captures recorded (``graph.captured.<kernel>``; a capture runs no kernel)
# and those their replays ran (``graph.replayed.<kernel>``; no wrapper is
# called), and the replays (``step.replay``).  The kernels a process ran on
# the card are then kernels.launch_counts() - captured + replayed.


def graph_launch_counts() -> dict:
    """{"captured": {kernel: n}, "replayed": {kernel: n}, "replays": n}
    since the last ``reset_graph_launch_counts``."""
    out = {}
    for kind in ("captured", "replayed"):
        prefix = f"graph.{kind}."
        out[kind] = {k[len(prefix):]: n for k, n in profiling.counters(prefix).items()}
    out["replays"] = profiling.counters("step.replay").get("step.replay", 0)
    return out


def reset_graph_launch_counts() -> None:
    profiling.reset_counters("graph.")
    profiling.reset_counters("step.replay")


# One captured graph per (step, rig, configs, input shapes, dtypes, device),
# None until its key's second call, the oldest evicted first, as the JAX
# package's cache of compiled steps.
# JAX's holds 16 programs; each entry here also holds its graph's memory
# pool, the step's whole working set, which no other step can use
# (chip_smoke phase 19 prints each pool's size), so this one holds 8.
_STREAM_STEP_CACHE: collections.OrderedDict = collections.OrderedDict()
_STREAM_STEP_CACHE_SIZE = 8


def _graphs(t: torch.Tensor) -> bool:
    """Whether a step on ``t`` replays a CUDA graph: on a CUDA device."""
    return t.device.type == "cuda"


def _compiled(key: tuple, fn, inputs, fresh: bool = False, kind: str | None = None):
    """``fn(*inputs)`` as a compiled step.  On CPU tensors the eager call.
    On a CUDA device, per key, tracing flag (``utils.profiling.enabled``, so
    a graph with timing events replays only while tracing is on, and one
    without only while it is off) and these inputs' shapes, dtypes and
    device: the first call is the eager call (its entry holds no graph
    yet); the second captures the step's ``_GraphStep``; it and every later
    call return the graph's static outputs, or clones of them when
    ``fresh``.  Each call is a span ``step.<kind>`` (``kind`` defaults to
    ``key[0]``) with its ``phase`` (eager, capture or replay)."""
    name = f"step.{key[0] if kind is None else kind}"
    if not _graphs(inputs[0]):
        with profiling.span(name, phase="eager"):
            return fn(*inputs)
    full = key + (profiling.enabled(),) + tuple((tuple(x.shape), x.dtype, x.device) for x in inputs)
    if full not in _STREAM_STEP_CACHE:
        while len(_STREAM_STEP_CACHE) >= _STREAM_STEP_CACHE_SIZE:
            _STREAM_STEP_CACHE.popitem(last=False)
        _STREAM_STEP_CACHE[full] = None
        with profiling.span(name, phase="eager"):
            return fn(*inputs)
    step = _STREAM_STEP_CACHE[full]
    with profiling.span(name, phase="replay" if step is not None else "capture"):
        if step is None:
            step = _STREAM_STEP_CACHE[full] = _GraphStep(fn, inputs)
        out = step(*inputs)
    return _tree_map(torch.clone, out) if fresh else out


def compiled_batch(
    stereo: StereoParams,
    detect_cfg: DetectConfig,
    fit_cfg: FitConfig = FitConfig(),
    probe: str | None = None,
):
    """``estimate_poses_batch`` with the rig and configs fixed, as one
    compiled step: the counterpart of ``jax.jit(partial(estimate_poses_batch,
    stereo=..., detect_cfg=..., fit_cfg=...))``.  Returns ``fn(images1,
    images2)``; on CUDA tensors it replays the step's CUDA graph (captured
    at the second call of each input shape; the first is eager) and returns
    fresh tensors, on CPU tensors it is the eager call."""
    stereo = _stereo_copy(stereo)
    key = ("batch", detect_cfg, fit_cfg, probe, _stereo_key(stereo))
    kind = "batch" if probe is None else f"batch.{probe}"

    def body(a, b):
        return estimate_poses_batch(a, b, stereo, detect_cfg, fit_cfg, probe)

    def run(images1: torch.Tensor, images2: torch.Tensor):
        return _compiled(key, body, (images1, images2), fresh=True, kind=kind)

    return run


def _stream_step(stereo, detect_cfg, fit_cfg, reg_cfg, compact, mesh=None):
    """One compiled chunk step, cached across ``estimate_poses_stream``
    calls: ``fn(a, b)`` -> the chunk's StereoPoseResult, or its
    StreamPoseSummary when ``compact``.  On a CUDA device the step replays
    its CUDA graph (from its second chunk on) and returns the graph's static
    outputs (valid until the next replay of the same step; the stream reads
    them back first).  The
    rig is fixed at the call, keyed by content as in the JAX package.
    With a ``mesh`` each rank's block is its own graph and the all-gather
    (NCCL) runs after the replay, outside the graph."""
    stereo = _stereo_copy(stereo)
    # reg_cfg reaches the step only through _summarize_batch's frame_health,
    # so compact=False steps share one entry across reg_cfg values.
    key = ("stream", detect_cfg, fit_cfg, reg_cfg if compact else None, compact, _stereo_key(stereo))

    def body(a, b):
        batch = estimate_poses_batch(a, b, stereo, detect_cfg, fit_cfg)
        return _summarize_batch(batch, reg_cfg) if compact else batch

    def step(a, b):
        r = _compiled(key, body, (a, b))
        if mesh is None:
            return r
        from cylinder_pose_estimation_tpu_torch.parallel.mesh import gather_frames

        return gather_frames(r, mesh)

    return step


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
    result is that of ``estimate_poses_batch`` on the same frames: on a CUDA
    device every chunk after the first replays the compiled step
    (``_stream_step``).

    ``mesh`` (a ``parallel.mesh.FrameMesh``): multi-device serving, the
    stream running on every rank of the mesh with the same arguments.  Each
    chunk (its tail padded first) splits into ``mesh.size`` blocks; each
    rank loads, uploads and computes only its block on ``mesh.device``,
    then all-gathers the chunk's result (the summary when ``compact``), so
    every rank returns the whole sequence.  ``chunk`` must be divisible by
    the mesh size.

    Spans (``utils.profiling``) inside the loop's ``stream.call``, each
    with its ``chunk`` index: ``stream.wait_upload`` (waiting for the uploader thread's chunk),
    ``stream.step``, ``stream.wait_readback`` (waiting for the chunk's
    results on the host) and ``stream.chunk``, from the start of the
    chunk's load to the end of its materialisation."""
    n = images1.shape[0]
    if n == 0:
        raise ValueError("estimate_poses_stream needs at least one frame")
    lo, hi = 0, chunk
    if mesh is not None:
        from cylinder_pose_estimation_tpu_torch.parallel.mesh import FrameMesh, frame_slice

        if not isinstance(mesh, FrameMesh):
            raise TypeError(f"estimate_poses_stream: mesh must be a FrameMesh (parallel.mesh.make_mesh), "
                            f"not {type(mesh).__name__}")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"estimate_poses_stream: device {device} is not the mesh's {mesh.device}")
        device = mesh.device
        lo, hi = frame_slice(mesh, chunk)
    device = torch.device(stereo.t_c2_c1.device if device is None else device)
    stereo = _stereo_to(stereo, device)

    def load(i):
        """(a, b, live, i, t0): frames [s + lo, s + hi) of chunk i at s, past
        the sequence's end repeating its last frame, and when its load
        began."""
        t0 = profiling.now()
        s = starts[i]
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
        return a, b, min(chunk, n - s), i, t0

    def stage(i):
        a, b, *rest = first if i == 0 else load(i)
        return (*uploader.upload(a, b), *rest)

    compiled = _stream_step(stereo, detect_cfg, fit_cfg, reg_cfg, compact, mesh)

    def step(da, db, ready, i):
        with profiling.span("stream.step", chunk=i):
            if ready is not None:
                compute = torch.cuda.current_stream(device)
                compute.wait_event(ready)
                da.record_stream(compute)
                db.record_stream(compute)
            return compiled(da, db)

    def start_readback(r):
        if device.type != "cuda":
            return r, None
        host = _tree_map(lambda x: torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
                         .copy_(x, non_blocking=True), r)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        return host, done

    def materialise(pending):
        host, done, live, i, t0 = pending
        if done is not None:
            with profiling.span("stream.wait_readback", chunk=i):
                done.synchronize()
        out = _tree_map(lambda x: x[:live].numpy(), host)
        profiling.add("stream.chunk", t0, profiling.now(), parent=call, chunk=i)
        return out

    starts = list(range(0, n, chunk))
    outs = []
    with profiling.span("stream.call") as call, \
            torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
        # The pinned buffers and the side stream belong to this device.
        first = load(0)
        uploader = _Uploader(device, first[0].shape, first[0].dtype)
        if overlap:
            pending = None
            with ThreadPoolExecutor(max_workers=1) as ex:
                fut = ex.submit(stage, 0)
                for i in range(len(starts)):
                    with profiling.span("stream.wait_upload", chunk=i):
                        da, db, ready, live, _, t0 = fut.result()
                    if i + 1 < len(starts):
                        fut = ex.submit(stage, i + 1)
                    r = step(da, db, ready, i)
                    # Start chunk k's readback, then materialise chunk k-1
                    # while chunk k computes and chunk k+1 uploads.
                    host, done = start_readback(r)
                    if pending is not None:
                        outs.append(materialise(pending))
                    pending = (host, done, live, i, t0)
            outs.append(materialise(pending))
        else:
            for i in range(len(starts)):
                da, db, ready, live, _, t0 = stage(i)
                outs.append(materialise((*start_readback(step(da, db, ready, i)), live, i, t0)))
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
    [pan, tilt] in radians, on the device of the batch.  On a CUDA device
    the solve is a compiled step (one CUDA graph per F, N, dtype, device and
    ``reg_cfg``, replayed from the second call with them on; the first is
    eager) and returns fresh tensors."""
    inputs = (batch.fit.points3, batch.fit.points_valid, angles, frame_health(batch, reg_cfg))

    def body(pts3s, valid, ang, frame_valid):
        return fit_cylinders_with_angles(pts3s, valid, ang, reg_cfg, frame_valid=frame_valid)

    return _compiled(("registration", reg_cfg), body, inputs, fresh=True)


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
    utils/preProcessing.m:4-21; eager).  On a CUDA device the poses and the
    registration are two compiled steps: ``compiled_batch``'s, then
    ``register_sequence``'s, eager at the first call with these shapes and
    configs and replayed from the second on.  A span ``experiment`` holds
    both steps' spans (``utils.profiling``)."""
    with profiling.span("experiment"):
        if preprocess:
            images1, images2 = preprocess_stereo_batch(images1, images2, stereo)
        batch = compiled_batch(stereo, detect_cfg, fit_cfg)(images1, images2)
        reg = register_sequence(batch, angles, reg_cfg)
    return batch, reg
