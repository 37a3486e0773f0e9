"""PyTorch port: ``estimate_poses_stream`` on the CPU.

Over 5 uint8 frames at chunk 2 (two full chunks and a tail chunk padded by
repeating its last frame):

* the stream returns exactly what ``estimate_poses_batch`` returns on each
  chunk's padded frames, with the padding dropped: ``np.array_equal`` on
  every leaf, for ``compact`` True (the StreamPoseSummary of
  ``_summarize_batch``) and False (the full StereoPoseResult), with
  ``overlap`` True and False;
* against the JAX package (Pallas path in interpret mode): ``_summarize_batch``
  of a JAX batch result fed through the port equals JAX's own leaf for leaf
  (field names, dtypes and values), and the port's stream meets JAX's
  ``estimate_poses_stream`` on the same frames, padded tail included:
  ids, ``ok``, ``stable``, ``healthy``, ``n_points`` and
  ``bridged_components`` equal; xy and grid centres within 1e-3 px,
  reprojection within 1e-4 px, fvals within rel 1e-3 and the fitted axis
  directions within 1e-3 rad (the contract of tests/test_torch_pipeline.py;
  the fit's origin is free along the axis, so the port's axis line must
  pass within 0.01 mm of JAX's origin; 1 mm on the unhealthy frame 3, whose
  fit fails at 37 px reprojection with its origin 1 m out, where the two
  lines lie 0.62 mm apart);
* a ``mesh`` that is not a FrameMesh, a chunk that does not split over the
  mesh, and an empty sequence raise, and so does a CUDA device on a machine
  without one; over a one-rank gloo mesh the stream equals the unsharded
  stream.

The frames are ``registration_sequence``'s seed 2.  With seeds 0 and 1 the
second view of frame 3 picks another grid origin in the port than in JAX:
a column fitted through integer joint centroids lands within 2e-5 px of an
integer x, so the bound floor(x - 3) of that point's index-brightness patch
differs by one pixel, its patch mean moves by 4.5 grey levels, and it passes
a rival origin 0.4 levels away (ROADMAP section 3 counts these flips).
"""

import datetime
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_port import jax_stereo, port_stereo, to_port
from cylinder_pose_estimation_tpu.config import CylinderDetectConfig as JDetect
from cylinder_pose_estimation_tpu.config import FitConfig as JFit
from cylinder_pose_estimation_tpu.config import RegistrationConfig as JReg
from cylinder_pose_estimation_tpu.models import pipeline as jpipe
from cylinder_pose_estimation_tpu_torch.config import (
    CylinderDetectConfig,
    FitConfig,
    RegistrationConfig,
    from_reference,
)
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.parallel.mesh import FrameMesh, make_mesh
from cylinder_pose_estimation_tpu_torch.utils.synthetic import (
    TiledFrames,
    registration_angles,
    registration_sequence,
)

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

H, W, N, CHUNK = 240, 320, 5, 2
CFG = CylinderDetectConfig(height=H, width=W, use_pallas=True, min_ok_points=10)
FIT = FitConfig(cyl_radius=70.0)
REG = RegistrationConfig(cyl_radius=70.0, min_frame_points=5)
JCFG = JDetect(height=H, width=W, use_pallas=True, pallas_interpret=True, min_ok_points=10)
JFIT = JFit(cyl_radius=70.0)
JREG = JReg(cyl_radius=70.0, min_frame_points=5)


@pytest.fixture(scope="module")
def scene():
    """5 uint8 stereo frames (the camera wire format) and the numpy rig."""
    st, _, (i1, i2), _ = registration_sequence(
        N, H, W, seed=2, angles=registration_angles(N, pan=0.1, tilt=0.02), radius=70.0,
        row_spacing=24.0)
    return st, i1.astype(np.uint8), i2.astype(np.uint8)


@pytest.fixture(scope="module")
def frames(scene):
    st, i1, i2 = scene
    return port_stereo(st), i1, i2


@pytest.fixture(scope="module")
def per_chunk(frames):
    """estimate_poses_batch on each chunk's frames, the tail padded as the
    stream pads it: [(batch result, live frames)]."""
    stereo, i1, i2 = frames
    out = []
    for s in range(0, N, CHUNK):
        idx = [min(k, N - 1) for k in range(s, s + CHUNK)]
        res = pipeline.estimate_poses_batch(torch.as_tensor(i1[idx]), torch.as_tensor(i2[idx]),
                                            stereo, CFG, FIT)
        out.append((res, min(CHUNK, N - s)))
    return out


@pytest.mark.parametrize("overlap", [True, False], ids=["overlap", "serial"])
@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_stream_equals_batch_per_chunk(frames, per_chunk, compact, overlap):
    stereo, i1, i2 = frames
    got = pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, chunk=CHUNK, compact=compact,
                                         overlap=overlap, reg_cfg=REG, device="cpu")
    assert type(got).__name__ == ("StreamPoseSummary" if compact else "StereoPoseResult")
    chunks = [(pipeline._summarize_batch(r, REG) if compact else r, live) for r, live in per_chunk]
    want = [np.concatenate([pipeline._tree_leaves(c)[i][:live].numpy() for c, live in chunks], axis=0)
            for i in range(len(pipeline._tree_leaves(chunks[0][0])))]
    got_leaves = pipeline._tree_leaves(got)
    assert len(got_leaves) == len(want)
    for g, w in zip(got_leaves, want):
        assert isinstance(g, np.ndarray) and g.shape[0] == N
        assert np.array_equal(g, w, equal_nan=np.issubdtype(w.dtype, np.floating))
    if compact:
        assert int(got.ok.sum()) >= 1 and got.params.shape == (N, 6)
        # ``healthy`` is frame_health of each chunk's batch result.
        np.testing.assert_array_equal(got.healthy, np.concatenate(
            [pipeline.frame_health(r, REG)[:live].numpy() for r, live in per_chunk]))


@pytest.fixture(scope="module")
def jax_streams(scene):
    """JAX ``estimate_poses_stream`` on the same frames at chunk 2: the full
    StereoPoseResult and the compact StreamPoseSummary, host numpy."""
    st, i1, i2 = scene
    jst = jax_stereo(st)
    return {compact: jpipe.estimate_poses_stream(i1, i2, jst, JCFG, JFIT, chunk=CHUNK,
                                                 compact=compact, reg_cfg=JREG)
            for compact in (False, True)}


def test_summarize_batch_matches_jax(jax_streams):
    """A JAX batch result fed through the port: the port's summary has JAX's
    field names and equals JAX's summary leaf for leaf, dtype included."""
    batch = jax_streams[False]
    want = jpipe._summarize_batch(batch, JREG)
    got = pipeline._summarize_batch(to_port(batch), from_reference(JREG))
    assert got._fields == want._fields
    for name, g, w in zip(want._fields, got, want):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def _axis_rad(a, b):
    """Angle (rad) between the lines along direction vectors a and b (..., 3)."""
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.arccos(np.clip(np.abs(np.sum(a * b, -1)), 0.0, 1.0))


def _perp_mm(params_a, params_b):
    """Distance from a's axis origin to b's axis line (mm)."""
    d = params_b[:, 3:] / np.linalg.norm(params_b[:, 3:], axis=-1, keepdims=True)
    rel = params_a[:, :3] - params_b[:, :3]
    return np.linalg.norm(rel - np.sum(rel * d, -1, keepdims=True) * d, axis=-1)


def _assert_fit_close(got_params, got_reproj, got_fvals, want_params, want_reproj, want_fvals,
                      healthy):
    assert _axis_rad(got_params[:, 3:], want_params[:, 3:]).max() < 1e-3
    perp = _perp_mm(want_params, got_params)
    assert perp[healthy].max() < 0.01 and perp.max() < 1.0, perp
    np.testing.assert_allclose(got_reproj, want_reproj, atol=1e-4)
    np.testing.assert_allclose(got_fvals, want_fvals, rtol=1e-3)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_stream_matches_jax(frames, jax_streams, compact):
    stereo, i1, i2 = frames
    want = jax_streams[compact]
    got = pipeline.estimate_poses_stream(
        i1, i2, stereo, from_reference(JCFG), from_reference(JFIT), chunk=CHUNK, compact=compact,
        reg_cfg=from_reference(JREG), device="cpu")
    assert type(got).__name__ == type(want).__name__
    for g, w in zip(pipeline._tree_leaves(got), pipeline._tree_leaves(want)):
        assert g.shape == np.shape(w) and g.shape[0] == N and g.dtype == np.asarray(w).dtype
    if compact:
        for name in ("ok", "stable", "healthy", "n_points", "bridged_components"):
            np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
        assert 1 <= int(want.healthy.sum()) < N
        for name in ("center1", "center2"):
            np.testing.assert_allclose(getattr(got, name), getattr(want, name), atol=1e-3)
        assert _axis_rad(got.params0[:, 3:], want.params0[:, 3:]).max() < 1e-3
        assert _axis_rad(got.t_cam_cyl[:, :3, 1], want.t_cam_cyl[:, :3, 1]).max() < 1e-3
        _assert_fit_close(got.params, got.mean_reproj_error, got.fvals,
                          want.params, want.mean_reproj_error, want.fvals, want.healthy)
        return
    for gd, wd in ((got.detect1, want.detect1), (got.detect2, want.detect2)):
        for name in ("ok", "stable", "bridged_components"):
            np.testing.assert_array_equal(getattr(gd, name), getattr(wd, name), err_msg=name)
        for f in range(N):
            w = {tuple(wd.grid.idx[f, k]): wd.grid.xy[f, k] for k in np.flatnonzero(wd.grid.valid[f])}
            g = {tuple(gd.grid.idx[f, k]): gd.grid.xy[f, k] for k in np.flatnonzero(gd.grid.valid[f])}
            assert set(g) == set(w), f
            assert max(float(np.abs(g[k] - w[k]).max()) for k in w) <= 1e-3
    np.testing.assert_array_equal(got.fit.points_valid, want.fit.points_valid)
    _assert_fit_close(got.fit.params, got.fit.mean_reproj_error, got.fit.fvals,
                      want.fit.params, want.fit.mean_reproj_error, want.fit.fvals,
                      np.asarray(jpipe.frame_health(want, JREG)))


def test_stream_rejects_mesh_and_empty(frames):
    """A mesh that is not a FrameMesh, a chunk that does not split over the
    mesh's ranks, a device other than the mesh's, and an empty sequence
    raise."""
    stereo, i1, i2 = frames
    with pytest.raises(TypeError, match="FrameMesh"):
        pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, mesh=object())
    two = FrameMesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, chunk=3, mesh=two)
    with pytest.raises(ValueError, match="not the mesh's"):
        pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, chunk=CHUNK, mesh=two, device="cuda")
    with pytest.raises(ValueError, match="at least one frame"):
        pipeline.estimate_poses_stream(i1[:0], i2[:0], stereo, CFG, FIT)


@pytest.mark.parametrize("compact", [True, False], ids=["compact", "full"])
def test_stream_world1_mesh_equals_unsharded(frames, compact):
    """Over a one-rank gloo mesh the stream (its one all-gather per chunk
    included) returns exactly the unsharded stream, padded tail and all."""
    stereo, i1, i2 = frames
    want = pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, chunk=CHUNK, compact=compact,
                                          reg_cfg=REG, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        got = pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, chunk=CHUNK, compact=compact,
                                             reg_cfg=REG, mesh=make_mesh(devices=["cpu"]))
    finally:
        dist.destroy_process_group()
    assert type(got) is type(want)
    for g, w in zip(pipeline._tree_leaves(got), pipeline._tree_leaves(want)):
        assert g.shape[0] == N and g.dtype == w.dtype
        assert np.array_equal(g, w, equal_nan=np.issubdtype(w.dtype, np.floating))


def test_stream_on_absent_cuda_device_raises(frames):
    """A CUDA device that cannot run raises; the stream never falls back to
    the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    stereo, i1, i2 = frames
    with pytest.raises((RuntimeError, AssertionError)):
        pipeline.estimate_poses_stream(i1, i2, stereo, CFG, FIT, chunk=CHUNK, device="cuda")


def test_tiled_frames_match_bench_stream_scheme():
    """Frame i = pool[i % P] + (i % 7) grey levels, saturating at 255, for
    chunks inside one period and across the period boundary."""
    rng = np.random.default_rng(0)
    pool = rng.integers(0, 256, (3, 4, 5), dtype=np.uint8)
    pool[0, 0, 0] = 255
    n = 50
    tiled = TiledFrames(pool, n)
    assert tiled.shape == (n, 4, 5)
    period = 3 * 7 // math.gcd(3, 7)
    want = np.stack([np.clip(pool[i % 3].astype(np.int16) + i % 7, 0, 255).astype(np.uint8)
                     for i in range(n)])
    for s, e in ((0, 8), (16, 24), (period - 3, period + 5), (40, 50), (0, n)):
        np.testing.assert_array_equal(tiled[s:e], want[s:e])
    assert tiled[0:1][0, 0, 0] == 255
