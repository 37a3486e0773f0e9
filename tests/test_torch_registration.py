"""PyTorch port: kinematics, multi-frame AGV registration and the whole
experiment against the JAX package on the CPU.

* ``t_agv_cyl`` on random (pan, tilt) batches: atol 1e-4.
* ``fit_cylinders_with_angles`` on the scenarios of tests/test_registration.py
  (exact, 0.3 mm noise, a poisoned masked frame, the < 2 valid frames
  fallback, narrow and wide swing, 1x and 2x scale), with the JAX result on
  the same points as the reference: the cylinder axes that both T_Cam_AGV
  predict agree within 0.01 deg and 0.01 mm perpendicular offset, fval and
  fval0 within rel 1e-3 (atol 1e-6), jtj_min_eig within rel 1e-3 and
  well_posed equal.  The 26 multi-start candidates can tie, so the pose is
  compared through what the objective sees, the predicted axis lines.
  Where the solution is not unique (the 2-frame fallback and the narrow
  swing: the objective is flat along the shared axis), the minimum
  eigenvalue depends on where in the flat valley 80 float32 LM steps stop
  and on float32 ``eigvalsh`` noise at that small eigenvalue (measured: 7%
  and 5% apart, with the predicted axes within 1e-5 deg); there it is held
  within rel 0.1 after the solve, and within rel 1e-3 at a common pose
  (``lm_iters=0``, the best candidate) in every scenario.  The same holds
  for the 4-frame image sequence below, whose swing is narrow enough that
  JAX itself reports it not well posed (min eigenvalue 1.0e-3 < 1.5e-3):
  after the solve the two minimum eigenvalues lie 12% apart there, so only
  ``well_posed`` is compared after the solve, and the eigenvalue at the
  common pose.
* The registration Jacobian at rotvec = 0 (the identity candidate) is finite.
* ``frame_health``, ``register_sequence`` and ``full_experiment`` (with and
  without ``preprocess``) on a 240x320 x 4 frame registration sequence:
  health equal, ids identical, xy within 1e-3 px, registration as above.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import jax_stereo, port_stereo, to_port
from tests.test_registration import _make_frames
from cylinder_pose_estimation_tpu.config import CylinderDetectConfig as JDetect
from cylinder_pose_estimation_tpu.config import FitConfig as JFit
from cylinder_pose_estimation_tpu.config import KinematicsConfig as JKin
from cylinder_pose_estimation_tpu.config import RegistrationConfig as JReg
from cylinder_pose_estimation_tpu.geometry import transforms as jtf
from cylinder_pose_estimation_tpu.geometry.kinematics import t_agv_cyl as j_t_agv_cyl
from cylinder_pose_estimation_tpu.geometry.registration import (
    fit_cylinders_with_angles as j_fit,
    registration_residuals as j_residuals,
)
from cylinder_pose_estimation_tpu.models import pipeline as jpipe
from cylinder_pose_estimation_tpu_torch.config import from_reference
from cylinder_pose_estimation_tpu_torch.geometry.kinematics import t_agv_cyl
from cylinder_pose_estimation_tpu_torch.geometry.registration import (
    axis_errors,
    fit_cylinders_with_angles,
    registration_residuals,
)
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_angles, registration_sequence

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)


def test_t_agv_cyl_matches_jax():
    rng = np.random.default_rng(0)
    kin = JKin(l1=300.0, l2=150.0, h=95.0)
    for shape in ((7,), (3, 5)):
        pan = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
        tilt = rng.uniform(-0.4, 0.4, shape).astype(np.float32)
        for cfg in (JKin(), kin):
            want = np.asarray(j_t_agv_cyl(jnp.asarray(pan), jnp.asarray(tilt), cfg))
            got = t_agv_cyl(torch.as_tensor(pan), torch.as_tensor(tilt), from_reference(cfg))
            assert got.shape == shape + (4, 4) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def assert_registration_close(got, want, angles, kin=JKin(), eig_rtol=1e-3):
    """The port's RegistrationResult against the JAX one (module docstring)."""
    angs, perps = axis_errors(np.asarray(want.t_cam_agv), got.t_cam_agv.numpy(), angles,
                              from_reference(kin))
    assert angs.max() < 0.01, angs
    assert perps.max() < 0.01, perps
    for name in ("fval", "fval0"):
        np.testing.assert_allclose(float(getattr(got, name)), float(getattr(want, name)),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    if eig_rtol is not None:
        np.testing.assert_allclose(float(got.jtj_min_eig), float(want.jtj_min_eig), rtol=eig_rtol)
    assert bool(got.well_posed) == bool(want.well_posed)
    return angs.max(), perps.max()


def _scaled_frames(scale, angs):
    """tests/test_registration.py::test_observability_is_scale_free's scene,
    everything scaled by ``scale``."""
    gt_pose = jnp.asarray([0.1, -0.9, 0.05, 60.0, -30.0, 700.0], jnp.float32)
    kin = JKin()
    kin = dataclasses.replace(kin, **{f.name: getattr(kin, f.name) * scale
                                      for f in dataclasses.fields(kin)})
    cfg = JReg(cyl_radius=45.0 * scale, kinematics=kin)
    t_gt = np.asarray(jtf.vec_to_transform(gt_pose.at[3:].multiply(scale)))
    t_cam_cyls = t_gt @ np.asarray(j_t_agv_cyl(jnp.asarray(angs)[:, 0], jnp.asarray(angs)[:, 1], kin))
    frames, valids = [], []
    for f in range(len(angs)):
        org = t_cam_cyls[f, :3, 3]
        x, y, z = t_cam_cyls[f, :3, 0], t_cam_cyls[f, :3, 1], t_cam_cyls[f, :3, 2]
        phi = np.arctan2(-x[2], -z[2])
        pts = [org + hh * y + 45.0 * scale * (np.cos(th) * z + np.sin(th) * x)
               for hh in (np.arange(8) - 4) * 13.0 * scale
               for th in phi + np.linspace(-0.7, 0.7, 9)]
        buf = np.zeros((128, 3), np.float32)
        buf[:72] = np.asarray(pts, np.float32)
        val = np.zeros(128, bool)
        val[:72] = True
        frames.append(buf)
        valids.append(val)
    return np.stack(frames), np.stack(valids), cfg


_WIDE = np.stack([np.linspace(-0.5, 0.5, 6), np.linspace(0.15, -0.15, 6)], -1).astype(np.float32)
_NARROW = np.stack([np.linspace(-0.05, 0.05, 6), np.linspace(0.015, -0.015, 6)], -1).astype(np.float32)


def _scenario(name):
    """(pts3s, valid, angles, frame_valid or None, JAX RegistrationConfig)."""
    if name == "exact":
        gt = jnp.asarray([0.2, -1.6, 0.15, 120.0, -40.0, 900.0], jnp.float32)
        ang = np.asarray([[-0.3, 0.1], [0.0, 0.0], [0.35, -0.12], [0.6, 0.2]], np.float32)
        pts, val = _make_frames(jtf.vec_to_transform(gt), ang)
        return np.asarray(pts), np.asarray(val), ang, None, JReg()
    if name == "noise_0.3mm":
        gt = jnp.asarray([0.1, -1.4, 0.05, 80.0, -20.0, 800.0], jnp.float32)
        ang = np.asarray([[-0.3, 0.0], [0.1, 0.1], [0.5, -0.15]], np.float32)
        pts, val = _make_frames(jtf.vec_to_transform(gt), ang, seed=4)
        noisy = np.asarray(pts) + np.random.default_rng(7).normal(0, 0.3, pts.shape).astype(np.float32)
        return noisy, np.asarray(val), ang, None, JReg()
    if name == "poisoned_masked":
        gt = jnp.asarray([0.15, -1.5, 0.1, 90.0, -25.0, 820.0], jnp.float32)
        ang = np.asarray([[-0.25, 0.05], [0.0, 0.0], [0.3, -0.1], [0.55, 0.15]], np.float32)
        pts, val = _make_frames(jtf.vec_to_transform(gt), ang, seed=5)
        pts = np.array(pts)
        pts[0] = np.random.default_rng(11).uniform(-1e4, 1e4, pts.shape[1:]).astype(np.float32)
        return pts, np.asarray(val), ang, np.asarray([False, True, True, True]), JReg()
    if name == "fallback_under_two":
        gt = jnp.asarray([0.0, -1.5, 0.1, 100.0, -30.0, 850.0], jnp.float32)
        ang = np.asarray([[-0.2, 0.05], [0.25, -0.1]], np.float32)
        pts, val = _make_frames(jtf.vec_to_transform(gt), ang, seed=6)
        return np.asarray(pts), np.asarray(val), ang, np.asarray([False, True]), JReg()
    if name in ("wide", "narrow"):
        gt = jnp.asarray([0.1, -0.9, 0.05, 60.0, -30.0, 700.0], jnp.float32)
        ang = _WIDE if name == "wide" else _NARROW
        pts, val = _make_frames(jtf.vec_to_transform(gt), ang, seed=1 if name == "wide" else 2)
        return np.asarray(pts), np.asarray(val), ang, None, JReg()
    scale = {"scale_1x": 1.0, "scale_2x": 2.0}[name]
    pts, val, cfg = _scaled_frames(scale, _WIDE)
    return pts, val, _WIDE, None, cfg


SCENARIOS = ["exact", "noise_0.3mm", "poisoned_masked", "fallback_under_two", "wide", "narrow",
             "scale_1x", "scale_2x"]
# Scenarios whose solution is not unique (module docstring).
GAUGE_FLAT = ("fallback_under_two", "narrow")


def _both(name, lm_iters=None):
    pts, val, ang, fv, cfg = _scenario(name)
    if lm_iters is not None:
        cfg = dataclasses.replace(cfg, lm_iters=lm_iters)
    want = j_fit(jnp.asarray(pts), jnp.asarray(val), jnp.asarray(ang), cfg,
                 frame_valid=None if fv is None else jnp.asarray(fv))
    got = fit_cylinders_with_angles(torch.as_tensor(pts), torch.as_tensor(val), torch.as_tensor(ang),
                                    from_reference(cfg),
                                    frame_valid=None if fv is None else torch.as_tensor(fv))
    return ang, cfg, want, got


@pytest.mark.parametrize("name", SCENARIOS)
def test_registration_matches_jax(name):
    ang, cfg, want, got = _both(name)
    assert got.t_cam_agv.shape == (4, 4) and bool(torch.isfinite(got.t_cam_agv).all())
    ang_err, perp = assert_registration_close(got, want, ang, cfg.kinematics,
                                              eig_rtol=0.1 if name in GAUGE_FLAT else 1e-3)
    print(f"{name}: axes {ang_err:.2e} deg, perp {perp:.2e} mm, fval {float(got.fval):.6g} "
          f"vs {float(want.fval):.6g}, min_eig {float(got.jtj_min_eig):.6g} vs {float(want.jtj_min_eig):.6g}")


@pytest.mark.parametrize("name", SCENARIOS)
def test_registration_diagnostic_at_common_pose(name):
    """lm_iters=0: both return the best multi-start candidate, so the
    observability diagnostic and the objectives are compared at one pose."""
    ang, cfg, want, got = _both(name, lm_iters=0)
    assert_registration_close(got, want, ang, cfg.kinematics)


def test_registration_jacobian_finite_at_identity():
    """The identity candidate of the cube group starts at rotvec = 0, where
    Rodrigues takes sqrt(0): the forward-mode Jacobian must stay finite and
    equal JAX's jacfwd there."""
    pts, val, ang, _, _ = _scenario("exact")
    kin = np.asarray(j_t_agv_cyl(jnp.asarray(ang)[:, 0], jnp.asarray(ang)[:, 1]))
    pose = np.asarray([0.0, 0.0, 0.0, 120.0, -40.0, 900.0], np.float32)
    want = np.asarray(jax.jacfwd(lambda p: j_residuals(p, jnp.asarray(kin), jnp.asarray(pts),
                                                       jnp.asarray(val), 45.0))(jnp.asarray(pose)))
    got = torch.func.jacfwd(lambda p: registration_residuals(
        p, torch.as_tensor(kin), torch.as_tensor(pts), torch.as_tensor(val), 45.0))(torch.as_tensor(pose))
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-3)


# --- the whole experiment at 240x320 x 4 frames ----------------------------

H, W, N_FRAMES = 240, 320, 4
RADIUS = 70.0
JCFG = JDetect(height=H, width=W, use_pallas=True, pallas_interpret=True, min_ok_points=10)
JFIT = JFit(cyl_radius=RADIUS)
JREG = JReg(cyl_radius=RADIUS, min_frame_points=5)


@pytest.fixture(scope="module")
def sequence():
    st, ang, (i1, i2), _ = registration_sequence(
        N_FRAMES, H, W, angles=registration_angles(N_FRAMES, pan=0.1, tilt=0.02),
        radius=RADIUS, row_spacing=24.0)
    return st, ang, i1, i2


@pytest.fixture(scope="module")
def jax_experiment(sequence):
    """JAX ``full_experiment`` on already preprocessed frames, jitted once."""
    st = sequence[0]
    jst = jax_stereo(st)
    return jst, jax.jit(lambda a, b, g: jpipe.full_experiment(a, b, g, jst, JCFG, JFIT, JREG))


@pytest.fixture(scope="module", params=[False, True], ids=["raw", "preprocess"])
def experiments(request, sequence, jax_experiment):
    """(angles, JAX (batch, reg), port (batch, reg)) of full_experiment.

    With ``preprocess`` the JAX side runs ``preprocess_stereo_batch`` op by
    op and the rest of ``full_experiment`` jitted.  Under ``jax.jit`` XLA
    rewrites the undistortion's float32 arithmetic (division by the focal
    length as a reciprocal multiply, fused multiply-adds), which moves the
    undistorted grey levels by up to 1e-3; op by op, JAX and the port agree
    bit for bit (tests/test_torch_preprocess.py), so the comparison below
    sees the port's own numerics and no such last-bit flip of a detector
    threshold."""
    st, ang, i1, i2 = sequence
    pre = request.param
    jst, jfull = jax_experiment
    a, b = jnp.asarray(i1), jnp.asarray(i2)
    if pre:
        a, b = jpipe.preprocess_stereo_batch(a, b, jst)
    want = jfull(a, b, jnp.asarray(ang))
    got = pipeline.full_experiment(
        torch.as_tensor(i1), torch.as_tensor(i2), torch.as_tensor(ang), port_stereo(st),
        from_reference(JCFG), from_reference(JFIT), from_reference(JREG), preprocess=pre)
    return ang, want, got, pre


def test_full_experiment_matches_jax(experiments):
    """Ids identical, xy within 1e-3 px.  On the preprocessed frames, which
    are bit-identical on both sides, one grid point of 277 (view 2 of frame
    2) moves by 0.147 px: a last-bit difference of float32 summation order
    inside the detector's front end tips a threshold on the equalised image.
    That flip is counted and bounded here, not hidden."""
    ang, (jb, jr), (tb, tr), pre = experiments
    n_points = 0
    moved = []
    for jd, td in ((jb.detect1, tb.detect1), (jb.detect2, tb.detect2)):
        for f in range(N_FRAMES):
            jv = np.asarray(jd.grid.valid[f])
            want = {tuple(np.asarray(jd.grid.idx[f])[k]): np.asarray(jd.grid.xy[f])[k]
                    for k in range(len(jv)) if jv[k]}
            tv = td.grid.valid[f].numpy()
            got = {tuple(td.grid.idx[f].numpy()[k]): td.grid.xy[f].numpy()[k]
                   for k in range(len(tv)) if tv[k]}
            assert set(got) == set(want)
            moved += [float(np.abs(got[k] - want[k]).max()) for k in want]
            n_points += len(want)
        np.testing.assert_array_equal(td.ok.numpy(), np.asarray(jd.ok))
        np.testing.assert_array_equal(td.stable.numpy(), np.asarray(jd.stable))
    assert n_points >= 8 * N_FRAMES
    moved = [d for d in moved if d > 1e-3]
    print(f"{'preprocess' if pre else 'raw'}: {len(moved)} of {n_points} points beyond 1e-3 px: {moved}")
    assert len(moved) <= (1 if pre else 0) and max(moved, default=0.0) < 0.25
    health = pipeline.frame_health(tb, from_reference(JREG)).numpy()
    np.testing.assert_array_equal(health, np.asarray(jpipe.frame_health(jb, JREG)))
    # Equalised frames lose the stability flags here, so the preprocessed
    # run takes the registration's all-frames fallback.
    assert health.sum() >= (0 if pre else 2)
    assert_registration_close(tr, jr, ang, eig_rtol=1e-3 if bool(jr.well_posed) else None)


def test_frame_health_and_register_sequence_on_jax_batch(experiments):
    """The JAX batch result fed through the port: frame_health exactly equal,
    register_sequence within the registration tolerances of JAX's own."""
    ang, (jb, jr), _, _ = experiments
    batch = to_port(jb)
    health = pipeline.frame_health(batch, from_reference(JREG))
    np.testing.assert_array_equal(health.numpy(), np.asarray(jpipe.frame_health(jb, JREG)))
    reg = pipeline.register_sequence(batch, torch.as_tensor(ang), from_reference(JREG))
    assert_registration_close(reg, jr, ang, eig_rtol=1e-3 if bool(jr.well_posed) else None)
    # At a common pose (the best multi-start candidate, no LM steps) the
    # diagnostic holds within rel 1e-3 whether or not the problem is posed.
    reg0 = dataclasses.replace(JREG, lm_iters=0)
    want0 = jpipe.register_sequence(jb, jnp.asarray(ang), reg0)
    got0 = pipeline.register_sequence(batch, torch.as_tensor(ang), from_reference(reg0))
    assert_registration_close(got0, want0, ang)
