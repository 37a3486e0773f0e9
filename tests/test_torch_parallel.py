"""PyTorch port: frame-parallel serving over ``torch.distributed``
(``parallel/``) on the CPU.

* Mesh units: ``frame_slice`` blocks and its ValueError; a ``gather_frames``
  round trip of a tree with bool, int32, int64, float32 and float64 leaves
  (and a None leaf) over a world-1 gloo group; the leaves it refuses;
  ``make_mesh`` refusing to run without a group or torchrun's environment,
  NCCL without a card, a card that is absent, and a backend or a device
  list that does not fit the group.
* The fit stage against the JAX package: 8 grid-point scenes (those of
  tests/test_parallel.py's ``test_shard_map_fit_matches_vmap``) fitted by the
  port over 2 gloo ranks and by JAX's ``shard_map`` over 2 of the 8 CPU
  devices, held to the port's contract of tests/test_torch_pipeline.py:
  axes within 1e-3 rad, fvals within rel 1e-3, reprojection within 1e-4 px.
* The slice, sharded against unsharded, on both detection branches: 4
  frames at 192x256 over 2 ranks.  ``sharded_pipeline`` against
  ``full_experiment``, ``shard_map_pose`` against the rank's slice, and
  ``estimate_poses_stream(mesh=...)`` (compact and full, overlap on and off)
  against the unsharded stream on 3 frames at chunk 2 (the padded tail
  chunk leaves rank 1 a block of padding only).  Every leaf must be equal,
  except in the stream's LM outputs (params, fvals, t_cam_cyl,
  reprojection): there each rank fits one frame at a time, and at a batch
  of one the fit's float32 arithmetic differs in its last bits from the
  same frame's in a batch of two (every detection stage is equal:
  tools/torch_batch_split.py), so the LM ends elsewhere in the gauge valley
  (ROADMAP section 3 counts the frames): those are held to the fit contract
  above.  At two frames per rank (the
  pipeline's 4 frames) the fit equals the unsharded one bit for bit.
  The registration solves on the gathered points, so it must be equal, and
  every rank must return the same result.
* ``slow``: the slice against the JAX package: ``sharded_pipeline`` against
  ``jit_sharded_pipeline`` and the stream against JAX's
  ``estimate_poses_stream(mesh=...)``: ids and ``ok`` identical, xy within
  1e-3 px, and the fit contract above.

* The launcher: the dry run's CLI over 2 CPU ranks; a rank that raises, and
  ranks that outlive the launch's time limit, fail the launch.

Every run over ranks goes through ``parallel.dryrun.launch`` in a
subprocess (never ``spawn`` under the test runner's workers), with a
subprocess timeout; the process groups time out after 60 s
(``parallel.mesh.TIMEOUT``), so a dead peer fails the case instead of
hanging it.  World-1 groups run in the test process: a collective of one
rank cannot wait on a peer.
"""

import datetime
import json
import os
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from _torch_parallel_programs import H, W, slice_configs
from _torch_port import jax_stereo
from cylinder_pose_estimation_tpu_torch.geometry.registration import axis_errors
from cylinder_pose_estimation_tpu_torch.models import pipeline
from cylinder_pose_estimation_tpu_torch.parallel import mesh as pmesh
from cylinder_pose_estimation_tpu_torch.parallel.mesh import FrameMesh, frame_slice, gather_frames, make_mesh
from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy
from cylinder_pose_estimation_tpu_torch.utils.synthetic import registration_angles, registration_sequence

# One intra-op thread per test worker: the suite runs several workers on
# the same cores, and oversubscribed torch thread pools spin.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
TESTS = ROOT / "tests"
CPU = torch.device("cpu")
RANKS = 2
N_FRAMES, N_STREAM, CHUNK = 4, 3, 2
# Leaves of StereoPoseResult that the LM writes (the fit's params, fvals,
# t_cam_cyl and mean_reproj_error); every other leaf must be equal.
LM_FIELDS = ("params", "fvals", "t_cam_cyl", "mean_reproj_error")

_RUN = r"""
import json, sys
sys.path[:0] = [sys.argv[1], sys.argv[2]]
import _torch_parallel_programs as programs
from cylinder_pose_estimation_tpu_torch.parallel.dryrun import launch
out = launch(getattr(programs, sys.argv[3]), tuple(json.loads(sys.argv[4])), ranks=int(sys.argv[5]),
             device="cpu", timeout=float(sys.argv[6]))
print(json.dumps(out))
"""


def _run(argv: list, timeout: float) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, *argv], capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=timeout)


def launch(program: str, args: list, ranks: int = RANKS, timeout: float = 300.0) -> list:
    """``dryrun.launch`` of a rank program of tests/_torch_parallel_programs.py
    in a subprocess; its ranks' results."""
    proc = _run(["-c", _RUN, str(ROOT), str(TESTS), program, json.dumps(args), str(ranks), str(timeout - 30)],
                timeout)
    assert proc.returncode == 0, proc.stderr[-4000:]
    results = json.loads(proc.stdout.strip().splitlines()[-1])
    assert [r["rank"] for r in results] == list(range(ranks))
    return results


def load_tree(path, name, like):
    """The tree ``name`` of a rank's .out.npz in the structure of ``like``."""
    d = np.load(path)
    n = len(pipeline._tree_leaves(like))
    it = iter([d[f"{name}.{i}"] for i in range(n)])
    return pipeline._tree_map(lambda _: next(it), like)


# --- mesh units -------------------------------------------------------------


@pytest.mark.parametrize("size", [1, 2, 4])
def test_frame_slice(size):
    blocks = [frame_slice(FrameMesh(None, r, size, CPU), 8) for r in range(size)]
    assert [i for s, e in blocks for i in range(s, e)] == list(range(8))
    assert len({e - s for s, e in blocks}) == 1
    with pytest.raises(ValueError, match="divisible by the mesh size"):
        frame_slice(FrameMesh(None, 0, size + 1, CPU), 8 * (size + 1) + 1)  # one frame past a multiple


@pytest.fixture
def world1():
    """A world-1 gloo group in this process, and its FrameMesh."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield make_mesh(devices=["cpu"])
    finally:
        dist.destroy_process_group()


class _Inner(NamedTuple):
    f64: torch.Tensor
    missing: object


class _Tree(NamedTuple):
    flags: torch.Tensor
    ids: torch.Tensor
    big: torch.Tensor
    xy: torch.Tensor
    inner: _Inner


def test_gather_frames_round_trip(world1):
    g = torch.Generator().manual_seed(0)
    tree = _Tree(flags=torch.rand(3, 4, generator=g) < 0.5,
                 ids=torch.randint(-2**31, 2**31 - 1, (3,), dtype=torch.int32, generator=g),
                 big=torch.randint(-2**62, 2**62, (3, 2, 2), dtype=torch.int64, generator=g),
                 xy=torch.randn(3, 5, generator=g).transpose(0, 1).contiguous().transpose(0, 1),
                 inner=_Inner(f64=torch.tensor([np.nan, -np.inf, 1e-300], dtype=torch.float64), missing=None))
    assert world1.size == 1 and world1.rank == 0 and world1.device == CPU and world1.backend == "gloo"
    out = gather_frames(tree, world1)
    assert type(out) is _Tree and type(out.inner) is _Inner and out.inner.missing is None
    for got, want in zip(pipeline._tree_leaves(out), pipeline._tree_leaves(tree)):
        if want is None:
            continue
        assert got.dtype == want.dtype and got.shape == want.shape and got.device == CPU
        assert torch.equal(got.view(torch.uint8), want.contiguous().view(torch.uint8))
    for bad in (tree._replace(ids=torch.tensor(1)), tree._replace(ids=torch.zeros(2, dtype=torch.int32)),
                tree._replace(ids=np.zeros(3))):
        with pytest.raises(ValueError, match="leaf ids"):
            gather_frames(bad, world1)


def test_make_mesh_joins_the_group(world1):
    assert make_mesh(devices=["cpu"], backend="gloo") == world1
    with pytest.raises(ValueError, match="runs gloo, not nccl"):
        make_mesh(devices=["cpu"], backend="nccl")
    with pytest.raises(ValueError, match="2 devices for 1 ranks"):
        make_mesh(devices=["cpu", "cpu"])


def test_make_mesh_refuses(monkeypatch):
    assert not dist.is_initialized()
    for k in pmesh._ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="no process group is initialised"):
        make_mesh(devices=["cpu"])
    # torchrun's environment of a one-rank job; each call fails before it
    # would start the group.
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "localhost",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        make_mesh(devices=["cpu"], backend="nccl")
    with pytest.raises(ValueError, match="one of"):
        make_mesh(devices=["cpu"], backend="mpi")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(backend="gloo")  # the default device is cuda:LOCAL_RANK
    assert not dist.is_initialized()


# --- the launcher --------------------------------------------------------------


def test_dryrun_on_two_cpu_ranks():
    """The dry run's own program: one JSON line, ``ok``, every rank's result
    the same and held to the unsharded run."""
    proc = _run(["-m", "cylinder_pose_estimation_tpu_torch.parallel.dryrun", "--ranks", "2", "--device", "cpu"],
                timeout=300)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["ok"] and out["ranks_agree"] and out["backend"] == "gloo" and out["frames"] == 4
    assert out["unsharded"]["batch"]["ok"] and out["unsharded"]["stream"]["ok"]


@pytest.mark.parametrize("program, args, message", [
    ("failing_program", [], "rank 1 exited with code 1"),
    ("sleeping_program", [600], "still running after"),
], ids=["failed-rank", "timeout"])
def test_launch_fails_on_a_failed_or_stuck_rank(program, args, message):
    """A rank that raises fails the launch (its peer, waiting in a
    collective, is stopped), and so does a run past its time limit; the
    launcher's process exits non-zero either way, well inside the
    subprocess timeout."""
    proc = _run(["-c", _RUN, str(ROOT), str(TESTS), program, json.dumps(args), "2", "20"], timeout=120)
    assert proc.returncode != 0
    assert message in proc.stderr, proc.stderr[-3000:]


# --- the fit stage against JAX's shard_map ----------------------------------


def _axis_rad(a, b):
    a = a / np.linalg.norm(a, axis=-1, keepdims=True)
    b = b / np.linalg.norm(b, axis=-1, keepdims=True)
    return np.arccos(np.clip(np.abs(np.sum(a * b, -1)), 0.0, 1.0))


def _assert_fit_contract(got, want, tag=""):
    """Axes within 1e-3 rad, fvals within rel 1e-3, reprojection within 1e-4
    px (``got``/``want``: (params, fvals, mean_reproj_error) host arrays)."""
    gp, gf, gr = (np.asarray(x) for x in got)
    wp, wf, wr = (np.asarray(x) for x in want)
    ang = _axis_rad(gp[..., 3:6], wp[..., 3:6])
    assert ang.max() < 1e-3, (tag, ang)
    np.testing.assert_allclose(gf, wf, rtol=1e-3, err_msg=tag)
    np.testing.assert_allclose(gr, wr, atol=1e-4, err_msg=tag)
    return float(ang.max())


def test_fit_stage_matches_jax_shard_map(tmp_path):
    from jax.sharding import PartitionSpec as P

    from cylinder_pose_estimation_tpu.config import FitConfig as JFit
    from cylinder_pose_estimation_tpu.models.pose import fit_single_cylinder
    from cylinder_pose_estimation_tpu.parallel.mesh import FRAME_AXIS
    from cylinder_pose_estimation_tpu.parallel.mesh import make_mesh as jax_mesh
    from cylinder_pose_estimation_tpu.types import GridPoints
    from cylinder_pose_estimation_tpu.utils.synthetic import cylinder_grid_points, default_stereo

    stereo = default_stereo()
    scenes = [cylinder_grid_points(stereo, radius=55.0, origin=(5.0 * k - 15.0, -10.0, 450.0), capacity=128,
                                   seed=k, noise_px=0.1) for k in range(8)]
    gp1 = GridPoints(*[jnp.stack([s.gp1[i] for s in scenes]) for i in range(4)])
    gp2 = GridPoints(*[jnp.stack([s.gp2[i] for s in scenes]) for i in range(4)])
    fit_cfg = JFit(cyl_radius=55.0, lm_iters=30)

    def batched(a, b):
        return jax.vmap(lambda p, q: fit_single_cylinder(p, q, stereo, fit_cfg))(a, b)

    want = jax.jit(jax.shard_map(batched, mesh=jax_mesh(jax.devices()[:RANKS]),
                                 in_specs=(P(FRAME_AXIS), P(FRAME_AXIS)), out_specs=P(FRAME_AXIS)))(gp1, gp2)

    path = str(tmp_path / "fit.npz")
    rig = (stereo.cam1.k, stereo.cam1.radial, stereo.cam1.tangential, stereo.cam2.k, stereo.cam2.radial,
           stereo.cam2.tangential, stereo.t_c2_c1)
    leaves = {f"stereo{i}": np.asarray(x) for i, x in enumerate(rig)}
    for view, gp in (("gp1", gp1), ("gp2", gp2)):
        leaves.update({f"{view}_{k}": np.asarray(v) for k, v in zip(gp._fields, gp)})
    np.savez(path, **leaves)
    results = launch("fit_program", [path])
    assert len({r["digest"] for r in results}) == 1
    from cylinder_pose_estimation_tpu_torch.types import CylinderFitResult

    got = load_tree(path.replace(".npz", ".out.npz"), "fit", CylinderFitResult(*[0] * 7))
    assert got.params.shape == (8, 6)
    _assert_fit_contract((got.params, got.fvals[:, 1], got.mean_reproj_error),
                         (want.params, np.asarray(want.fvals)[:, 1], want.mean_reproj_error))
    np.testing.assert_array_equal(got.points_valid, np.asarray(want.points_valid))


# --- the slice, sharded against unsharded -----------------------------------


@pytest.fixture(scope="module")
def slice_scene():
    """4 kinematically consistent frames at 192x256 and their angles."""
    st, ang, (i1, i2), _ = registration_sequence(
        N_FRAMES, H, W, seed=0, angles=registration_angles(N_FRAMES, pan=0.15, tilt=0.04), radius=55.0)
    return st, ang, i1, i2


def _write_scene(path, scene):
    st, ang, i1, i2 = scene
    np.savez(path, i1=i1, i2=i2, angles=ang, s1=i1[:N_STREAM].astype(np.uint8),
             s2=i2[:N_STREAM].astype(np.uint8), **{f"stereo{i}": np.asarray(x) for i, x in enumerate(st)})


def _split_lm(tree):
    """(leaves the LM does not write, the LM's leaves by name) of a
    StereoPoseResult or StreamPoseSummary."""
    fit = tree.fit if hasattr(tree, "fit") else tree
    lm = {name: np.asarray(getattr(fit, name)) for name in LM_FIELDS}
    if hasattr(tree, "fit"):
        rest = pipeline._tree_leaves(tree._replace(fit=fit._replace(**dict.fromkeys(LM_FIELDS, None))))
    else:
        rest = pipeline._tree_leaves(tree._replace(**dict.fromkeys(LM_FIELDS, None)))
    return [x for x in rest if x is not None], lm


def _compare(got, want, tag):
    """Every leaf the LM does not write equal; the LM's leaves within the fit
    contract.  Returns (differing LM leaves, frames that differ in any,
    largest axis angle in rad, largest fval relative difference)."""
    rest_g, lm_g = _split_lm(got)
    rest_w, lm_w = _split_lm(want)
    assert len(rest_g) == len(rest_w)
    for g, w in zip(rest_g, rest_w):
        w = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
        assert g.dtype == w.dtype and g.shape == w.shape, tag
        assert np.array_equal(g, w, equal_nan=np.issubdtype(w.dtype, np.floating)), tag
    axis = _assert_fit_contract((lm_g["params"], lm_g["fvals"], lm_g["mean_reproj_error"]),
                                (lm_w["params"], lm_w["fvals"], lm_w["mean_reproj_error"]), tag)
    frames = np.zeros(lm_g["params"].shape[0], bool)
    leaves = []
    for name in LM_FIELDS:
        g, w = lm_g[name], lm_w[name]
        bad = ~(np.equal(g, w) | (np.isnan(g) & np.isnan(w))).reshape(g.shape[0], -1).all(-1)
        if bad.any():
            leaves.append(name)
        frames |= bad
    fval_rel = float(np.max(np.abs(lm_g["fvals"] - lm_w["fvals"]) / np.abs(lm_w["fvals"])))
    return leaves, int(frames.sum()), axis, fval_rel


@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "xla"])
def test_slice_sharded_matches_unsharded(tmp_path, slice_scene, use_pallas):
    path = str(tmp_path / "slice.npz")
    _write_scene(path, slice_scene)
    results = launch("slice_program", [path, use_pallas, CHUNK])
    assert all(r["digest"] == results[0]["digest"] for r in results), "the ranks' results differ"
    assert all(r["t_cam_agv_ranks_equal"] and r["shard_map_equal"] for r in results)

    st, ang, i1, i2 = slice_scene
    stereo = stereo_from_numpy(*st, device="cpu")
    cfg, fit_cfg, reg_cfg = slice_configs(use_pallas)
    want_batch, want_reg = pipeline.full_experiment(torch.as_tensor(i1), torch.as_tensor(i2),
                                                    torch.as_tensor(ang), stereo, cfg, fit_cfg, reg_cfg)
    out = path.replace(".npz", ".out.npz")
    got_batch = load_tree(out, "batch", want_batch)
    got_reg = load_tree(out, "reg", want_reg)
    # Two frames per rank: the fit equals the 4-frame batch's bit for bit.
    report = {"batch": _compare(got_batch, want_batch, "batch")}
    assert report["batch"][:2] == ([], 0), report
    for name in want_reg._fields:
        np.testing.assert_array_equal(getattr(got_reg, name), getattr(want_reg, name).numpy(), err_msg=name)
    ang_err, perp = axis_errors(want_reg.t_cam_agv.numpy(), got_reg.t_cam_agv, ang)
    assert ang_err.max() < 0.05 and perp.max() < 0.1

    for compact in (True, False):
        want = pipeline.estimate_poses_stream(i1[:N_STREAM].astype(np.uint8), i2[:N_STREAM].astype(np.uint8),
                                              stereo, cfg, fit_cfg, chunk=CHUNK, compact=compact,
                                              reg_cfg=reg_cfg, device="cpu")
        for overlap in (True, False):
            name = f"{'compact' if compact else 'full'}_{'overlap' if overlap else 'serial'}"
            got = load_tree(out, name, want)
            assert pipeline._tree_leaves(got)[0].shape[0] == N_STREAM
            report[name] = _compare(got, want, name)
    print("LM leaves and frames that differ, sharded vs unsharded:", report)


# --- slow: the slice against the JAX package ---------------------------------


def _grid_dicts(det, f):
    return {tuple(det.grid.idx[f, k]): det.grid.xy[f, k] for k in np.flatnonzero(det.grid.valid[f])}


def _assert_detect_close(got, want, tag):
    """ids and ``ok`` identical, xy within 1e-3 px (numpy DetectResults)."""
    np.testing.assert_array_equal(got.ok, np.asarray(want.ok), err_msg=tag)
    for f in range(got.ok.shape[0]):
        g, w = _grid_dicts(got, f), _grid_dicts(want, f)
        assert set(g) == set(w), (tag, f)
        if w:
            assert max(float(np.abs(g[k] - w[k]).max()) for k in w) <= 1e-3, (tag, f)


@pytest.mark.slow
@pytest.mark.parametrize("use_pallas", [True, False], ids=["kernel", "xla"])
def test_slice_matches_jax(tmp_path, slice_scene, use_pallas):
    from cylinder_pose_estimation_tpu.config import CylinderDetectConfig as JDetect
    from cylinder_pose_estimation_tpu.config import FitConfig as JFit
    from cylinder_pose_estimation_tpu.config import RegistrationConfig as JReg
    from cylinder_pose_estimation_tpu.models import pipeline as jpipe
    from cylinder_pose_estimation_tpu.parallel.mesh import make_mesh as jax_mesh
    from cylinder_pose_estimation_tpu.parallel.sharding import jit_sharded_pipeline

    path = str(tmp_path / "slice.npz")
    _write_scene(path, slice_scene)
    launch("slice_program", [path, use_pallas, CHUNK])
    out = path.replace(".npz", ".out.npz")

    st, ang, i1, i2 = slice_scene
    jst = jax_stereo(st)
    jcfg = JDetect(height=H, width=W, use_pallas=use_pallas, pallas_interpret=use_pallas, cc_iters=8,
                   min_ok_points=5, drop_first_row=False, drop_last_col=False)
    jfit = JFit(cyl_radius=55.0, lm_iters=40)
    jreg = JReg(cyl_radius=55.0, lm_iters=10, min_frame_points=5)
    mesh = jax_mesh(jax.devices()[:RANKS])
    want_batch, want_reg = jit_sharded_pipeline(mesh, jst, jcfg, jfit, jreg)(i1, i2, ang)
    want_batch = jax.tree.map(np.asarray, want_batch)
    got_batch = load_tree(out, "batch", want_batch)
    for view in ("detect1", "detect2"):
        _assert_detect_close(getattr(got_batch, view), getattr(want_batch, view), view)
    _assert_fit_contract((got_batch.fit.params, got_batch.fit.fvals, got_batch.fit.mean_reproj_error),
                         (want_batch.fit.params, want_batch.fit.fvals, want_batch.fit.mean_reproj_error))
    got_reg = load_tree(out, "reg", want_reg)
    assert bool(got_reg.well_posed) == bool(want_reg.well_posed)
    ang_err, perp = axis_errors(np.asarray(want_reg.t_cam_agv), got_reg.t_cam_agv, ang)
    assert ang_err.max() < 0.05 and perp.max() < 0.1, (ang_err, perp)
    np.testing.assert_allclose(float(got_reg.fval), float(want_reg.fval), rtol=1e-2)

    s1, s2 = i1[:N_STREAM].astype(np.uint8), i2[:N_STREAM].astype(np.uint8)
    for compact in (True, False):
        want = jpipe.estimate_poses_stream(s1, s2, jst, jcfg, jfit, chunk=CHUNK, compact=compact,
                                           reg_cfg=jreg, mesh=mesh)
        got = load_tree(out, f"{'compact' if compact else 'full'}_overlap", want)
        if compact:
            np.testing.assert_array_equal(got.ok, want.ok)
            np.testing.assert_allclose(got.center1, want.center1, atol=1e-3)
            np.testing.assert_allclose(got.center2, want.center2, atol=1e-3)
            fit_g, fit_w = got, want
        else:
            for view in ("detect1", "detect2"):
                _assert_detect_close(getattr(got, view), getattr(want, view), f"stream {view}")
            fit_g, fit_w = got.fit, want.fit
        _assert_fit_contract((fit_g.params, fit_g.fvals, fit_g.mean_reproj_error),
                             (fit_w.params, fit_w.fvals, fit_w.mean_reproj_error), f"stream {compact}")
