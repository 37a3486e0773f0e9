"""Helpers of the PyTorch port's tests: JAX results and stereo rigs as port
types, and the detection corpora's branch-by-branch contract."""

from __future__ import annotations

import functools

import numpy as np
import torch

from cylinder_pose_estimation_tpu_torch.types import stereo_from_numpy


def port_stereo(st):
    """A JAX StereoParams (or the port's numpy Stereo) as the port's."""
    if hasattr(st, "cam1"):
        leaves = (st.cam1.k, st.cam1.radial, st.cam1.tangential,
                  st.cam2.k, st.cam2.radial, st.cam2.tangential, st.t_c2_c1)
    else:
        leaves = tuple(st)
    return stereo_from_numpy(*(np.asarray(x) for x in leaves), device="cpu")


def jax_stereo(st):
    """The port's numpy Stereo (``utils.synthetic``) as a JAX StereoParams."""
    import jax.numpy as jnp

    from cylinder_pose_estimation_tpu.types import CameraModel, StereoParams

    return StereoParams(
        cam1=CameraModel(*(jnp.asarray(x) for x in st[0:3])),
        cam2=CameraModel(*(jnp.asarray(x) for x in st[3:6])),
        t_c2_c1=jnp.asarray(st[6]),
    )


def to_port(tree):
    """A JAX NamedTuple tree (types, StereoPoseResult, RegistrationResult)
    as the port's NamedTuple of the same class name, leaf by leaf through
    numpy."""
    from cylinder_pose_estimation_tpu_torch import types
    from cylinder_pose_estimation_tpu_torch.models import pipeline

    if not isinstance(tree, tuple):
        return torch.as_tensor(np.asarray(tree))
    name = type(tree).__name__
    cls = getattr(types, name, None) or getattr(pipeline, name)
    return cls(*[to_port(leaf) for leaf in tree])


# ---------------------------------------------------------------------------
# The detection corpora (tests/test_torch_corpus_*.py): each port branch held
# to the same branch of the JAX package on the same float32 image.

# The contract outside the chaotic window: ids identical, xy within
# CORPUS_XY_TOL px, the fence flags and counts equal, max_line_tilt within
# CORPUS_TILT_TOL rad.  Inside it (tests/test_stability.py:1-8) only ``ok``,
# ``stable`` and max_line_tilt are compared.
CORPUS_XY_TOL = 1e-3
CORPUS_TILT_TOL = 1e-5
BRANCHES = ("xla", "kernels")


def jax_config(h: int, w: int, branch: str, plane: bool = False, **kw):
    """The JAX package's detect config of a branch (the kernel branch in
    Pallas interpret mode, as that package's CPU tests run it)."""
    from cylinder_pose_estimation_tpu import config

    cls = config.PlaneDetectConfig if plane else config.CylinderDetectConfig
    kernels = branch == "kernels"
    return cls(height=h, width=w, use_pallas=kernels, pallas_interpret=kernels, **kw)


@functools.lru_cache(maxsize=None)
def _jax_detect_fn(cfg):
    import jax

    from cylinder_pose_estimation_tpu.models.detector import detect_grid

    return jax.jit(lambda im: detect_grid(im, cfg))


def jax_detect(img, cfg):
    """JAX ``detect_grid`` of one (H, W) image, jitted once per config."""
    import jax.numpy as jnp

    return _jax_detect_fn(cfg)(jnp.asarray(np.asarray(img, np.float32)))


def port_detect(imgs, cfg):
    """The port's ``detect_grid`` on the CPU of (H, W) or (V, H, W) float32
    images under a JAX config."""
    from cylinder_pose_estimation_tpu_torch.config import from_reference
    from cylinder_pose_estimation_tpu_torch.models.detector import detect_grid

    x = torch.as_tensor(np.array(imgs, np.float32))
    return detect_grid(x if x.dim() == 3 else x[None], from_reference(cfg))


def grid_map(det, i=None) -> dict:
    """{(id0, id1): xy} of a DetectResult: a JAX one (``i=None``) or view i
    of the port's batched one."""
    pick = (lambda a: np.asarray(a)) if i is None else (lambda a: a[i].numpy())
    xy, idx, v = pick(det.grid.xy), pick(det.grid.idx), pick(det.grid.valid)
    return {(int(idx[k, 0]), int(idx[k, 1])): xy[k].astype(np.float64) for k in range(len(v)) if v[k]}


def det_flags(det, i=None) -> dict:
    get = (lambda a: np.asarray(a).item()) if i is None else (lambda a: a[i].item())
    return {f: get(getattr(det, f))
            for f in ("ok", "stable", "labels_converged", "bridged_components", "max_line_tilt")}


def hold_to_jax(got, want, i: int = 0, chaotic: bool = False, budget=(0, 0.0), label: str = "") -> dict:
    """View i of the port's DetectResult against the JAX one by the corpus
    contract.  ``budget`` (count, px): at most ``count`` points may pass
    CORPUS_XY_TOL, none past ``px`` (a scene's own float32 budget, ROADMAP
    section 3).  Returns the points, the largest move, the points over the
    tolerance and, inside the chaotic window, the id-set difference."""
    g, w = grid_map(got, i), grid_map(want)
    fg, fw = det_flags(got, i), det_flags(want)
    assert abs(fg.pop("max_line_tilt") - fw.pop("max_line_tilt")) <= CORPUS_TILT_TOL, (label, fg, fw)
    if chaotic:
        assert (fg["ok"], fg["stable"]) == (fw["ok"], fw["stable"]), (label, fg, fw)
        diff = len(set(g) ^ set(w))
        print(f"{label}: chaotic window, {len(w)} JAX points, id sets differ by {diff}")
        return {"n": len(w), "id_diff": diff}
    assert fg == fw, (label, fg, fw)
    assert set(g) == set(w), (label, sorted(set(g) - set(w)), sorted(set(w) - set(g)))
    d = np.array([np.abs(g[k] - w[k]).max() for k in w]) if w else np.zeros(0)
    over = int((d > CORPUS_XY_TOL).sum())
    d_max = float(d.max()) if d.size else 0.0
    count, px = budget
    assert over <= count and (over == 0 or d_max <= px), (label, over, d_max, budget)
    return {"n": len(w), "max_dxy": d_max, "over": over}
