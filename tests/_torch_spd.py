"""Small SPD systems for the tests of ``ops/linalg.solve_spd`` (numpy makes
them; the card tests and the CPU tests share them)."""

import numpy as np
import torch

KINDS = ("graded", "damped", "zero", "singular", "nan", "inf")


def spd_systems(p, lead, dtype, kind, seed=0, device="cpu"):
    """(a, b): (*lead, p, p) systems of one ``kind`` and (*lead, p)
    right-hand sides.  graded: eigenvalues 1e-6 .. 1e6 under columns scaled
    1 .. 1e3 (as ``test_torch_fit._spd_case``); damped: the LM's
    jtj + lam (diag(jtj) + 1e-12) I at lam 1e-12 .. 1e12 over columns
    1e-3 .. 1e3; zero; singular (rank one); nan and inf: SPD systems with
    such entries in some (and a NaN right-hand side in one)."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(lead, dtype=np.int64))
    eye = np.eye(p)
    if kind == "graded":
        q, _ = np.linalg.qr(rng.normal(size=(n, p, p)))
        a = (q * np.geomspace(1e-6, 1e6, p)[None, None, :]) @ np.swapaxes(q, -1, -2)
        s = np.geomspace(1.0, 1e3, p)
        a = a * s[None, :, None] * s[None, None, :]
    elif kind == "damped":
        j = rng.normal(size=(n, 4 * p + 8, p)) * np.geomspace(1e-3, 1e3, p)
        jtj = np.swapaxes(j, -1, -2) @ j
        lam = 10.0 ** rng.uniform(-12, 12, (n, 1))
        a = jtj + (lam * (np.diagonal(jtj, axis1=-2, axis2=-1) + 1e-12))[..., None] * eye
    elif kind == "zero":
        a = np.zeros((n, p, p))
    elif kind == "singular":
        v = rng.normal(size=(n, p, 1))
        a = v @ np.swapaxes(v, -1, -2)
    elif kind in ("nan", "inf"):
        m = rng.normal(size=(n, p, p))
        a = m @ np.swapaxes(m, -1, -2) + eye
        bad = np.nan if kind == "nan" else np.inf
        if n:
            a[::2, rng.integers(p), rng.integers(p)] = bad
            a[1::3, 0, 0] = bad if kind == "nan" else -bad
    else:
        raise ValueError(kind)
    b = rng.normal(size=(n, p))
    if kind == "nan" and n > 1:
        b[1, 0] = np.nan
    return (torch.as_tensor(a.reshape(*lead, p, p), dtype=dtype, device=device),
            torch.as_tensor(b.reshape(*lead, p), dtype=dtype, device=device))


def bits(t):
    """The bit patterns of a float32 or float64 tensor: equal bits are equal
    values, NaN and infinities included."""
    return t.view(torch.int32 if t.dtype == torch.float32 else torch.int64)
