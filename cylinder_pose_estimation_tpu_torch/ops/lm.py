"""Fixed-iteration Levenberg-Marquardt over a batch of small problems.

Port of the JAX package's ops/lm.py.  The iteration count is fixed and there
is no early exit, so every problem of the batch takes the same steps and the
loop is free of host synchronisation.  The Jacobian is a closed-form function
(``jac_fn``); the port has no autodiff path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from cylinder_pose_estimation_tpu_torch.ops.linalg import mm, solve_spd


class LMResult(NamedTuple):
    params: torch.Tensor      # (..., P)
    cost0: torch.Tensor       # (...)
    cost: torch.Tensor        # (...)
    n_accepted: torch.Tensor  # (...) int32


def levenberg_marquardt(
    residual_fn: Callable[[torch.Tensor], torch.Tensor],
    params0: torch.Tensor,
    jac_fn: Callable[[torch.Tensor], torch.Tensor],
    weights: torch.Tensor | None = None,
    iters: int = 60,
    lambda0: float = 1e-3,
    lambda_up: float = 2.0,
    lambda_down: float = 3.0,
) -> LMResult:
    """Minimise sum(w * r(p)^2) with ``iters`` LM steps.

    residual_fn: (..., P) -> (..., N); jac_fn: (..., P) -> (..., N, P)."""
    dtype = params0.dtype
    r0 = residual_fn(params0)
    w = torch.ones_like(r0) if weights is None else weights.to(dtype)

    def cost_of(r):
        return torch.sum(w * r * r, dim=-1)

    cost0 = cost_of(r0)
    p_dim = params0.shape[-1]
    eye = torch.eye(p_dim, dtype=dtype, device=params0.device)
    p, r, cost = params0, r0, cost0
    lam = torch.full_like(cost0, lambda0)
    n_acc = torch.zeros(cost0.shape, dtype=torch.int32, device=cost0.device)
    for _ in range(iters):
        j = jac_fn(p)
        jw = j * w[..., :, None]
        jt = j.transpose(-1, -2)
        jtj = mm(jt, jw)
        jtr = mm(jw.transpose(-1, -2), r[..., None])[..., 0]
        damp = lam[..., None] * (torch.diagonal(jtj, dim1=-2, dim2=-1) + 1e-12)
        delta = solve_spd(jtj + damp[..., None] * eye, -jtr)
        p_new = p + delta
        r_new = residual_fn(p_new)
        cost_new = cost_of(r_new)
        accept = (cost_new < cost) & torch.all(torch.isfinite(p_new), dim=-1)
        p = torch.where(accept[..., None], p_new, p)
        r = torch.where(accept[..., None], r_new, r)
        cost = torch.where(accept, cost_new, cost)
        lam = torch.where(accept, lam / lambda_down, lam * lambda_up)
        lam = torch.clamp(lam, 1e-12, 1e12)
        n_acc = n_acc + accept.to(torch.int32)
    return LMResult(params=p, cost0=cost0, cost=cost, n_accepted=n_acc)
