"""Total-least-squares plane fitting (port of the JAX package's
geometry/plane.py): the normal is the least-variance eigenvector of the
masked point covariance, and the plane passes through the masked centroid."""

from __future__ import annotations

import torch

from cylinder_pose_estimation_tpu_torch.ops.linalg import masked_cov, masked_mean


def fit_plane(pts: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """pts (..., N, 3), valid (..., N) -> plane (..., 4) [nx, ny, nz, d] with
    unit n and n . x + d = 0.  The normal's sign is the eigensolver's."""
    cov = masked_cov(pts, valid)
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    normal = vecs[..., :, 0]
    d = -torch.sum(normal * masked_mean(pts, valid), dim=-1)
    return torch.cat([normal, d[..., None]], dim=-1)
