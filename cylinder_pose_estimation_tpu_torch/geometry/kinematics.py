"""Pan/tilt AGV -> cylinder forward kinematics (port of the JAX package's
geometry/kinematics.py; ref utils/getTAGVcyl.m:8-38).

The chain, as the reference composes it: pan rotation about z, the fixed
offset [-l2, 0, 0] to the tilt joint, the tilt-motor z translation
-tan(tilt) * |l2|, the rotation about y by -tilt, and the fixed tool
transform [0 -1 0 l1; -1 0 0 0; 0 0 -1 h].  Vectorised over the broadcast
leading axes of (pan, tilt).  The lengths are device constants made once
(``ops.constants``), so a CUDA graph captures the chain.
"""

from __future__ import annotations

import torch

from cylinder_pose_estimation_tpu_torch.config import KinematicsConfig
from cylinder_pose_estimation_tpu_torch.ops.constants import device_constant
from cylinder_pose_estimation_tpu_torch.ops.linalg import mm


def _mat(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def t_agv_cyl(
    pan: torch.Tensor, tilt: torch.Tensor, config: KinematicsConfig = KinematicsConfig()
) -> torch.Tensor:
    """pan, tilt in radians (broadcastable tensors) -> (..., 4, 4) T_AGV_cyl
    on their device, in float32 (float64 for float64 input)."""
    pan = torch.as_tensor(pan)
    tilt = torch.as_tensor(tilt, device=pan.device)
    dtype = torch.promote_types(torch.promote_types(pan.dtype, tilt.dtype), torch.float32)
    pan, tilt = torch.broadcast_tensors(pan.to(dtype), tilt.to(dtype))

    cp, sp = torch.cos(pan), torch.sin(pan)
    ct, st = torch.cos(-tilt), torch.sin(-tilt)
    zero = torch.zeros_like(pan)
    one = torch.ones_like(pan)

    t_a_p = _mat([
        [cp, -sp, zero, zero],
        [sp, cp, zero, zero],
        [zero, zero, one, zero],
        [zero, zero, zero, one],
    ])
    l2 = device_constant(config.l2, dtype, pan.device)
    t_p_t0 = _mat([
        [one, zero, zero, -l2 * one],
        [zero, one, zero, zero],
        [zero, zero, one, zero],
        [zero, zero, zero, one],
    ])
    # Tilt-motor z translation: -tan(tilt) * |T_P_T0 offset| (ref :27-30).
    mtr_move = -torch.tan(tilt) * torch.abs(l2)
    t_t0_t1 = _mat([
        [one, zero, zero, zero],
        [zero, one, zero, zero],
        [zero, zero, one, mtr_move],
        [zero, zero, zero, one],
    ])
    t_t1_t2 = _mat([
        [ct, zero, st, zero],
        [zero, one, zero, zero],
        [-st, zero, ct, zero],
        [zero, zero, zero, one],
    ])
    l1 = device_constant(config.l1, dtype, pan.device)
    h = device_constant(config.h, dtype, pan.device)
    t_t2_cyl = _mat([
        [zero, -one, zero, l1 * one],
        [-one, zero, zero, zero],
        [zero, zero, -one, h * one],
        [zero, zero, zero, one],
    ])
    return mm(mm(mm(mm(t_a_p, t_p_t0), t_t0_t1), t_t1_t2), t_t2_cyl)
