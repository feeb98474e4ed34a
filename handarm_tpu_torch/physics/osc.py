"""Operational-space control on the engine's dynamics (counterpart of
handarm_tpu/physics/osc.py; reference IsaacGymEnvs franka_cube_stack.py
`_compute_osc_torques`).

Joint torques that realize a desired 6D end-effector acceleration through
the task-space inertia Lambda = (J Minv J^T)^-1, with null-space posture
servoing projected through (I - J^T Jbar^T). Plain torch ops on [B, ...]
tensors. The inverse and the solve take the `_ex` forms without their
error checks: no device-to-host sync a step, and a singular or non-finite
matrix gives non-finite torques (the env's `finite` check resets that env)
where the checked forms would raise.
"""

from __future__ import annotations

import math

import torch

from handarm_tpu_torch.math.quat import cross


def eef_jacobian(m, fk, body_idx: int, p_eef: torch.Tensor) -> torch.Tensor:
    """Spatial 6D Jacobian of a point p_eef [B, 3] on body `body_idx`: [B,
    6, nv] with rows (linear; angular), J_lin[:, u] = s_lin + s_ang x p and
    J_rot = s_ang, masked to the body's ancestor dofs."""
    anc = m.ancestor_mask[body_idx]  # [nv]
    s_ang, s_lin = fk.screw[..., :3], fk.screw[..., 3:]
    J_lin = s_lin + cross(s_ang, p_eef[:, None, :].expand_as(s_ang))
    J = torch.cat([J_lin, s_ang], dim=-1)  # [B, nv, 6]
    return (J * anc[None, :, None]).transpose(1, 2)


def osc_torques(Minv: torch.Tensor, J: torch.Tensor, dpose: torch.Tensor,
                eef_vel: torch.Tensor, q: torch.Tensor, qd: torch.Tensor,
                q_default: torch.Tensor, kp: float = 150.0, kp_null: float = 10.0,
                arm_mask: torch.Tensor | None = None, eps: float = 1e-6) -> torch.Tensor:
    """tau = J^T Lambda (kp dpose - kd eef_vel) + (I - J^T Jbar^T) M u_null,
    kd = 2 sqrt(kp): Minv [B, nv, nv], J [B, 6, nv] (the arm's columns),
    dpose and eef_vel [B, 6], q and qd [B, nv], q_default [nv], arm_mask
    [nv] (1 on the arm's dofs). The posture error wraps to [-pi, pi)."""
    kd = 2.0 * math.sqrt(kp)
    kd_null = 2.0 * math.sqrt(kp_null)
    m_eef_inv = torch.einsum("bij,bjk,blk->bil", J, Minv, J)  # [B, 6, 6]
    eye = torch.eye(6, dtype=J.dtype, device=J.device)
    m_eef = torch.linalg.inv_ex(m_eef_inv + eps * eye, check_errors=False).inverse
    u = torch.einsum("bji,bjk,bk->bi", J, m_eef, kp * dpose - kd * eef_vel)  # [B, nv]
    # null-space posture torque; remainder (not fmod) keeps the divisor's sign
    q_err = torch.remainder(q_default[None] - q + math.pi, 2 * math.pi) - math.pi
    u_null = kd_null * -qd + kp_null * q_err
    if arm_mask is not None:
        u_null = u_null * arm_mask[None]
    # M u_null through the same Minv, then projected
    Mu = torch.linalg.solve_ex(Minv, u_null[..., None], check_errors=False).result[..., 0]
    j_eef_inv = torch.einsum("bij,bjk,bkl->bil", m_eef, J, Minv)  # [B, 6, nv]
    return u + Mu - torch.einsum("bji,bjk,bk->bi", J, j_eef_inv, Mu)
