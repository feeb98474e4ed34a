"""Batched articulated rigid-body dynamics, world frame, reduced coordinates
(counterpart of handarm_tpu/physics/dynamics.py), fixed- and floating-base.

Mass matrix as a COM-referenced Gram product, bias torques through one
ancestor-matrix prefix sum, stable PD folded into the inertia, and the
explicit inverse of the PD-augmented mass matrix from `ops.spd_inverse`
(a CUDA kernel on the card). Free objects stay in maximal coordinates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import (
    cross,
    quat_integrate,
    quat_rotate,
    quat_rotate_inv,
    quat_to_matrix,
)
from handarm_tpu_torch.math.spatial import force_cross, motion_cross
from handarm_tpu_torch.ops import spd_inverse as spd_op
from handarm_tpu_torch.physics.kinematics import FK, ModelArrays, body_velocities


class Dyn(NamedTuple):
    Mtilde: torch.Tensor  # [B, nv, nv] PD-augmented mass matrix
    Minv: torch.Tensor  # [B, nv, nv] its explicit inverse
    bias: torch.Tensor  # [B, nv] C(q, qd) + g(q)

    def solve(self, b: torch.Tensor) -> torch.Tensor:
        """Mtilde^-1 @ b for b: [B, nv]."""
        return torch.einsum("bij,bj->bi", self.Minv, b)


def body_coms_world(m: ModelArrays, fk: FK) -> torch.Tensor:
    return fk.body_pos + quat_rotate(fk.body_quat, m.com[None].expand_as(fk.body_pos))


def mass_matrix_com(m: ModelArrays, fk: FK, com_w: torch.Tensor) -> torch.Tensor:
    """M = G G^T with G[u, (n,:)] = anc[n,u] [sqrt(m_n) e_un, L_n^T R_n^T s_ang_u]."""
    B, nv = fk.screw.shape[:2]
    nb = com_w.shape[1]
    s_ang = fk.screw[..., :3]
    s_lin = fk.screw[..., 3:]
    e = s_lin[:, :, None, :] + cross(s_ang[:, :, None, :], com_w[:, None, :, :])
    w_body = quat_rotate_inv(
        fk.body_quat[:, None].expand(B, nv, nb, 4),
        s_ang[:, :, None].expand(B, nv, nb, 3),
    )
    hhat = torch.einsum("nji,bunj->buni", m.inertia_chol, w_body)
    mask = m.ancestor_mask.T  # [nv, nb]
    G = torch.cat([e * torch.sqrt(m.mass)[:, None], hhat], dim=-1)
    G = (G * mask[None, :, :, None]).reshape(B, nv, nb * 6)
    return torch.einsum("buk,bvk->buv", G, G)


def _apply_inertia_com(m: ModelArrays, fk: FK, com_w, mot):
    w, v = mot[..., :3], mot[..., 3:]
    v_com = v + cross(w, com_w)
    f = m.mass[:, None] * v_com
    Iw = quat_rotate(
        fk.body_quat,
        torch.einsum("nij,bnj->bni", m.inertia, quat_rotate_inv(fk.body_quat, w)),
    )
    return torch.cat([Iw + cross(com_w, f), f], dim=-1)


def bias_forces_com(m: ModelArrays, fk: FK, qd, gravity, com_w, body_vel):
    """Bias torques; the root->leaf velocity-product recursion is one prefix
    sum over the body-ancestor matrix. Body b's term is (v_b x s_i) qd_i of
    its driving dof i; a floating base body has none (its v x v = 0)."""
    B = qd.shape[0]
    a0 = torch.cat([qd.new_zeros(B, 3), (-gravity).expand(B, 3)], dim=-1)
    if m.floating:
        d = torch.as_tensor(m.body_dof[1:].astype(np.int64), device=qd.device)
        g = torch.cat([qd.new_zeros(B, 1, 6),
                       motion_cross(body_vel[:, 1:], fk.screw[:, d]) * qd[:, d, None]], dim=1)
    else:
        g = motion_cross(body_vel, fk.screw) * qd[..., None]  # body b <- dof b
    avp = a0[:, None, :] + torch.einsum("nm,bma->bna", m.body_anc, g)
    Iv = _apply_inertia_com(m, fk, com_w, body_vel)
    f = _apply_inertia_com(m, fk, com_w, avp) + force_cross(body_vel, Iv)
    fc = torch.einsum("nu,bni->bui", m.ancestor_mask, f)
    return torch.einsum("bui,bui->bu", fk.screw, fc)


def pd_augmented_mass(m: ModelArrays, M, kp, kd, h: float):
    """Mtilde = M + diag(armature + h*(kd + joint_damping) + h^2*kp)."""
    d = m.armature + h * (kd + m.joint_damping) + (h * h) * kp
    return M + torch.diag_embed(d.expand(M.shape[:-1]))


def stable_pd_torque(q, qd, q_target, kp, kd, h: float, effort_limit):
    tau = kp * (q_target - q - h * qd) - kd * qd
    return torch.clamp(tau, -effort_limit, effort_limit)


def compute_dyn(m: ModelArrays, fk: FK, qd, gravity, kp, kd, h: float) -> Dyn:
    com_w = body_coms_world(m, fk)
    body_vel = body_velocities(m, fk, qd)
    M = mass_matrix_com(m, fk, com_w)
    Mt = pd_augmented_mass(m, M, kp, kd, h)
    Minv = spd_op.spd_inverse(Mt.contiguous())
    bias = bias_forces_com(m, fk, qd, gravity, com_w, body_vel)
    return Dyn(Mtilde=Mt, Minv=Minv, bias=bias)


# --- free rigid bodies (objects), maximal coordinates ------------------------


def free_body_inv_inertia_world(quat, inertia_body_diag):
    """World-frame inverse rotational inertia [..., 3, 3]."""
    R = quat_to_matrix(quat)
    inv = 1.0 / torch.clamp(inertia_body_diag, min=1e-12)
    return torch.einsum("...ij,...j,...kj->...ik", R, inv.expand(R.shape[:-1]), R)


def free_body_integrate(pos, quat, linvel, angvel, h: float):
    return pos + h * linvel, quat_integrate(quat, angvel, h)


def gyroscopic_delta(quat, inertia_body_diag, angvel, h: float):
    """Implicit gyroscopic angular-velocity increment (one Newton step on
    the body-frame backward-Euler residual)."""
    w1 = quat_rotate_inv(quat, angvel)
    I = torch.clamp(inertia_body_diag, min=1e-12).expand_as(w1)
    Iw = I * w1
    f = h * cross(w1, Iw)

    def skew(v):
        z = torch.zeros_like(v[..., 0])
        return torch.stack(
            [
                torch.stack([z, -v[..., 2], v[..., 1]], -1),
                torch.stack([v[..., 2], z, -v[..., 0]], -1),
                torch.stack([-v[..., 1], v[..., 0], z], -1),
            ],
            -2,
        )

    eye = torch.eye(3, dtype=w1.dtype, device=w1.device)
    J = eye * I[..., None, :] + h * (skew(w1) * I[..., None, :] - skew(Iw))
    c0 = cross(J[..., :, 1], J[..., :, 2])
    c1 = cross(J[..., :, 2], J[..., :, 0])
    c2 = cross(J[..., :, 0], J[..., :, 1])
    det = torch.sum(J[..., :, 0] * c0, dim=-1, keepdim=True)
    adjT_f = torch.stack(
        [torch.sum(c0 * f, -1), torch.sum(c1 * f, -1), torch.sum(c2 * f, -1)], -1
    )
    dw_b = -adjT_f / torch.where(det.abs() > 1e-30, det, torch.full_like(det, 1e-30))
    return quat_rotate(quat, dw_b)
