"""Batched forward kinematics for compiled articulations (counterpart of
handarm_tpu/physics/kinematics.py, fixed-base models)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import (
    cross,
    quat_from_axis_angle,
    quat_mul,
    quat_rotate,
)
from handarm_tpu_torch.physics.model import PRISMATIC, REVOLUTE, Articulation


@dataclass
class ModelArrays:
    """Device-resident view of a fixed-base Articulation (unbatched)."""

    tree_pos: torch.Tensor  # [nv, 3]
    tree_quat: torch.Tensor  # [nv, 4]
    axis: torch.Tensor  # [nv, 3]
    mass: torch.Tensor  # [nv]
    com: torch.Tensor  # [nv, 3]
    inertia: torch.Tensor  # [nv, 3, 3]
    q_min: torch.Tensor
    q_max: torch.Tensor
    effort_limit: torch.Tensor
    velocity_limit: torch.Tensor
    joint_damping: torch.Tensor
    armature: torch.Tensor
    ancestor_mask: torch.Tensor  # [nb, nv]
    # [nb, 3, 3] symmetric square root of the body-frame COM inertia
    inertia_chol: torch.Tensor
    # [nb, nb] body_anc[n, b] = 1 iff body b is ancestor-or-self of body n
    body_anc: torch.Tensor
    # static topology (numpy: python loops unroll over it)
    parent: np.ndarray
    joint_type: np.ndarray
    nv: int


def model_arrays(art: Articulation, dtype=torch.float32,
                 device="cpu") -> ModelArrays:
    if art.floating:
        raise NotImplementedError("the port supports fixed-base models only")
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    I_np = np.asarray(art.inertia, dtype=np.float64)
    w, V = np.linalg.eigh(0.5 * (I_np + np.swapaxes(I_np, -1, -2)))
    chol_np = V * np.sqrt(np.maximum(w, 0.0))[..., None, :]
    # fixed base: body b is driven by dof b, so body b's ancestor bodies are
    # the dofs that move it
    body_anc = np.asarray(art.ancestor_mask, np.float32)
    return ModelArrays(
        tree_pos=f(art.tree_pos), tree_quat=f(art.tree_quat), axis=f(art.axis),
        mass=f(art.mass), com=f(art.com), inertia=f(art.inertia),
        q_min=f(art.q_min), q_max=f(art.q_max),
        effort_limit=f(art.effort_limit),
        velocity_limit=f(art.velocity_limit),
        joint_damping=f(art.joint_damping), armature=f(art.armature),
        ancestor_mask=f(art.ancestor_mask), inertia_chol=f(chol_np),
        body_anc=f(body_anc),
        parent=np.asarray(art.parent), joint_type=np.asarray(art.joint_type),
        nv=art.nv,
    )


class FK(NamedTuple):
    """World-frame kinematics for every moving body; batch-leading shapes."""

    body_quat: torch.Tensor  # [B, nb, 4]
    body_pos: torch.Tensor  # [B, nb, 3]
    screw: torch.Tensor  # [B, nv, 6] world Plücker joint screws (ang, lin)


def forward_kinematics(m: ModelArrays, q: torch.Tensor,
                       base_quat: torch.Tensor,
                       base_pos: torch.Tensor) -> FK:
    """q: [B, nv]; base pose [B or 1, 4] / [B or 1, 3] of the fixed base."""
    B = q.shape[0]
    base_quat = base_quat.expand(B, 4)
    base_pos = base_pos.expand(B, 3)
    quats, poss, screws = [], [], []
    for i in range(m.nv):
        p = int(m.parent[i])
        pq = base_quat if p < 0 else quats[p]
        pp = base_pos if p < 0 else poss[p]
        jq = quat_mul(pq, m.tree_quat[i].expand(B, 4))
        jp = pp + quat_rotate(pq, m.tree_pos[i].expand(B, 3))
        axis_b = m.axis[i].expand(B, 3)
        if m.joint_type[i] == REVOLUTE:
            bq = quat_mul(jq, quat_from_axis_angle(axis_b, q[:, i]))
            bp = jp
            a_w = quat_rotate(bq, axis_b)
            screws.append(torch.cat([a_w, cross(bp, a_w)], dim=-1))
        elif m.joint_type[i] == PRISMATIC:
            bq = jq
            a_w = quat_rotate(bq, axis_b)
            bp = jp + a_w * q[:, i:i + 1]
            screws.append(torch.cat([torch.zeros_like(a_w), a_w], dim=-1))
        else:
            raise NotImplementedError(m.joint_type[i])
        quats.append(bq)
        poss.append(bp)
    return FK(torch.stack(quats, 1), torch.stack(poss, 1),
              torch.stack(screws, 1))


def body_velocities(m: ModelArrays, fk: FK, qd: torch.Tensor) -> torch.Tensor:
    """Spatial velocity of each moving body: v_i = sum_{j anc i} s_j qd_j."""
    sv = fk.screw * qd[..., None]  # [B, nv, 6]
    return torch.einsum("nj,bja->bna", m.ancestor_mask, sv)


def site_poses(fk: FK, site_body: np.ndarray, site_pos: torch.Tensor,
               site_quat: torch.Tensor, base_quat: torch.Tensor,
               base_pos: torch.Tensor):
    """World poses of named sites; site_body [S] may be -1 for the base.
    Returns (quat [B, S, 4], pos [B, S, 3])."""
    B = fk.body_pos.shape[0]
    bq = torch.cat([fk.body_quat, base_quat.expand(B, 4)[:, None]], 1)
    bp = torch.cat([fk.body_pos, base_pos.expand(B, 3)[:, None]], 1)
    idx = torch.as_tensor(
        np.where(site_body < 0, fk.body_pos.shape[1], site_body),
        device=fk.body_pos.device,
    )
    pq, pp = bq[:, idx], bp[:, idx]
    return quat_mul(pq, site_quat[None].expand_as(pq)), pp + quat_rotate(
        pq, site_pos[None].expand_as(pp)
    )


def point_jacobian(m: ModelArrays, fk: FK, body_idx: torch.Tensor,
                   point_world: torch.Tensor) -> torch.Tensor:
    """J[..., u] = anc[body, u] (s_lin_u + s_ang_u x p): [B, C, 3, nv]."""
    s_ang = fk.screw[..., :3]
    s_lin = fk.screw[..., 3:]
    vel = s_lin[:, None] + cross(s_ang[:, None], point_world[:, :, None, :])
    mask = m.ancestor_mask[body_idx]  # [B, C, nv]
    return (vel * mask[..., None]).transpose(-1, -2)
