"""Batched forward kinematics for compiled articulations (counterpart of
handarm_tpu/physics/kinematics.py): fixed-base models, and floating-base
ones, whose dofs 0-5 are the base's world-frame translations and
rotations and whose base body (body 0) takes its pose from the state."""

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
    """Device-resident view of an Articulation (unbatched). Fixed base: nb
    == nv and dof i drives body i. Floating base: nb < nv, dofs 0-5 move
    body 0 and joint dof i drives body dof_body[i]."""

    tree_pos: torch.Tensor  # [nv, 3]
    tree_quat: torch.Tensor  # [nv, 4]
    axis: torch.Tensor  # [nv, 3]
    mass: torch.Tensor  # [nb]
    com: torch.Tensor  # [nb, 3]
    inertia: torch.Tensor  # [nb, 3, 3]
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
    joint_type: np.ndarray
    nv: int
    nb: int = 0
    floating: bool = False
    dof_body: np.ndarray | None = None  # [nv] body each dof drives (0 for the base dofs)
    body_parent: np.ndarray | None = None  # [nb] parent body, -1 = world
    body_dof: np.ndarray | None = None  # [nb] the dof driving each body (-1: the base)


def model_arrays(art: Articulation, dtype=torch.float32,
                 device="cpu") -> ModelArrays:
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    nv, nb = art.nv, art.nb
    dof_body = (np.asarray(art.dof_body) if art.dof_body is not None
                else np.arange(nv, dtype=np.int32))
    body_parent = (np.asarray(art.body_parent) if art.body_parent is not None
                   else np.asarray(art.parent))
    body_dof = (np.asarray(art.body_dof) if art.body_dof is not None
                else np.arange(nb, dtype=np.int32))
    I_np = np.asarray(art.inertia, dtype=np.float64)
    w, V = np.linalg.eigh(0.5 * (I_np + np.swapaxes(I_np, -1, -2)))
    chol_np = V * np.sqrt(np.maximum(w, 0.0))[..., None, :]
    body_anc = np.zeros((nb, nb), np.float32)
    for n in range(nb):
        b = n
        while b >= 0:
            body_anc[n, b] = 1.0
            b = int(body_parent[b])
    return ModelArrays(
        tree_pos=f(art.tree_pos), tree_quat=f(art.tree_quat), axis=f(art.axis),
        mass=f(art.mass), com=f(art.com), inertia=f(art.inertia),
        q_min=f(art.q_min), q_max=f(art.q_max),
        effort_limit=f(art.effort_limit),
        velocity_limit=f(art.velocity_limit),
        joint_damping=f(art.joint_damping), armature=f(art.armature),
        ancestor_mask=f(art.ancestor_mask), inertia_chol=f(chol_np),
        body_anc=f(body_anc),
        joint_type=np.asarray(art.joint_type),
        nv=nv, nb=nb, floating=bool(art.floating), dof_body=dof_body,
        body_parent=body_parent, body_dof=body_dof,
    )


class FK(NamedTuple):
    """World-frame kinematics for every moving body; batch-leading shapes."""

    body_quat: torch.Tensor  # [B, nb, 4]
    body_pos: torch.Tensor  # [B, nb, 3]
    screw: torch.Tensor  # [B, nv, 6] world Plücker joint screws (ang, lin)


def forward_kinematics(m: ModelArrays, q: torch.Tensor,
                       base_quat: torch.Tensor,
                       base_pos: torch.Tensor) -> FK:
    """q: [B, nv]; base pose [B or 1, 4] / [B or 1, 3]: of the fixed base
    frame, or (floating) of the base body itself."""
    B = q.shape[0]
    base_quat = base_quat.expand(B, 4)
    base_pos = base_pos.expand(B, 3)
    nb = m.nb or m.nv
    quats, poss, screws = [None] * nb, [None] * nb, [None] * m.nv
    start = 0
    if m.floating:
        # the base body's pose comes from the state; the 6 base dofs have
        # constant world screws: translations (0, e_k), rotations about
        # axes through the world origin (e_k, 0)
        quats[0], poss[0] = base_quat, base_pos
        eye = torch.eye(3, dtype=q.dtype, device=q.device)
        z = q.new_zeros(B, 3)
        for k in range(3):
            e_k = eye[k].expand(B, 3)
            screws[k] = torch.cat([z, e_k], dim=-1)
            screws[3 + k] = torch.cat([e_k, z], dim=-1)
        start = 6
    for i in range(start, m.nv):
        b = int(m.dof_body[i])
        p = int(m.body_parent[b])
        pq = base_quat if p < 0 else quats[p]
        pp = base_pos if p < 0 else poss[p]
        jq = quat_mul(pq, m.tree_quat[i].expand(B, 4))
        jp = pp + quat_rotate(pq, m.tree_pos[i].expand(B, 3))
        axis_b = m.axis[i].expand(B, 3)
        if m.joint_type[i] == REVOLUTE:
            bq = quat_mul(jq, quat_from_axis_angle(axis_b, q[:, i]))
            bp = jp
            a_w = quat_rotate(bq, axis_b)
            screws[i] = torch.cat([a_w, cross(bp, a_w)], dim=-1)
        elif m.joint_type[i] == PRISMATIC:
            bq = jq
            a_w = quat_rotate(bq, axis_b)
            bp = jp + a_w * q[:, i:i + 1]
            screws[i] = torch.cat([torch.zeros_like(a_w), a_w], dim=-1)
        else:
            raise NotImplementedError(m.joint_type[i])
        quats[b] = bq
        poss[b] = bp
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
