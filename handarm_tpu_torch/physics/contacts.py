"""Vectorized contact generation into fixed-size masked slot buffers
(counterpart of handarm_tpu/physics/contacts.py without the heightfield).

Every potential contact pair owns a static slot; a step only fills
(normal, pos, depth). Slot layout for K objects with P sample points and S
robot spheres: object points vs table [K*P], spheres vs table [S], spheres
vs object SDFs [S*K], object-pair points [K*(K-1)*Q], then with walls:
object points vs nearest wall [K*P] and spheres vs nearest wall [S].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import quat_rotate, quat_rotate_inv
from handarm_tpu_torch.physics.shapes import ObjectShapes, object_sdf


@dataclass
class StaticGeom:
    """A table box top over a ground plane at z = 0, plus wall AABBs."""

    table_lo: torch.Tensor  # [2]
    table_hi: torch.Tensor  # [2]
    table_height: float
    wall_lo: np.ndarray  # [W, 3]
    wall_hi: np.ndarray  # [W, 3]

    @property
    def num_walls(self) -> int:
        return int(np.asarray(self.wall_lo).shape[0])


@dataclass
class RobotSpheres:
    body: np.ndarray  # [S] moving-body index (static)
    offset: torch.Tensor  # [S, 3] centre in body frame
    radius: torch.Tensor  # [S]
    friction: np.ndarray  # [S]


class ContactSlots(NamedTuple):
    robot_body: np.ndarray  # [C] moving-body index or -1
    obj_a: np.ndarray  # [C] object receiving +normal impulse, or -1
    obj_b: np.ndarray  # [C] object receiving -normal impulse, or -1
    friction: np.ndarray  # [C]
    num_slots: int


class Contacts(NamedTuple):
    normal: torch.Tensor  # [B, C, 3] from the B side toward the A side
    pos: torch.Tensor  # [B, C, 3]
    depth: torch.Tensor  # [B, C] > 0 penetrating


def make_contact_slots(shapes: ObjectShapes, spheres: RobotSpheres,
                       static_friction: float = 1.0, obj_pair_points: int = 8,
                       num_walls: int = 0) -> ContactSlots:
    K = shapes.num_objects
    P = shapes.points_per_object
    S = spheres.body.shape[0]
    Q = min(obj_pair_points, P)
    fr_obj = shapes.friction.cpu().numpy()
    fr_sph = np.asarray(spheres.friction)
    rb, oa, ob, fr = [], [], [], []

    def add(r, a, b, f, n=1):
        rb.extend([r] * n)
        oa.extend([a] * n)
        ob.extend([b] * n)
        fr.extend([f] * n)

    for k in range(K):
        add(-1, k, -1, np.sqrt(fr_obj[k] * static_friction), P)
    for s in range(S):
        add(int(spheres.body[s]), -1, -1, np.sqrt(fr_sph[s] * static_friction))
    for s in range(S):
        for k in range(K):
            add(int(spheres.body[s]), -1, k, np.sqrt(fr_sph[s] * fr_obj[k]))
    for ka in range(K):
        for kb in range(K):
            if ka != kb:
                add(-1, ka, kb, np.sqrt(fr_obj[ka] * fr_obj[kb]), Q)
    if num_walls > 0:
        for k in range(K):
            add(-1, k, -1, np.sqrt(fr_obj[k] * static_friction), P)
        for s in range(S):
            add(int(spheres.body[s]), -1, -1, np.sqrt(fr_sph[s] * static_friction))
    return ContactSlots(
        robot_body=np.array(rb, dtype=np.int32), obj_a=np.array(oa, dtype=np.int32),
        obj_b=np.array(ob, dtype=np.int32), friction=np.array(fr, dtype=np.float32),
        num_slots=len(fr),
    )


def _static_surface(geom: StaticGeom, p: torch.Tensor):
    """Signed distance to the table top (or the ground), upward normal."""
    xy = p[..., :2]
    in_col = torch.all((xy >= geom.table_lo) & (xy <= geom.table_hi), dim=-1)
    surf_z = torch.where(in_col, torch.full_like(p[..., 2], geom.table_height),
                         torch.zeros_like(p[..., 2]))
    n = torch.zeros_like(p)
    n[..., 2] = 1.0
    return p[..., 2] - surf_z, n


def _one_wall_surface(lo: torch.Tensor, hi: torch.Tensor, p: torch.Tensor):
    """Signed distance + outward normal to one AABB."""
    q = torch.minimum(torch.maximum(p, lo), hi)
    d_vec = p - q
    d_sq = torch.sum(d_vec * d_vec, dim=-1)
    dist_out = torch.sqrt(d_sq + 1e-20)
    outside = d_sq > 1e-18
    n_out = d_vec * torch.rsqrt(d_sq[..., None] + 1e-18)
    push_lo, push_hi = p - lo, hi - p
    push = torch.minimum(push_lo, push_hi)
    one, mone = p.new_tensor(1.0), p.new_tensor(-1.0)
    n_in = torch.zeros_like(p)
    n_in[..., 0] = torch.where(push_lo[..., 0] <= push_hi[..., 0], mone, one)
    best = push[..., 0]
    for a in (1, 2):
        closer = push[..., a] < best
        cand = torch.zeros_like(p)
        cand[..., a] = torch.where(push_lo[..., a] <= push_hi[..., a], mone, one)
        n_in = torch.where(closer[..., None], cand, n_in)
        best = torch.minimum(best, push[..., a])
    dist = torch.where(outside, dist_out, -best)
    return dist, torch.where(outside[..., None], n_out, n_in)


def _wall_surface(geom: StaticGeom, p: torch.Tensor):
    lo = torch.as_tensor(geom.wall_lo, dtype=p.dtype, device=p.device)
    hi = torch.as_tensor(geom.wall_hi, dtype=p.dtype, device=p.device)
    dist, n = _one_wall_surface(lo[0], hi[0], p)
    for w in range(1, lo.shape[0]):
        dw, nw = _one_wall_surface(lo[w], hi[w], p)
        closer = dw < dist
        dist = torch.where(closer, dw, dist)
        n = torch.where(closer[..., None], nw, n)
    return dist, n


def generate_contacts(slots: ContactSlots, shapes: ObjectShapes,
                      spheres: RobotSpheres, geom: StaticGeom, obj_pos, obj_quat,
                      body_quat, body_pos, obj_pair_points: int = 8) -> Contacts:
    B, K, _ = obj_pos.shape
    P = shapes.points_per_object
    S = spheres.body.shape[0]
    Q = min(obj_pair_points, P)
    normals, poss, depths = [], [], []
    big = torch.full((), 1e6, dtype=obj_pos.dtype, device=obj_pos.device)

    pts_w = obj_pos[:, :, None, :] + quat_rotate(
        obj_quat[:, :, None, :].expand(B, K, P, 4), shapes.points[None].expand(B, K, P, 3)
    )
    dist, n = _static_surface(geom, pts_w)
    dist = torch.where(shapes.point_mask[None] > 0, dist, big)
    normals.append(n.reshape(B, K * P, 3))
    poss.append((pts_w - n * dist[..., None]).reshape(B, K * P, 3))
    depths.append((shapes.point_radius[None] - dist).reshape(B, K * P))

    sb = torch.as_tensor(spheres.body, device=obj_pos.device)
    centers = body_pos[:, sb] + quat_rotate(
        body_quat[:, sb], spheres.offset[None].expand(B, S, 3)
    )
    dist_s, n_s = _static_surface(geom, centers)
    normals.append(n_s)
    poss.append(centers - n_s * dist_s[..., None])
    depths.append(spheres.radius[None] - dist_s)

    per_n, per_d, per_p = [], [], []
    for k in range(K):
        qk = obj_quat[:, k:k + 1, :].expand(B, S, 4)
        c_body = quat_rotate_inv(qk, centers - obj_pos[:, k:k + 1, :])
        d_k, g_k = object_sdf(shapes, k, c_body)
        n_w = quat_rotate(qk, g_k)
        per_n.append(n_w)
        per_d.append(spheres.radius[None] - d_k)
        per_p.append(centers - n_w * d_k[..., None])
    normals.append(torch.stack(per_n, 2).reshape(B, S * K, 3))
    depths.append(torch.stack(per_d, 2).reshape(B, S * K))
    poss.append(torch.stack(per_p, 2).reshape(B, S * K, 3))

    for ka in range(K):
        for kb in range(K):
            if ka == kb:
                continue
            pts_a = pts_w[:, ka, :Q]
            qb = obj_quat[:, kb:kb + 1, :].expand(B, Q, 4)
            d_ab, g_ab = object_sdf(
                shapes, kb, quat_rotate_inv(qb, pts_a - obj_pos[:, kb:kb + 1, :])
            )
            d_ab = torch.where(shapes.point_mask[ka, :Q][None] > 0, d_ab, big)
            normals.append(quat_rotate(qb, g_ab))
            poss.append(pts_a)
            depths.append(shapes.point_radius[ka, :Q][None] - d_ab)

    if geom.num_walls > 0:
        dist_w, n_w = _wall_surface(geom, pts_w)
        dist_w = torch.where(shapes.point_mask[None] > 0, dist_w, big)
        normals.append(n_w.reshape(B, K * P, 3))
        poss.append((pts_w - n_w * dist_w[..., None]).reshape(B, K * P, 3))
        depths.append((shapes.point_radius[None] - dist_w).reshape(B, K * P))
        dist_sw, n_sw = _wall_surface(geom, centers)
        normals.append(n_sw)
        poss.append(centers - n_sw * dist_sw[..., None])
        depths.append(spheres.radius[None] - dist_sw)

    return Contacts(torch.cat(normals, 1), torch.cat(poss, 1), torch.cat(depths, 1))
