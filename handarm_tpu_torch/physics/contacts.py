"""Vectorized contact generation into fixed-size masked slot buffers
(counterpart of handarm_tpu/physics/contacts.py).

Every potential contact pair owns a static slot; a step only fills
(normal, pos, depth). Slot layout for K objects (K = 0: a robot alone,
whose slots are its spheres vs the table or ground) with P sample points and S
robot spheres: object points vs table [K*P], spheres vs table [S], spheres
vs object SDFs [S*K], object-pair points [K*(K-1)*Q], then with walls:
object points vs nearest wall [K*P] and spheres vs nearest wall [S].

The two object-SDF blocks (spheres vs objects, object-pair points) are
one row of L = S*K + K*(K-1)*Q queries per env, described once per scene
by `ObjectQueries`: one gather brings every query's world point into its
object's frame, and one `objects_sdf` pass (a single sdf_gather launch
for the mesh objects) samples them all.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import quat_rotate, quat_rotate_inv
from handarm_tpu_torch.physics.shapes import ObjectShapes, SdfQueries, objects_sdf, sdf_queries


@dataclass
class StaticGeom:
    """A table box top over a ground plane at z = 0, plus wall AABBs; or,
    when `hf_height` is set, a heightfield terrain in place of the table
    and the plane (`physics/terrain.py`), sampled bilinearly."""

    table_lo: torch.Tensor  # [2]
    table_hi: torch.Tensor  # [2]
    table_height: float
    wall_lo: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))  # [W, 3]
    wall_hi: np.ndarray = field(default_factory=lambda: np.zeros((0, 3), np.float32))  # [W, 3]
    hf_height: torch.Tensor | None = None  # [R, C] metres, on the scene's device
    hf_cell: float = 0.1  # metres per pixel
    hf_origin: torch.Tensor | None = None  # [2] world xy of pixel (0, 0)

    @property
    def num_walls(self) -> int:
        return int(np.asarray(self.wall_lo).shape[0])


@dataclass
class RobotSpheres:
    body: np.ndarray  # [S] moving-body index (static)
    offset: torch.Tensor  # [S, 3] centre in body frame
    radius: torch.Tensor  # [S]
    friction: np.ndarray  # [S]


class ObjectQueries(NamedTuple):
    """The object-SDF slots in slot order: query j takes row src[j] of
    [sphere centres S | object points K*Q] and samples object sdf.obj[j]."""

    src: torch.Tensor  # [L] int64
    radius: torch.Tensor  # [L] the sphere's or the object point's radius
    valid: torch.Tensor  # [L] bool: false on padded object points
    pair_points: int  # Q
    sdf: SdfQueries


class ContactSlots(NamedTuple):
    robot_body: np.ndarray  # [C] moving-body index or -1
    obj_a: np.ndarray  # [C] object receiving +normal impulse, or -1
    obj_b: np.ndarray  # [C] object receiving -normal impulse, or -1
    friction: np.ndarray  # [C]
    num_slots: int
    queries: ObjectQueries


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
    src, obj = [], []
    for s in range(S):
        for k in range(K):
            add(int(spheres.body[s]), -1, k, np.sqrt(fr_sph[s] * fr_obj[k]))
            src.append(s)
            obj.append(k)
    for ka in range(K):
        for kb in range(K):
            if ka != kb:
                add(-1, ka, kb, np.sqrt(fr_obj[ka] * fr_obj[kb]), Q)
                src.extend(S + ka * Q + np.arange(Q))
                obj.extend([kb] * Q)
    if num_walls > 0:
        for k in range(K):
            add(-1, k, -1, np.sqrt(fr_obj[k] * static_friction), P)
        for s in range(S):
            add(int(spheres.body[s]), -1, -1, np.sqrt(fr_sph[s] * static_friction))
    src_t = torch.as_tensor(np.array(src, dtype=np.int64), device=shapes.points.device)
    ones = torch.ones(S, dtype=torch.bool, device=src_t.device)
    queries = ObjectQueries(
        src=src_t,
        radius=torch.cat([spheres.radius, shapes.point_radius[:, :Q].reshape(-1)])[src_t],
        valid=torch.cat([ones, shapes.point_mask[:, :Q].reshape(-1) > 0])[src_t],
        pair_points=Q, sdf=sdf_queries(shapes, obj),
    )
    return ContactSlots(
        robot_body=np.array(rb, dtype=np.int32), obj_a=np.array(oa, dtype=np.int32),
        obj_b=np.array(ob, dtype=np.int32), friction=np.array(fr, dtype=np.float32),
        num_slots=len(fr), queries=queries,
    )


def heightfield_taps(H: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """The bilinear patch of the field H [R, C] at pixel coordinates (u, v),
    clamped to [0, R - 1.001] x [0, C - 1.001]: (h00, h10, h01, h11, fu,
    fv, h), the 4-tap gather, the fractions and the interpolated height."""
    R, Cc = H.shape
    u = torch.clamp(u, 0.0, R - 1.001)
    v = torch.clamp(v, 0.0, Cc - 1.001)
    u0, v0 = torch.floor(u), torch.floor(v)
    fu, fv = u - u0, v - v0
    flat = H.reshape(-1)
    idx = u0.long() * Cc + v0.long()
    h00, h10 = flat[idx], flat[idx + Cc]
    h01, h11 = flat[idx + 1], flat[idx + Cc + 1]
    h = h00 * (1 - fu) * (1 - fv) + h10 * fu * (1 - fv) + h01 * (1 - fu) * fv + h11 * fu * fv
    return h00, h10, h01, h11, fu, fv, h


def _heightfield_surface(geom: StaticGeom, p: torch.Tensor):
    """Signed distance and normal against the bilinear heightfield surface:
    a 4-tap gather per point (clamped to the field), the normal of the
    bilinear patch, and the vertical gap projected on it."""
    h00, h10, h01, h11, fu, fv, h = heightfield_taps(
        geom.hf_height, (p[..., 0] - geom.hf_origin[0]) / geom.hf_cell,
        (p[..., 1] - geom.hf_origin[1]) / geom.hf_cell)
    dhdx = ((h10 - h00) * (1 - fv) + (h11 - h01) * fv) / geom.hf_cell
    dhdy = ((h01 - h00) * (1 - fu) + (h11 - h10) * fu) / geom.hf_cell
    n = torch.stack([-dhdx, -dhdy, torch.ones_like(h)], dim=-1)
    n = n * torch.rsqrt(torch.sum(n * n, dim=-1, keepdim=True) + 1e-12)
    return (p[..., 2] - h) * n[..., 2], n


def _static_surface(geom: StaticGeom, p: torch.Tensor):
    """Signed distance to the table top (or the ground), upward normal; to
    the heightfield whenever one is set."""
    if geom.hf_height is not None:
        return _heightfield_surface(geom, p)
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
                      body_quat, body_pos) -> Contacts:
    B, K, _ = obj_pos.shape
    P = shapes.points_per_object
    S = spheres.body.shape[0]
    qr = slots.queries
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

    # spheres vs objects [S*K] and object-pair points [K*(K-1)*Q], in slot
    # order: every query in its object's frame, one objects_sdf pass (none
    # without objects)
    if K:
        Q, obj = qr.pair_points, qr.sdf.obj
        src = torch.cat([centers, pts_w[:, :, :Q].reshape(B, K * Q, 3)], 1)[:, qr.src]
        q_obj = obj_quat[:, obj]
        d, g = objects_sdf(shapes, qr.sdf, quat_rotate_inv(q_obj, src - obj_pos[:, obj]))
        n_w = quat_rotate(q_obj, g)
        d = torch.where(qr.valid, d, big)
        SK = S * K
        normals.append(n_w)
        poss.append(src[:, :SK] - n_w[:, :SK] * d[:, :SK, None])
        poss.append(src[:, SK:])
        depths.append(qr.radius - d)

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
