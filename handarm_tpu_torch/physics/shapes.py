"""Free-object collision geometry: sample points + analytic or voxel SDFs
(counterpart of handarm_tpu/physics/shapes.py for box, sphere and mesh-SDF
objects, and the union-of-boxes compounds baked into mesh-SDF records).

A mesh-SDF object's field [R, R, R, 4] holds the baked distance and its
unit gradient, so one trilinear gather (ops/sdf_gather.py: a CUDA kernel
on the card) gives both. The JAX package's bf16 hi/lo tables for its
one-hot-matmul TPU kernel are not built here.

`objects_sdf` evaluates a fixed row of queries per env, each against its
own object, in one pass: every mesh-SDF query of the row goes to one
sdf_gather launch, driven by the static table `sdf_queries` builds once
per scene; box and sphere queries take their analytic branch.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.quat import safe_norm
from handarm_tpu_torch.ops import sdf_gather as sdf_op
from handarm_tpu_torch.physics.sdf import bake_grad_grid

BOX, SPHERE, CYLINDER, MESH_SDF = 0, 1, 2, 3


@dataclass
class ObjectShapes:
    kind: np.ndarray  # [K] int shape codes (static)
    size: torch.Tensor  # [K, 3] box half-extents / (radius, 0, 0)
    points: torch.Tensor  # [K, P, 3] body-frame contact samples
    point_mask: torch.Tensor  # [K, P]
    point_radius: torch.Tensor  # [K, P]
    bound_radius: torch.Tensor  # [K]
    mass: torch.Tensor  # [K]
    inv_mass: torch.Tensor  # [K]
    inertia_diag: torch.Tensor  # [K, 3]
    friction: torch.Tensor  # [K]
    obb_pos: torch.Tensor  # [K, 3] oriented bounding box pose, body frame
    obb_quat: torch.Tensor  # [K, 4] wxyz body -> obb
    # voxel SDF fields of MESH_SDF objects (shared resolution), else None
    sdf_field: torch.Tensor | None = None  # [K, R, R, R, 4] distance + unit grad
    sdf_lo: torch.Tensor | None = None  # [K, 3] grid lower corner, body frame
    sdf_spacing: torch.Tensor | None = None  # [K] voxel edge length

    @property
    def num_objects(self) -> int:
        return int(self.kind.shape[0])

    @property
    def points_per_object(self) -> int:
        return int(self.points.shape[1])


def box_points(half_extents, n_per_edge: int = 0) -> np.ndarray:
    """8 corners (+ the 6 face centres when n_per_edge) of a box."""
    h = np.asarray(half_extents)
    corners = np.array(
        [[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
        dtype=np.float64,
    )
    pts = [corners * h]
    if n_per_edge:
        pts.append(np.concatenate([np.eye(3), -np.eye(3)]) * h)
    return np.concatenate(pts, axis=0)


def sphere_points(radius: float, n: int = 12) -> np.ndarray:
    """n Fibonacci-sphere samples of a sphere's surface, [n, 3]."""
    i = np.arange(n, dtype=np.float64) + 0.5
    phi = np.arccos(1 - 2 * i / n)
    theta = np.pi * (1 + 5**0.5) * i
    pts = np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1)
    return pts * radius


def box_inertia_diag(mass: float, half_extents) -> np.ndarray:
    fx, fy, fz = (2 * np.asarray(half_extents)) ** 2
    return mass / 12.0 * np.array([fy + fz, fx + fz, fx + fy])


def make_box_object(half_extents, mass: float, friction: float = 1.0) -> dict:
    return dict(
        kind=BOX,
        size=np.asarray(half_extents, dtype=np.float64),
        points=box_points(half_extents, n_per_edge=1),
        bound_radius=float(np.linalg.norm(half_extents)),
        mass=mass,
        inertia_diag=box_inertia_diag(mass, half_extents),
        friction=friction,
    )


def _box_sdf(p: np.ndarray, center: np.ndarray, half: np.ndarray) -> np.ndarray:
    q = np.abs(p - center) - half
    return np.linalg.norm(np.maximum(q, 0.0), axis=-1) + np.minimum(q.max(axis=-1), 0.0)


def make_compound_box_object(parts: list[tuple], mass: float, friction: float = 1.0,
                             sdf_resolution: int = 32, margin: float = 0.03) -> dict:
    """One rigid body made of several boxes (their union) as a MESH_SDF
    record: the union's exact box SDF sampled onto an R^3 grid over the
    parts' bounds plus `margin`, the parts' corners and face centres that
    no other part swallows as contact points, and uniform-density mass
    and inertia (parallel-axis, about the com). `parts` is a list of
    (centre [3], half extents [3]) in the body frame, whose origin the
    engine takes as the com: the caller centres the parts on it."""
    parts = [(np.asarray(c, np.float64), np.asarray(h, np.float64)) for c, h in parts]
    vols = np.array([8.0 * h.prod() for _, h in parts])
    dens = mass / max(vols.sum(), 1e-12)
    lo = np.min([c - h for c, h in parts], axis=0) - margin
    hi = np.max([c + h for c, h in parts], axis=0) + margin
    spacing = float((hi - lo).max() / (sdf_resolution - 1))
    axes = [lo[i] + spacing * np.arange(sdf_resolution) for i in range(3)]
    p = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)  # [R, R, R, 3]
    grid = np.min([_box_sdf(p, c, h) for c, h in parts], axis=0).astype(np.float32)
    pts = np.concatenate([box_points(h, n_per_edge=1) + c for c, h in parts], axis=0)
    # drop the samples inside the union (corners another part swallows)
    pts = pts[np.min([_box_sdf(pts, c, h) for c, h in parts], axis=0) > -1e-6]
    inertia = np.zeros(3)
    com = sum(dens * v * c for (c, _), v in zip(parts, vols)) / mass
    for (c, h), v in zip(parts, vols):
        r = c - com
        inertia += box_inertia_diag(dens * v, h) + dens * v * ((r ** 2).sum() - r ** 2)
    return dict(
        kind=MESH_SDF,
        size=(hi - lo) / 2.0,
        obb_pos=(hi + lo) / 2.0,
        obb_quat=np.array([1.0, 0.0, 0.0, 0.0]),
        points=pts,
        point_radius=np.zeros(len(pts)),
        bound_radius=float(np.linalg.norm(np.maximum(np.abs(lo), np.abs(hi)))),
        mass=float(mass),
        inertia_diag=np.clip(inertia, 1e-7, None),
        friction=friction,
        sdf_grid=grid,
        sdf_lo=lo.astype(np.float32),
        sdf_spacing=spacing,
    )


def make_sphere_object(radius: float, mass: float, friction: float = 1.0) -> dict:
    return dict(
        kind=SPHERE,
        size=np.array([radius, 0.0, 0.0]),
        points=np.zeros((1, 3)),
        point_radius=np.array([radius]),
        bound_radius=radius,
        mass=mass,
        inertia_diag=np.full(3, 0.4 * mass * radius**2),
        friction=friction,
    )


def stack_objects(objs: list[dict], dtype=torch.float32, device="cpu") -> ObjectShapes:
    """Stack per-object dicts into ObjectShapes with zero-padded point sets.
    An empty list gives a K = 0 scene (a robot alone: the classic tasks'
    craft over the ground plane)."""
    if not objs:
        z = lambda *s: torch.zeros(s, dtype=dtype, device=device)
        return ObjectShapes(
            kind=np.zeros((0,), np.int32), size=z(0, 3), points=z(0, 1, 3),
            point_mask=z(0, 1), point_radius=z(0, 1), bound_radius=z(0), mass=z(0),
            inv_mass=z(0), inertia_diag=z(0, 3), friction=z(0), obb_pos=z(0, 3),
            obb_quat=z(0, 4),
        )
    for o in objs:
        if o["kind"] not in (BOX, SPHERE, MESH_SDF):
            raise NotImplementedError(f"shape kind {o['kind']} is not ported yet")
    K = len(objs)
    P = max(o["points"].shape[0] for o in objs)
    points = np.zeros((K, P, 3))
    mask = np.zeros((K, P))
    radius = np.zeros((K, P))
    for k, o in enumerate(objs):
        n = o["points"].shape[0]
        points[k, :n] = o["points"]
        mask[k, :n] = 1.0
        radius[k, :n] = o.get("point_radius", np.zeros(n))
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)
    mass = np.array([o["mass"] for o in objs])
    sdf = {}
    meshes = [o for o in objs if o["kind"] == MESH_SDF]
    if meshes:
        res = max(o["sdf_grid"].shape[0] for o in meshes)
        fields = np.zeros((K, res, res, res, 4), np.float32)
        los = np.zeros((K, 3), np.float32)
        spacings = np.ones(K, np.float32)
        for k, o in enumerate(objs):
            if o["kind"] != MESH_SDF:
                continue
            g = o["sdf_grid"]
            if g.shape[0] != res:
                raise ValueError("mixed SDF resolutions are not supported")
            fields[k, ..., 0] = g
            fields[k, ..., 1:] = bake_grad_grid(g, float(o["sdf_spacing"]))
            los[k] = o["sdf_lo"]
            spacings[k] = o["sdf_spacing"]
        sdf = dict(sdf_field=f(fields), sdf_lo=f(los), sdf_spacing=f(spacings))
    return ObjectShapes(
        kind=np.array([o["kind"] for o in objs], dtype=np.int32),
        size=f(np.stack([o["size"] for o in objs])),
        points=f(points), point_mask=f(mask), point_radius=f(radius),
        bound_radius=f([o["bound_radius"] for o in objs]),
        mass=f(mass), inv_mass=f(1.0 / np.maximum(mass, 1e-9)),
        inertia_diag=f(np.stack([o["inertia_diag"] for o in objs])),
        friction=f([o["friction"] for o in objs]),
        obb_pos=f(np.stack([o.get("obb_pos", np.zeros(3)) for o in objs])),
        obb_quat=f(np.stack([o.get("obb_quat", np.array([1.0, 0.0, 0.0, 0.0]))
                             for o in objs])),
        **sdf,
    )


def sdf_box(p: torch.Tensor, half: torch.Tensor):
    """SDF and outward unit (sub)gradient of an axis-aligned box."""
    q = p.abs() - half
    outside = torch.clamp(q, min=0.0)
    d_out = torch.linalg.vector_norm(outside, dim=-1)
    d_in = torch.clamp(q.max(dim=-1).values, max=0.0)
    sign = torch.sign(p)
    g_out = sign * outside / torch.clamp(d_out[..., None], min=1e-9)
    g_in = sign * torch.nn.functional.one_hot(q.argmax(dim=-1), 3).to(p.dtype)
    normal = torch.where((d_out > 0)[..., None], g_out, g_in)
    return d_out + d_in, normal


def sdf_sphere(p: torch.Tensor, radius):
    d = safe_norm(p, eps=0.0)
    return d - radius, p / torch.clamp(d[..., None], min=1e-9)


class SdfQueries(NamedTuple):
    """A fixed row of L object-SDF queries per env, static per scene."""

    obj: torch.Tensor  # [L] int64: the object query j samples
    size: torch.Tensor  # [L, 3] that object's size row (the analytic kinds)
    kinds: tuple  # (kind, [L] bool mask, or None where all queries are of it)
    # [Lq, 2] int32 (position j in the row, object) of the mesh-SDF queries,
    # grouped by object: the sdf_gather kernel's thread order; None if none
    table: torch.Tensor | None


def sdf_queries(shapes: ObjectShapes, obj) -> SdfQueries:
    """The table of a row of queries whose j-th samples object obj[j]."""
    obj = np.asarray(obj, dtype=np.int64)
    if obj.size and not (obj.min() >= 0 and obj.max() < shapes.num_objects):
        raise ValueError("sdf_queries: object index out of range")
    dev = shapes.size.device
    kind_q = shapes.kind[obj]
    kinds = []
    for kind in sorted(set(kind_q.tolist())):
        sel = kind_q == kind
        kinds.append((int(kind), None if sel.all() else torch.as_tensor(sel, device=dev)))
    mesh = kind_q == MESH_SDF
    table = None
    if mesh.any():
        rows = [(j, k) for k in range(shapes.num_objects)
                for j in np.flatnonzero(mesh & (obj == k))]
        table = torch.as_tensor(np.array(rows, dtype=np.int32), device=dev)
    obj_t = torch.as_tensor(obj, device=dev)
    return SdfQueries(obj=obj_t, size=shapes.size[obj_t], kinds=tuple(kinds), table=table)


def objects_sdf(shapes: ObjectShapes, queries: SdfQueries, p_body: torch.Tensor):
    """Distance [B, L] and unit outward gradient [B, L, 3] at body-frame
    points p_body [B, L, 3], query j against object queries.obj[j]."""
    d = g = None
    for kind, sel in queries.kinds:
        if kind == BOX:
            dk, gk = sdf_box(p_body, queries.size)
        elif kind == SPHERE:
            dk, gk = sdf_sphere(p_body, queries.size[:, 0])
        else:  # MESH_SDF: one kernel launch samples every mesh query
            out = sdf_op.sdf_sample(shapes.sdf_field, shapes.sdf_lo, shapes.sdf_spacing,
                                    p_body, queries.table)
            dk, gk = out[..., 0], out[..., 1:4]
            gk = gk * torch.rsqrt(torch.sum(gk * gk, dim=-1, keepdim=True) + 1e-18)
        if d is None:
            d, g = dk, gk
        else:
            d = torch.where(sel, dk, d)
            g = torch.where(sel[..., None], gk, g)
    return d, g
