"""Sphere proxies fitted to a robot's collision geometry (counterpart of
handarm_tpu/robots/spherefit.py).

Every link with collision geometry (a mesh, a box, a cylinder) is sampled to
points and covered with k spheres by a seeded k-means (the seed and every
float64 step as the JAX package's, so both packages fit the same spheres);
a sphere collision is taken as it is. The ANYmal tasks build their robot's
spheres with it.
"""

from __future__ import annotations

import numpy as np
import torch

from handarm_tpu_torch.physics.contacts import RobotSpheres
from handarm_tpu_torch.physics.shapes import box_points
from handarm_tpu_torch.physics.urdf import parse_urdf
from handarm_tpu_torch.utils.mesh import load_mesh


def _quat_to_mat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _fit_spheres(pts: np.ndarray, n: int, padding: float = 0.002):
    """k-means (12 rounds from n of the points, `default_rng(3)`), then each
    cluster's enclosing sphere about its mean plus `padding`."""
    n = min(n, len(pts))
    rng = np.random.default_rng(3)
    ctr = pts[rng.choice(len(pts), n, replace=False)]
    for _ in range(12):
        d = np.linalg.norm(pts[:, None] - ctr[None], axis=-1)
        lab = d.argmin(1)
        for k in range(n):
            sel = pts[lab == k]
            if len(sel):
                ctr[k] = sel.mean(0)
    d = np.linalg.norm(pts[:, None] - ctr[None], axis=-1)
    lab = d.argmin(1)
    rad = np.array([d[lab == k, k].max() + padding if (lab == k).any() else padding
                    for k in range(n)])
    return ctr, rad


def _cylinder_points(radius: float, length: float) -> np.ndarray:
    """A 12-point ring at 4 heights along z: 48 points."""
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    ring = np.stack([np.cos(ang) * radius, np.sin(ang) * radius], -1)
    zs = np.linspace(-length / 2, length / 2, 4)
    return np.concatenate([np.concatenate([ring, np.full((12, 1), z)], -1) for z in zs])


def generic_collision_spheres(urdf_path: str, art, spheres_per_link: int = 3,
                              surface_samples: int = 300) -> tuple:
    """(body index [S], body-frame centres [S, 3], radii [S]) in numpy for
    every link with collision geometry; a missing mesh file is skipped."""
    urdf = parse_urdf(urdf_path)
    bodies, centers, radii = [], [], []
    for link_name, link in urdf.links.items():
        site = art.sites.get(link_name)
        if site is None or site.body < 0 or not link.collisions:
            continue
        Rq = _quat_to_mat(site.quat)
        pts_all = []
        for col in link.collisions:
            g = col.geometry
            if g.kind == "mesh":
                try:
                    mesh = load_mesh(g.mesh_path, g.mesh_scale)
                except FileNotFoundError:
                    continue
                pts = mesh.sample_surface(surface_samples)
            elif g.kind == "box":
                pts = box_points(np.asarray(g.size) / 2)
            elif g.kind == "sphere":
                bodies.append(site.body)
                centers.append(Rq @ col.origin_pos + site.pos)
                radii.append(g.radius)
                continue
            elif g.kind == "cylinder":
                pts = _cylinder_points(g.radius, g.length)
            else:
                continue
            pts = pts @ col.origin_rot.T + col.origin_pos
            pts_all.append(pts @ Rq.T + site.pos)
        if not pts_all:
            continue
        ctr, rad = _fit_spheres(np.concatenate(pts_all), spheres_per_link)
        for c, r in zip(ctr, rad):
            bodies.append(site.body)
            centers.append(c)
            radii.append(r)
    return np.array(bodies, dtype=np.int32), np.stack(centers), np.array(radii)


def make_generic_spheres(urdf_path: str, art, friction: float = 1.0,
                         spheres_per_link: int = 3, device="cpu") -> RobotSpheres:
    bodies, centers, radii = generic_collision_spheres(urdf_path, art, spheres_per_link)
    f32 = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32, device=device)
    return RobotSpheres(body=bodies, offset=f32(centers), radius=f32(radii),
                        friction=np.full(len(radii), friction, np.float32))
