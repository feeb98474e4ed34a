"""UR5 + Schunk SIH robot: model build, collision spheres, surface cloud and
the servo-tick -> joint-target splines (counterpart of
handarm_tpu/robots/ur5sih.py).

The default asset is the in-repo stand-in under
`handarm_tpu_torch/assets/ur5sih_standin` (same 17 joints, flange and
fingertip links, mesh collisions on the hand); `urdf_path` selects
another, e.g. the real UR5+SIH description.
"""

from __future__ import annotations

import functools
import os
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.math.spline import CubicSpline, natural_cubic_spline
from handarm_tpu_torch.physics.contacts import RobotSpheres
from handarm_tpu_torch.physics.model import Articulation, compile_urdf
from handarm_tpu_torch.physics.shapes import box_points
from handarm_tpu_torch.physics.urdf import parse_urdf
from handarm_tpu_torch.utils.mesh import fit_spheres, load_mesh

STANDIN_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "assets", "ur5sih_standin",
)
UR5SIH_URDF = os.path.join(STANDIN_ROOT, "robot", "hand_arm_collision_is_visual.urdf")

UR5_JOINTS = [
    "shoulder_pan_joint", "shoulder_lift_joint", "elbow_joint",
    "wrist_1_joint", "wrist_2_joint", "wrist_3_joint",
]
SIH_JOINTS = [
    "thumb_opposition", "thumb_flexion", "th_inter_to_th_distal",
    "index_finger", "if_proximal_to_if_distal",
    "middle_finger", "mf_proximal_to_mf_distal",
    "ring_finger", "rf_proximal_to_rf_distal",
    "palm_to_lf_proximal", "lf_proximal_to_lf_distal",
]
FINGERTIP_SITES = [
    "thumb_fingertip", "index_fingertip", "middle_fingertip",
    "ring_fingertip", "little_fingertip",
]

DEFAULT_PROP_GAIN = [120.0] * 6 + [20.0, 10.0, 20.0, 10.0, 20.0, 10.0, 20.0, 10.0, 20.0, 20.0, 10.0]
DEFAULT_DERIV_GAIN = [20.0] * 6 + [6.0, 2.0, 6.0, 2.0, 6.0, 2.0, 6.0, 2.0, 6.0, 6.0, 2.0]
RESET_JOINT_CONFIG = [0.6985, -1.4106, 1.2932, 0.1174, 0.6983, 1.5708] + [0.0] * 7 + [0.0, -1.571, 0.0, 0.0]
# the arm straight up, clear of the table: genesis parks the robot here
BRINGUP_JOINT_CONFIG = [0.0, -1.571, 0.0, 0.0, 0.0, 0.0] + [0.0] * 8 + [-1.571, 0.0, 0.0]

SERVO_LOWER = np.array([0.0, -2000.0, -1250.0, -400.0, -1350.0])
SERVO_UPPER = np.array([2650.0, 250.0, 1450.0, 2300.0, 1000.0])

# servo -> joint calibration curves (ticks, radians)
_THUMB_PROX = ([-1850, -1175, -975, -600, -225], [-1.51, -1.31, -1.175, -0.6, 0.0])
_THUMB_DIST = ([-1318.125, -906.25, -200], [-1.235, -0.855, 0.0])
_THUMB_COEF = -625.0
_INDEX_PROX = ([-1250, -250, 150, 350, 540, 730, 1085, 1400],
               [-1.53, -1.4425, -1.315, -1.25, -1.18, -1.15, -0.6, 0.0])
_INDEX_DIST = ([-408.606, 793.515, 1400], [-1.665, -0.735, 0.0])
_INDEX_COEF = -582.61
_MIDDLE_PROX = ([-500, 500, 1350, 1625, 1700, 1980, 2240],
                [-1.571, -1.445, -1.055, -0.91, -0.9, -0.48, 0.0])
_MIDDLE_DIST = ([442.6, 1147, 1750.6, 2240], [-1.65, -1.125, -0.62, 0.0])
_MIDDLE_COEF = -600.0
_RING_PROX = ([-1050, -500, -250, 0, 370, 500, 700, 940],
              [-1.571, -1.45, -1.35, -1.225, -0.95, -0.9, -0.533, 0.0])
_RING_DIST = ([-719, 408.8, 686.8, 939.2], [-1.64, -0.69, -0.425, 0.0])
_RING_COEF = -488.0


class SihSplines(NamedTuple):
    thumb_prox: CubicSpline
    thumb_dist: CubicSpline
    index_prox: CubicSpline
    index_dist: CubicSpline
    middle_prox: CubicSpline
    middle_dist: CubicSpline
    ring_prox: CubicSpline
    ring_dist: CubicSpline


def build_sih_splines(device="cpu") -> SihSplines:
    mk = lambda tab: natural_cubic_spline(tab[0], tab[1], device=device)
    return SihSplines(
        mk(_THUMB_PROX), mk(_THUMB_DIST), mk(_INDEX_PROX), mk(_INDEX_DIST),
        mk(_MIDDLE_PROX), mk(_MIDDLE_DIST), mk(_RING_PROX), mk(_RING_DIST),
    )


def servo_to_joint_targets(splines: SihSplines, ticks: torch.Tensor,
                           dof_pos_sih: torch.Tensor) -> torch.Tensor:
    """5 servo commands [B, 5] -> 11 SIH joint targets [B, 11]; distal joints
    couple through the measured proximal angle, the little finger mimics
    the ring finger."""
    th_op = (-1.571 / 2675.0) * ticks[:, 0]
    th_flex = -splines.thumb_prox.evaluate(ticks[:, 1])
    th_dist = -splines.thumb_dist.evaluate(ticks[:, 1] + _THUMB_COEF * dof_pos_sih[:, 1])
    if_prox = splines.index_prox.evaluate(ticks[:, 2])
    if_dist = splines.index_dist.evaluate(ticks[:, 2] + _INDEX_COEF * dof_pos_sih[:, 3])
    mf_prox = splines.middle_prox.evaluate(ticks[:, 3])
    mf_dist = splines.middle_dist.evaluate(ticks[:, 3] + _MIDDLE_COEF * dof_pos_sih[:, 5])
    rf_prox = splines.ring_prox.evaluate(ticks[:, 4])
    rf_dist = splines.ring_dist.evaluate(ticks[:, 4] + _RING_COEF * dof_pos_sih[:, 7])
    return torch.stack([th_op, th_flex, th_dist, if_prox, if_dist, mf_prox,
                        mf_dist, rf_prox, rf_dist, rf_prox, rf_dist], dim=-1)


@functools.lru_cache(maxsize=4)
def load_ur5sih(urdf_path: str = UR5SIH_URDF) -> Articulation:
    art = compile_urdf(urdf_path)
    if art.joint_names != UR5_JOINTS + SIH_JOINTS:
        raise ValueError(f"unexpected joint order in {urdf_path}: {art.joint_names}")
    return art


def _quat_to_mat_np(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


@functools.lru_cache(maxsize=4)
def ur5sih_collision_spheres(urdf_path: str = UR5SIH_URDF,
                             spheres_per_arm_link: int = 3,
                             spheres_per_hand_link: int = 2,
                             surface_samples: int = 400) -> tuple:
    """Sphere proxies fitted to each link's collision geometry, body frame.
    Returns numpy (body_idx [S], centers [S, 3], radii [S])."""
    art = load_ur5sih(urdf_path)
    urdf = parse_urdf(urdf_path)
    bodies, centers, radii = [], [], []
    finger_bodies = {art.sites[s].body for s in FINGERTIP_SITES if s in art.sites}
    for link_name, link in urdf.links.items():
        site = art.sites.get(link_name)
        if site is None or site.body < 0 or not link.collisions:
            continue
        n_sph = (spheres_per_hand_link + 1
                 if site.body in finger_bodies or site.body >= 6
                 else spheres_per_arm_link)
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
                centers.append(col.origin_pos + site.pos)
                radii.append(g.radius)
                continue
            elif g.kind == "cylinder":
                ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
                ring = np.stack([np.cos(ang) * g.radius, np.sin(ang) * g.radius], -1)
                zs = np.linspace(-g.length / 2, g.length / 2, 4)
                pts = np.concatenate([np.concatenate([ring, np.full((12, 1), z)], -1) for z in zs])
            else:
                continue
            pts = pts @ col.origin_rot.T + col.origin_pos
            pts = pts @ _quat_to_mat_np(site.quat).T + site.pos
            pts_all.append(pts)
        if not pts_all:
            continue
        ctr, rad = fit_spheres(np.concatenate(pts_all), n_sph, padding=0.002)
        for c, r in zip(ctr, rad):
            bodies.append(site.body)
            centers.append(c)
            radii.append(r)
    return np.array(bodies, dtype=np.int32), np.stack(centers), np.array(radii)


@functools.lru_cache(maxsize=4)
def ur5sih_surface_cloud(total_points: int = 128, urdf_path: str = UR5SIH_URDF) -> tuple:
    """Area-proportional samples over the link collision meshes, body frames.
    Returns numpy (body_idx [P], offsets [P, 3])."""
    art = load_ur5sih(urdf_path)
    urdf = parse_urdf(urdf_path)
    link_meshes = []
    for link_name, link in urdf.links.items():
        site = art.sites.get(link_name)
        if site is None or site.body < 0 or not link.collisions:
            continue
        for col in link.collisions:
            if col.geometry.kind != "mesh":
                continue
            try:
                mesh = load_mesh(col.geometry.mesh_path, col.geometry.mesh_scale)
            except FileNotFoundError:
                continue
            link_meshes.append((site, col, mesh, mesh.area()))
    total_area = sum(a for *_, a in link_meshes)
    bodies, offsets = [], []
    rng = np.random.default_rng(7)
    for site, col, mesh, area in link_meshes:
        n = max(1, int(round(total_points * area / max(total_area, 1e-9))))
        pts = mesh.sample_surface(n, rng) @ col.origin_rot.T + col.origin_pos
        offsets.append(pts @ _quat_to_mat_np(site.quat).T + site.pos)
        bodies.extend([site.body] * n)
    return np.array(bodies, dtype=np.int32), np.concatenate(offsets)


def make_robot_spheres(friction: float = 1.0, hand_only: bool = False,
                       urdf_path: str = UR5SIH_URDF, device="cpu") -> RobotSpheres:
    bodies, centers, radii = ur5sih_collision_spheres(urdf_path)
    if hand_only:  # hand links are bodies >= 6
        sel = bodies >= 6
        bodies, centers, radii = bodies[sel], centers[sel], radii[sel]
    return RobotSpheres(
        body=bodies,
        offset=torch.as_tensor(centers, dtype=torch.float32, device=device),
        radius=torch.as_tensor(radii, dtype=torch.float32, device=device),
        friction=np.full(len(radii), friction, np.float32),
    )
