"""Hello-Robot Stretch: model build and collision spheres (counterpart of
handarm_tpu/robots/stretch.py).

9 dofs: the mast, the lift and the four telescoping arm segments
(prismatic), the wrist yaw and the two gripper fingers (revolute). The
default asset is the in-repo stand-in
`handarm_tpu_torch/assets/ur5sih_standin/stretch/stretch.urdf` (the same
joints in the same order, the fingertip and grasp-center sites, box meshes
as collision geometry); `urdf_path` selects another, e.g. the real
Stretch's description.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from handarm_tpu_torch.physics.contacts import RobotSpheres
from handarm_tpu_torch.physics.model import Articulation, compile_urdf
from handarm_tpu_torch.physics.shapes import box_points
from handarm_tpu_torch.physics.urdf import parse_urdf
from handarm_tpu_torch.robots.ur5sih import STANDIN_ROOT, _quat_to_mat_np
from handarm_tpu_torch.utils.mesh import fit_spheres, load_mesh

STRETCH_URDF = os.path.join(STANDIN_ROOT, "stretch", "stretch.urdf")

STRETCH_JOINTS = [
    "joint_mast", "joint_lift",
    "joint_arm_l3", "joint_arm_l2", "joint_arm_l1", "joint_arm_l0",
    "joint_wrist_yaw",
    "joint_gripper_finger_left", "joint_gripper_finger_right",
]
FINGERTIP_SITES = ["fingertip_left", "fingertip_right"]

DEFAULT_PROP_GAIN = [400.0, 400.0, 200.0, 200.0, 200.0, 200.0, 40.0, 10.0, 10.0]
DEFAULT_DERIV_GAIN = [40.0, 40.0, 20.0, 20.0, 20.0, 20.0, 4.0, 1.0, 1.0]
# reset: lift 0.7, arm retracted, fingers open; bringup (genesis parks the
# robot here): lift 0.9, the wrist yawed 90 degrees clear of the bin
RESET_JOINT_CONFIG = [0.0, 0.7, 0.0, 0.0, 0.0, 0.0, 0.0, 0.6, 0.6]
BRINGUP_JOINT_CONFIG = [0.0, 0.9, 0.0, 0.0, 0.0, 0.0, 1.571, 0.6, 0.6]


@functools.lru_cache(maxsize=4)
def load_stretch(urdf_path: str = STRETCH_URDF) -> Articulation:
    art = compile_urdf(urdf_path)
    # the grouped action's layout is this traversal order
    if art.joint_names != STRETCH_JOINTS:
        raise ValueError(f"unexpected joint order in {urdf_path}: {art.joint_names}")
    return art


@functools.lru_cache(maxsize=4)
def stretch_collision_spheres(urdf_path: str = STRETCH_URDF,
                              spheres_per_link: int = 2) -> tuple:
    """Sphere proxies fitted to each link's mesh (and box) collisions, body
    frame: 2 per link, a chain of 8 along each elongated gripper finger.
    Returns numpy (body_idx [S], centers [S, 3], radii [S])."""
    art = load_stretch(urdf_path)
    urdf = parse_urdf(urdf_path)
    bodies, centers, radii = [], [], []
    for link_name, link in urdf.links.items():
        site = art.sites.get(link_name)
        if site is None or site.body < 0 or not link.collisions:
            continue
        pts_all = []
        for col in link.collisions:
            g = col.geometry
            if g.kind == "mesh":
                try:
                    mesh = load_mesh(g.mesh_path, g.mesh_scale)
                except FileNotFoundError:
                    continue
                pts = mesh.sample_surface(300)
            elif g.kind == "box":
                pts = box_points(np.asarray(g.size) / 2)
            else:
                continue
            pts = pts @ col.origin_rot.T + col.origin_pos
            pts_all.append(pts @ _quat_to_mat_np(site.quat).T + site.pos)
        if not pts_all:
            continue
        k = 8 if link_name.startswith("link_gripper_finger_") else spheres_per_link
        ctr, rad = fit_spheres(np.concatenate(pts_all), k, padding=0.002)
        for c, r in zip(ctr, rad):
            bodies.append(site.body)
            centers.append(c)
            radii.append(r)
    return np.array(bodies, dtype=np.int32), np.stack(centers), np.array(radii)


def make_stretch_spheres(friction: float = 1.0, hand_only: bool = False,
                         urdf_path: str = STRETCH_URDF, device="cpu") -> RobotSpheres:
    bodies, centers, radii = stretch_collision_spheres(urdf_path)
    if hand_only:  # the wrist and gripper bodies
        sel = bodies >= 6
        bodies, centers, radii = bodies[sel], centers[sel], radii[sel]
    return RobotSpheres(
        body=bodies,
        offset=torch.as_tensor(centers, dtype=torch.float32, device=device),
        radius=torch.as_tensor(radii, dtype=torch.float32, device=device),
        friction=np.full(len(radii), friction, np.float32),
    )
