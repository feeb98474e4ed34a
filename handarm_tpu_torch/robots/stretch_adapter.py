"""RobotAdapter for the Hello-Robot Stretch (counterpart of
handarm_tpu/robots/stretch_adapter.py)."""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.envs.spec import Observable, Registry
from handarm_tpu_torch.physics.urdf import parse_urdf
from handarm_tpu_torch.robots import RobotAdapter
from handarm_tpu_torch.robots.stretch import (
    BRINGUP_JOINT_CONFIG,
    DEFAULT_DERIV_GAIN,
    DEFAULT_PROP_GAIN,
    FINGERTIP_SITES,
    RESET_JOINT_CONFIG,
    STRETCH_URDF,
    load_stretch,
    make_stretch_spheres,
)
from handarm_tpu_torch.robots.ur5sih import _quat_to_mat_np
from handarm_tpu_torch.utils.mesh import load_mesh

ACTION_SCALE = 0.25


class StretchControl(NamedTuple):
    joint_target: torch.Tensor  # [B, 9]


CONTROL = StretchControl


@functools.lru_cache(maxsize=4)
def stretch_surface_cloud(total_points: int = 128, urdf_path: str = STRETCH_URDF) -> tuple:
    """Area-proportional samples over the moving links' collision meshes,
    body frames (at least one per mesh, so the count may differ from
    `total_points`). Returns numpy (body_idx [P], offsets [P, 3])."""
    art = load_stretch(urdf_path)
    urdf = parse_urdf(urdf_path)
    metas = []
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
            metas.append((site, col, mesh, mesh.area()))
    total_area = sum(a for *_, a in metas) or 1.0
    rng = np.random.default_rng(11)
    bodies, offsets = [], []
    for site, col, mesh, area in metas:
        n = max(1, int(round(total_points * area / total_area)))
        pts = mesh.sample_surface(n, rng) @ col.origin_rot.T + col.origin_pos
        offsets.append(pts @ _quat_to_mat_np(site.quat).T + site.pos)
        bodies.extend([site.body] * n)
    return np.array(bodies, dtype=np.int32), np.concatenate(offsets)


def act_relative_joint_pos(env, control: StretchControl, a: torch.Tensor) -> StretchControl:
    """Grouped relative joint targets, dt * 0.25 per unit action: slots 0-1
    the mast and the lift, slot 2 all four arm segments, slot 3 the wrist
    (x8), slot 4 both fingers (x6); clamped to the joint limits."""
    dt, s = env.cfg.dt, ACTION_SCALE
    delta = torch.cat([
        dt * s * a[:, 0:2],
        (dt * s * a[:, 2:3]).expand(-1, 4),
        dt * 8 * s * a[:, 3:4],
        (dt * 6 * s * a[:, 4:5]).expand(-1, 2),
    ], dim=-1)
    lo, hi = env.joint_limits
    return control._replace(
        joint_target=torch.minimum(torch.maximum(control.joint_target + delta, lo), hi))


def register_terms(reg: Registry, nv: int) -> None:
    """The Stretch's observables and its actionable."""
    def obs(name, size, fn):
        reg.observables[name] = Observable(name, size, fn)

    flat = lambda c, x: x.reshape(c.batch, -1)
    obs("stretch_fingertip_pos", 6, lambda c: flat(c, c.fingertips[1]))
    obs("stretch_fingertip_linvel", 6, lambda c: flat(c, c.fingertip_vel()[0]))
    obs("stretch_flange_pose", 7, lambda c: torch.cat([c.flange[1][:, 0], c.flange[0][:, 0]], -1))
    obs("stretch_joint_pos", nv, lambda c: c.state.physics.robot.q)
    reg.actionable("stretch_relative_joint_pos", 5)(act_relative_joint_pos)


def make_adapter(urdf_path: str | None = None, device="cpu") -> RobotAdapter:
    path = urdf_path or STRETCH_URDF
    art = load_stretch(path)
    reset_q = np.asarray(RESET_JOINT_CONFIG)

    def init_control(B: int, device=device) -> StretchControl:
        return StretchControl(joint_target=torch.as_tensor(
            reset_q, dtype=torch.float32, device=device).expand(B, art.nv).clone())

    return RobotAdapter(
        name="stretch",
        art=art,
        make_spheres=lambda hand_only, device=device: make_stretch_spheres(
            hand_only=hand_only, urdf_path=path, device=device),
        fingertip_site_names=list(FINGERTIP_SITES),
        flange_site_name="link_grasp_center",
        reset_q=reset_q,
        bringup_q=np.asarray(BRINGUP_JOINT_CONFIG),
        kp=np.asarray(DEFAULT_PROP_GAIN),
        kd=np.asarray(DEFAULT_DERIV_GAIN),
        init_control=init_control,
        compute_targets=lambda control, q: control.joint_target,
        surface_cloud=lambda total_points: stretch_surface_cloud(total_points, path),
        default_actions=("stretch_relative_joint_pos",),
        register_terms=lambda reg: register_terms(reg, art.nv),
        # yawed 180 degrees: the arm, which extends along the base's -y,
        # faces the bin (+y in the world); the xy offset is the reference
        # actor pose's
        base_xy=(0.2, 0.175),
        base_yaw=float(np.pi),
    )
