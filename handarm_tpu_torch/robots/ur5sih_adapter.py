"""RobotAdapter for the UR5 + Schunk SIH hand-arm (counterpart of
handarm_tpu/robots/ur5sih_adapter.py)."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.robots import RobotAdapter
from handarm_tpu_torch.robots.ur5sih import (
    BRINGUP_JOINT_CONFIG,
    DEFAULT_DERIV_GAIN,
    DEFAULT_PROP_GAIN,
    FINGERTIP_SITES,
    RESET_JOINT_CONFIG,
    SERVO_UPPER,
    UR5SIH_URDF,
    build_sih_splines,
    load_ur5sih,
    make_robot_spheres,
    servo_to_joint_targets,
    ur5sih_surface_cloud,
)


class ControlState(NamedTuple):
    arm_target: torch.Tensor  # [B, 6]
    servo_ticks: torch.Tensor  # [B, 5]
    sih_smoothed: torch.Tensor  # [B, 5]


CONTROL = ControlState


def make_adapter(urdf_path: str | None = None, device="cpu") -> RobotAdapter:
    path = urdf_path or UR5SIH_URDF
    art = load_ur5sih(path)
    splines = build_sih_splines(device)
    reset_q = np.asarray(RESET_JOINT_CONFIG)

    def init_control(B: int, device=device) -> ControlState:
        f = lambda x, n: torch.as_tensor(x, dtype=torch.float32, device=device).expand(B, n).clone()
        return ControlState(
            arm_target=f(reset_q[:6], 6),
            servo_ticks=f(SERVO_UPPER, 5),
            sih_smoothed=torch.zeros(B, 5, device=device),
        )

    def compute_targets(control: ControlState, q: torch.Tensor) -> torch.Tensor:
        sih = servo_to_joint_targets(splines, control.servo_ticks, q[:, 6:])
        return torch.cat([control.arm_target, sih], dim=-1)

    return RobotAdapter(
        name="ur5sih",
        art=art,
        make_spheres=lambda hand_only, device=device: make_robot_spheres(
            hand_only=hand_only, urdf_path=path, device=device),
        fingertip_site_names=list(FINGERTIP_SITES),
        flange_site_name="flange",
        reset_q=reset_q,
        bringup_q=np.asarray(BRINGUP_JOINT_CONFIG),
        kp=np.asarray(DEFAULT_PROP_GAIN),
        kd=np.asarray(DEFAULT_DERIV_GAIN),
        init_control=init_control,
        compute_targets=compute_targets,
        surface_cloud=lambda total_points: ur5sih_surface_cloud(total_points, path),
        default_actions=("ur5_relative_joint_pos", "sih_smoothed_relative_servo_pos"),
    )
