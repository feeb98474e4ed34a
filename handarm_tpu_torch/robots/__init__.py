"""Robot adapters: the interface the environment layer builds against
(counterpart of handarm_tpu/robots/__init__.py): the UR5+SIH and the
Hello-Robot Stretch."""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

ROBOTS = ("ur5sih", "stretch")


@dataclass
class RobotAdapter:
    name: str
    art: Any  # Articulation
    make_spheres: Callable[..., Any]  # (hand_only, device) -> RobotSpheres
    fingertip_site_names: list[str]
    flange_site_name: str
    reset_q: np.ndarray
    bringup_q: np.ndarray  # parked pose while genesis drops the objects
    kp: np.ndarray
    kd: np.ndarray
    init_control: Callable[..., Any]  # (B, device) -> control state
    # compute_targets(control, q) -> [B, nv] PD position targets
    compute_targets: Callable[[Any, torch.Tensor], torch.Tensor]
    # surface_cloud(total_points) -> (body index [P], body-frame offsets [P, 3])
    surface_cloud: Callable[[int], tuple] | None = None
    # the actions of a config that keeps HandArmConfig's default (UR5+SIH) ones
    default_actions: tuple[str, ...] = ()
    # register_terms(registry): the robot's own observables and actionables
    # (the UR5+SIH's are the env's built-in ones)
    register_terms: Callable[[Any], None] | None = None
    # fixed-base mount relative to the table origin: xy offset and yaw
    base_xy: tuple[float, float] = (0.0, 0.0)
    base_yaw: float = 0.0


def _adapter_module(name: str):
    if name not in ROBOTS:
        raise KeyError(f"unknown robot {name!r} (known: {', '.join(ROBOTS)})")
    return importlib.import_module(f"handarm_tpu_torch.robots.{name}_adapter")


def get_robot(name: str, urdf_path: str | None = None,
              device="cpu") -> RobotAdapter:
    return _adapter_module(name).make_adapter(urdf_path, device)


def control_type(name: str) -> type:
    """The robot's control-state NamedTuple (its fields are its leaves in a
    checkpoint's env state)."""
    return _adapter_module(name).CONTROL
