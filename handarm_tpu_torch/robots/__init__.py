"""Robot adapters: the interface the environment layer builds against
(counterpart of handarm_tpu/robots/__init__.py; only the UR5+SIH is
ported)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch


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


def get_robot(name: str, urdf_path: str | None = None,
              device="cpu") -> RobotAdapter:
    if name != "ur5sih":
        raise KeyError(f"unknown robot {name!r} (ported: ur5sih)")
    from handarm_tpu_torch.robots.ur5sih_adapter import make_adapter

    return make_adapter(urdf_path, device)
