"""Spatial (6D) vector algebra in world-frame Plücker coordinates, angular
part first (counterpart of handarm_tpu/math/spatial.py)."""

from __future__ import annotations

import torch

from handarm_tpu_torch.math.quat import cross


def motion_cross(m1: torch.Tensor, m2: torch.Tensor) -> torch.Tensor:
    """m1 x m2 for motion vectors."""
    w1, v1 = m1[..., :3], m1[..., 3:]
    w2, v2 = m2[..., :3], m2[..., 3:]
    return torch.cat([cross(w1, w2), cross(w1, v2) + cross(v1, w2)], dim=-1)


def force_cross(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """m x* f (motion cross force)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fl), cross(w, fl)], dim=-1)
