"""Synthetic point-cloud observations (counterpart of
handarm_tpu/envs/pointcloud.py).

Surface samples are fixed per body on the host, zero-padded to a common
count with a PADDING type; each step gathers and rigidly transforms them.
A cloud is [B, N, 4]: xyz and the PointType (PADDING 0, REGULAR 1,
TARGET 2, GOAL 3); padding rows are all zero.

`subsample_pad` takes its uniform scores as an argument, so that a caller
can pass another generator's draws (the env draws them once per step and
point count, `ObsContext.uniform`).
"""

from __future__ import annotations

import numpy as np
import torch

from handarm_tpu_torch.math.quat import quat_rotate, quat_rotate_inv

PADDING, REGULAR, TARGET, GOAL = 0, 1, 2, 3


def pad_cloud(points: np.ndarray, max_points: int) -> tuple[np.ndarray, np.ndarray]:
    """Zero-pad a [P, 3] sample set to [max_points, 3] and its validity mask."""
    out = np.zeros((max_points, 3))
    mask = np.zeros(max_points)
    n = min(len(points), max_points)
    out[:n] = points[:n]
    mask[:n] = 1.0
    return out, mask


def area_sample_counts(areas: np.ndarray, average_num_points: int) -> np.ndarray:
    """Per-mesh sample counts proportional to surface area, at least 1."""
    total = areas.sum()
    return np.maximum(
        1, np.round(areas / max(total, 1e-9) * average_num_points * len(areas))
    ).astype(int)


def transform_cloud(points, mask, quat, pos, point_type: int = REGULAR):
    """A body-frame cloud ([P, 3] or [B, P, 3], mask [P] or [B, P]) posed
    at quat [B, 4], pos [B, 3] in the world frame: [B, P, 4], padding rows
    zero."""
    pts = points[None] if points.dim() == 2 else points
    pts = quat_rotate(quat[:, None, :], pts) + pos[:, None, :]
    m = mask[None, :, None] if mask.dim() == 1 else mask[..., None]
    typ = torch.full(pts.shape[:-1] + (1,), float(point_type), dtype=pts.dtype,
                     device=pts.device) * m
    return torch.cat([pts * m, typ], dim=-1)


def merge_clouds(*clouds):
    """Concatenate [B, P_i, 4] clouds along the point axis."""
    return torch.cat(clouds, dim=1)


def to_relative_frame(cloud, frame_quat, frame_pos):
    """The cloud's xyz in a frame (quat [B, 4], pos [B, 3]); the type
    channel is kept and padding rows stay zero."""
    xyz = quat_rotate_inv(frame_quat[:, None, :], cloud[..., :3] - frame_pos[:, None, :])
    valid = cloud[..., 3:] > 0
    return torch.cat([torch.where(valid, xyz, torch.zeros_like(xyz)), cloud[..., 3:]], dim=-1)


def padded_points(num_points: int, out_points: int) -> int:
    """The point count `subsample_pad` scores: the cloud's, padded up to
    `out_points`."""
    return max(num_points, out_points)


def subsample_pad(cloud, scores, out_points: int):
    """Random subsample (and pad) of [B, P, 4] to [B, out_points, 4]. The
    cloud is first zero-padded to `out_points`; `scores` [B, max(P,
    out_points)] are uniform in [0, 1): valid points are ranked first in
    their order, the rows taken from padding stay zero."""
    B, P, D = cloud.shape
    if P < out_points:
        cloud = torch.cat([cloud, cloud.new_zeros(B, out_points - P, D)], dim=1)
    valid = cloud[..., 3] > 0
    order = torch.argsort(scores + (~valid).to(scores.dtype) * 10.0, dim=-1,
                          stable=True)[:, :out_points]
    picked = torch.gather(cloud, 1, order[..., None].expand(-1, -1, D))
    picked_valid = torch.gather(valid, 1, order)
    return picked * picked_valid[..., None]


def flatten_cloud(cloud):
    """[B, P, 4] -> [B, P * 4]."""
    return cloud.reshape(cloud.shape[0], -1)


def interval_sample(value, progress, interval: int, fill: float = 0.0):
    """The value on steps whose episode progress is a multiple of
    `interval`, `fill` on the others (intermittent sensing)."""
    keep = (progress % interval) == 0
    keep = keep.reshape(keep.shape + (1,) * (value.dim() - 1))
    return torch.where(keep, value, torch.full_like(value, fill))
