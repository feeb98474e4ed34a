"""Point-rasterized camera sensors: depth, segmentation, color and
occlusion-filtered point clouds (counterpart of handarm_tpu/envs/camera.py).

The scene's known surface points (the robot's cloud and each object's
samples) are projected into the camera and z-buffered per pixel with a
scatter-min; a point is visible where it wins its pixel. Segmentation and
color take the max over a pixel's visible points (color packs its three
8-bit channels into one int, so tied points never mix channels).

Ids: 1 robot, 3 + k object k. A pixel no point reaches holds int32 min in
the segmentation (the JAX package's segment_max identity), max_depth in
the depth and 0 in the color; a pixel reached only by masked, occluded or
off-image points (these land on the clipped border pixel) holds 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from handarm_tpu_torch.envs import pointcloud as pc
from handarm_tpu_torch.math.quat import quat_rotate, quat_rotate_inv

INT32_MIN = -(2 ** 31)


@dataclass(frozen=True)
class CameraConfig:
    """Pose and intrinsics. quat (wxyz) maps the camera frame to the world;
    the camera looks along its +x axis with +z up (u = -y, v = -z).
    Default: the topview, straight down at the workspace centre."""

    name: str = "topview"
    pos: tuple = (0.28, 0.58, 1.3)
    quat: tuple = (-0.5, 0.5, -0.5, -0.5)  # +x -> straight down
    fovx_deg: float = 87.0
    width: int = 160
    height: int = 90
    max_depth: float = 3.0


class CameraRender(NamedTuple):
    depth: torch.Tensor  # [B, H, W] (max_depth where empty)
    segmentation: torch.Tensor  # [B, H, W] int32
    points_uvz: torch.Tensor  # [B, P, 3] pixel coordinates and depth per point
    visible: torch.Tensor  # [B, P] 1.0 where the point won its pixel
    color: torch.Tensor | None = None  # [B, H, W, 3] float in [0, 1]


def _intrinsics(cfg: CameraConfig):
    fx = cfg.width / (2.0 * np.tan(np.radians(cfg.fovx_deg) / 2.0))
    return fx, fx, cfg.width / 2.0, cfg.height / 2.0  # square pixels


def _scatter(fill, pix: torch.Tensor, src: torch.Tensor, npix: int, reduce: str):
    """[B, npix] buffer of `fill` reduced with src [B, P] at pix [B, P]."""
    buf = torch.full((src.shape[0], npix), fill, dtype=src.dtype, device=src.device)
    return buf.scatter_reduce_(1, pix, src, reduce=reduce, include_self=True)


def render_points(cfg: CameraConfig, points_world: torch.Tensor, seg_ids: torch.Tensor,
                  valid: torch.Tensor | None = None,
                  colors: torch.Tensor | None = None) -> CameraRender:
    """Project and z-buffer points_world [B, P, 3] with seg_ids ([P] or
    [B, P] int), the mask `valid` [B, P] (> 0 counts) and RGB `colors` in
    [0, 1] ([P, 3] or [B, P, 3]); image u right, v down."""
    B, P, _ = points_world.shape
    f32 = dict(dtype=points_world.dtype, device=points_world.device)
    cam_pos, cam_quat = torch.tensor(cfg.pos, **f32), torch.tensor(cfg.quat, **f32)
    rel = quat_rotate_inv(cam_quat.expand(B, P, 4), points_world - cam_pos)
    depth = rel[..., 0]
    fx, fy, cx, cy = _intrinsics(cfg)
    safe_depth = torch.clamp(depth, min=1e-4)
    u = (-rel[..., 1] / safe_depth) * fx + cx
    v = (-rel[..., 2] / safe_depth) * fy + cy
    ok = (depth > 1e-3) & (u >= 0) & (u < cfg.width) & (v >= 0) & (v < cfg.height)
    if valid is not None:
        ok = ok & (valid > 0)
    ui = torch.clamp(u.to(torch.int32), 0, cfg.width - 1)  # truncates toward zero
    vi = torch.clamp(v.to(torch.int32), 0, cfg.height - 1)
    pix = (vi * cfg.width + ui).to(torch.int64)
    npix = cfg.width * cfg.height
    big = cfg.max_depth
    d = torch.where(ok, depth, torch.full_like(depth, big))
    zbuf = _scatter(big, pix, d, npix, "amin")
    # a point is visible where it matches its pixel's z-buffer (ties share it)
    vis = (torch.abs(d - torch.gather(zbuf, 1, pix)) < 1e-5) & (d < big)
    seg = seg_ids.to(torch.int32).expand(B, P)
    seg_img = _scatter(INT32_MIN, pix, torch.where(vis, seg, torch.zeros_like(seg)), npix,
                       "amax")
    color_img = None
    if colors is not None:
        q = torch.clamp(colors.to(points_world.dtype) * 255.0, 0, 255).to(torch.int32)
        packed = ((q[..., 0] << 16) | (q[..., 1] << 8) | q[..., 2]).expand(B, P)
        col = _scatter(INT32_MIN, pix, torch.where(vis, packed, torch.full_like(packed, -1)),
                       npix, "amax")
        col = torch.clamp(col, min=0)  # no visible point: black
        rgb = torch.stack([col >> 16, (col >> 8) & 255, col & 255], dim=-1)
        # times the float32 reciprocal, as XLA computes the JAX package's
        # division by 255 under jit (a true division rounds an ulp apart)
        color_img = (rgb.to(torch.float32) * (1.0 / 255.0)).reshape(B, cfg.height, cfg.width, 3)
    return CameraRender(
        depth=zbuf.reshape(B, cfg.height, cfg.width),
        segmentation=seg_img.reshape(B, cfg.height, cfg.width),
        points_uvz=torch.stack([u, v, depth], dim=-1),
        visible=vis.to(points_world.dtype),
        color=color_img,
    )


def depth_to_points(cfg: CameraConfig, depth: torch.Tensor, stride: int = 1):
    """A depth image [B, H, W] back to world points: ([B, h * w, 3], the
    mask of pixels nearer than max_depth), every `stride`-th pixel."""
    B = depth.shape[0]
    fx, fy, cx, cy = _intrinsics(cfg)
    vs = torch.arange(0, cfg.height, stride, device=depth.device)
    us = torch.arange(0, cfg.width, stride, device=depth.device)
    vv, uu = torch.meshgrid(vs, us, indexing="ij")
    d = depth[:, vv, uu]  # [B, h, w]
    y = -(uu[None].to(depth.dtype) - cx) / fx * d
    z = -(vv[None].to(depth.dtype) - cy) / fy * d
    cam = torch.stack([d, y, z], dim=-1).reshape(B, -1, 3)
    cam_pos = torch.tensor(cfg.pos, dtype=depth.dtype, device=depth.device)
    cam_quat = torch.tensor(cfg.quat, dtype=depth.dtype, device=depth.device)
    world = quat_rotate(cam_quat.expand(B, cam.shape[1], 4), cam) + cam_pos
    return world, (d < cfg.max_depth - 1e-3).reshape(B, -1)


def visible_pointcloud(render: CameraRender, points_world: torch.Tensor,
                       point_types: torch.Tensor, scores: torch.Tensor, out_points: int):
    """The occlusion-filtered cloud [B, out_points, 4]: the points that won
    their pixel, with their types, subsampled or padded by `scores` [B,
    pc.padded_points(P, out_points)] (`pointcloud.subsample_pad`)."""
    vis = render.visible
    cloud = torch.cat([points_world, (point_types * vis)[..., None]], dim=-1)
    return pc.subsample_pad(cloud * vis[..., None], scores, out_points)
