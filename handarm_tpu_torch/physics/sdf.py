"""Voxel SDF fields: host-side gradient baking and the plain trilinear
samplers (counterpart of handarm_tpu/physics/sdf.py `bake_grad_grid`,
`sample_sdf` and `sample_sdf_channels`, plus the out-of-grid excess of
handarm_tpu/physics/shapes.py `object_sdf`).

`sample_sdf` is the single-channel sample IndustReal's rewards read (the
JAX package computes it in jnp, outside any kernel). `sample_sdf_plain` is
the plain version of the `sdf_gather` kernel
(ops/sdf_gather.py): one f32 8-corner gather from a [R, R, R, C] field
(axes x, y, z, channel) at coordinates clamped to [0, R - 1.001], with the
euclidean out-of-grid excess, times the spacing, added to channel 0.
"""

from __future__ import annotations

import numpy as np
import torch


def bake_grad_grid(grid: np.ndarray, spacing: float) -> np.ndarray:
    """Unit gradient field [R, R, R, 3] of a baked SDF (central differences,
    one-sided at the faces), computed once on the host."""
    g = np.stack(np.gradient(grid, spacing), axis=-1)
    n = np.linalg.norm(g, axis=-1, keepdims=True)
    return (g / np.maximum(n, 1e-9)).astype(np.float32)


def grid_coords(p: torch.Tensor, lo: torch.Tensor, spacing) -> torch.Tensor:
    """Body-frame points [..., 3] -> grid coordinates (may lie off the grid)."""
    return (p - lo) / spacing


def out_of_grid_excess(u_raw: torch.Tensor, R: int) -> torch.Tensor:
    """Euclidean distance, in voxels, from grid coordinates to the grid box."""
    half = (R - 1) / 2.0
    return torch.linalg.vector_norm(torch.clamp((u_raw - half).abs() - half, min=0.0), dim=-1)


def sample_sdf_channels(field: torch.Tensor, lo: torch.Tensor, spacing,
                        p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of field [R, R, R, C] at body-frame points p [..., 3]
    -> [..., C], coordinates clamped to the grid."""
    R = field.shape[0]
    u = torch.clamp(grid_coords(p, lo, spacing), 0.0, R - 1.001)
    i0f = torch.floor(u)
    frac = u - i0f
    i0 = i0f.long()
    i1 = torch.clamp(i0 + 1, max=R - 1)
    x0, y0, z0 = i0.unbind(-1)
    x1, y1, z1 = i1.unbind(-1)
    fx, fy, fz = frac[..., 0:1], frac[..., 1:2], frac[..., 2:3]
    c00 = field[x0, y0, z0] * (1 - fz) + field[x0, y0, z1] * fz
    c01 = field[x0, y1, z0] * (1 - fz) + field[x0, y1, z1] * fz
    c10 = field[x1, y0, z0] * (1 - fz) + field[x1, y0, z1] * fz
    c11 = field[x1, y1, z0] * (1 - fz) + field[x1, y1, z1] * fz
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    return c0 * (1 - fx) + c1 * fx


def sample_sdf_plain(field: torch.Tensor, lo: torch.Tensor, spacing,
                     p: torch.Tensor) -> torch.Tensor:
    """[..., C]: the trilinear sample with the out-of-grid excess (meters)
    added to channel 0. Gradient channels stay unnormalized."""
    out = sample_sdf_channels(field, lo, spacing, p)
    excess = out_of_grid_excess(grid_coords(p, lo, spacing), field.shape[0])
    return torch.cat([out[..., :1] + (excess * spacing)[..., None], out[..., 1:]], dim=-1)


def sample_sdf(grid: torch.Tensor, lo: torch.Tensor, spacing, p: torch.Tensor) -> torch.Tensor:
    """Trilinear sample of a distance grid [R, R, R] at body-frame points p
    [..., 3] -> [...], coordinates clamped to the grid, plus the out-of-grid
    excess (meters), so that far points still read a growing distance."""
    return sample_sdf_plain(grid[..., None], lo, spacing, p)[..., 0]
