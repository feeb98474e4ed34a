"""Procedural heightfield terrain (counterpart of handarm_tpu/physics/terrain.py;
reference IsaacGymEnvs tasks/anymal_terrain.py `Terrain` and
isaacgym.terrain_utils' generators), in numpy: the JAX package's code with
the same draws from `default_rng(seed)` in the same order, so both packages
build the same heightfield and spawn origins, bit for bit. The engine's
contacts sample the field bilinearly (`physics.contacts.StaticGeom`'s
`hf_height`).

Layout: `num_levels` rows of increasing difficulty x `num_types` columns of
terrain kinds ([smooth slope, rough slope, stairs up, stairs down, discrete
obstacles, stepping stones] by proportion), each patch `length` x `width`
metres, surrounded by a flat border. Each env walks from the centre of its
(level, type) patch; the curriculum moves envs between rows.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Heightfield(NamedTuple):
    """Static terrain description (numpy; the height goes to the device in
    StaticGeom.hf_height)."""

    height: np.ndarray  # [R, C] meters
    cell: float  # horizontal meters per pixel
    origin: np.ndarray  # [2] world xy of pixel (0, 0)
    env_origins: np.ndarray  # [levels, types, 3] spawn centers (z = local top)
    num_levels: int
    num_types: int
    patch_length: float  # meters (x extent per patch)


# --- sub-terrain generators (terrain_utils analogs, in meters) -------------


def _pyramid_slope(h: np.ndarray, cell: float, slope: float,
                   platform: float = 3.0) -> None:
    n, m = h.shape
    cx, cy = (n - 1) / 2, (m - 1) / 2
    x = np.abs(np.arange(n) - cx)[:, None] * cell
    y = np.abs(np.arange(m) - cy)[None, :] * cell
    d = np.maximum(x, y)
    d = np.maximum(d - platform / 2, 0.0)
    # center platform flat at 0; surface slopes down (slope > 0) or up
    # (slope < 0) outward — the env spawns on the platform either way
    h += -slope * d


def _random_uniform(h: np.ndarray, cell: float, min_h: float, max_h: float,
                    step: float, down_scale: float, rng) -> None:
    n, m = h.shape
    # sample on a coarse grid, nearest-upsample (terrain_utils downsampled_scale)
    nn = max(2, int(n * cell / down_scale))
    mm = max(2, int(m * cell / down_scale))
    levels = np.arange(min_h, max_h + 1e-9, step)
    coarse = rng.choice(levels, size=(nn, mm))
    ii = np.minimum((np.arange(n) * nn // n), nn - 1)
    jj = np.minimum((np.arange(m) * mm // m), mm - 1)
    h += coarse[np.ix_(ii, jj)]


def _pyramid_stairs(h: np.ndarray, cell: float, step_width: float,
                    step_height: float, platform: float = 3.0) -> None:
    n, m = h.shape
    cx, cy = (n - 1) / 2, (m - 1) / 2
    x = np.abs(np.arange(n) - cx)[:, None] * cell
    y = np.abs(np.arange(m) - cy)[None, :] * cell
    d = np.maximum(np.maximum(x, y) - platform / 2, 0.0)
    steps = np.ceil(d / step_width)
    h += -step_height * steps  # staircase descending (or rising) outward


def _discrete_obstacles(h: np.ndarray, cell: float, max_height: float,
                        min_size: float, max_size: float, num: int,
                        platform: float, rng) -> None:
    n, m = h.shape
    for _ in range(num):
        w = int(rng.uniform(min_size, max_size) / cell)
        l = int(rng.uniform(min_size, max_size) / cell)
        i = rng.integers(0, max(n - w, 1))
        j = rng.integers(0, max(m - l, 1))
        h[i:i + w, j:j + l] = rng.choice([-max_height, -max_height / 2,
                                          max_height / 2, max_height])
    # flat central platform
    pi = int(platform / 2 / cell)
    ci, cj = n // 2, m // 2
    h[ci - pi:ci + pi, cj - pi:cj + pi] = 0.0


def _stepping_stones(h: np.ndarray, cell: float, stone_size: float,
                     stone_dist: float, depth: float, platform: float,
                     rng) -> None:
    n, m = h.shape
    h += -depth  # gaps are `depth` below the stones
    s = max(1, int(stone_size / cell))
    d = max(1, int(stone_dist / cell))
    for i0 in range(0, n, s + d):
        off = int(rng.integers(0, s + d))
        for j0 in range(-off, m, s + d):
            h[i0:i0 + s, max(j0, 0):j0 + s] = 0.0
    pi = int(platform / 2 / cell)
    ci, cj = n // 2, m // 2
    h[ci - pi:ci + pi, cj - pi:cj + pi] = 0.0


def generate_terrain(
    num_levels: int = 10,
    num_types: int = 20,
    length: float = 8.0,
    width: float = 8.0,
    cell: float = 0.1,
    border: float = 8.0,
    proportions=(0.1, 0.1, 0.35, 0.25, 0.2),
    seed: int = 0,
) -> Heightfield:
    """Curriculum terrain grid (anymal_terrain.py `curiculum`)."""
    rng = np.random.default_rng(seed)
    lp = int(length / cell)
    wp = int(width / cell)
    bp = int(border / cell)
    R = num_levels * lp + 2 * bp
    C = num_types * wp + 2 * bp
    H = np.zeros((R, C), np.float32)
    cum = np.cumsum(proportions)
    env_origins = np.zeros((num_levels, num_types, 3), np.float32)
    for j in range(num_types):
        for i in range(num_levels):
            patch = np.zeros((lp, wp), np.float32)
            difficulty = i / num_levels
            choice = (j + 0.5) / num_types
            slope = difficulty * 0.4
            step_h = 0.05 + 0.175 * difficulty
            disc_h = 0.025 + difficulty * 0.15
            stone_sz = 2.0 - 1.8 * difficulty
            if choice < cum[0]:
                _pyramid_slope(patch, cell,
                               -slope if choice < 0.05 else slope)
            elif choice < cum[1]:
                _pyramid_slope(patch, cell,
                               -slope if choice < 0.15 else slope)
                _random_uniform(patch, cell, -0.1, 0.1, 0.025, 0.2, rng)
            elif choice < cum[3]:
                sh = -step_h if choice < cum[2] else step_h
                _pyramid_stairs(patch, cell, 0.31, sh)
            elif choice < cum[4]:
                _discrete_obstacles(patch, cell, disc_h, 1.0, 2.0, 40, 3.0,
                                    rng)
            else:
                _stepping_stones(patch, cell, stone_sz, 0.1,
                                 0.0 if difficulty == 0 else 0.15, 3.0, rng)
            r0, c0 = bp + i * lp, bp + j * wp
            H[r0:r0 + lp, c0:c0 + wp] = patch
            # spawn at the patch center, on top of the local surface
            x1, x2 = lp // 2 - int(1 / cell), lp // 2 + int(1 / cell)
            z = float(patch[x1:x2, wp // 2 - int(1 / cell):
                            wp // 2 + int(1 / cell)].max())
            env_origins[i, j] = [(bp + (i + 0.5) * lp) * cell,
                                 (bp + (j + 0.5) * wp) * cell, z]
    return Heightfield(
        height=H, cell=cell, origin=np.zeros(2, np.float32),
        env_origins=env_origins, num_levels=num_levels, num_types=num_types,
        patch_length=length,
    )
